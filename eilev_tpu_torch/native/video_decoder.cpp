// Native video decode stage (libavformat/libavcodec/swscale): the port's own
// copy of eilev_tpu/native/video_decoder.cpp.
//
// Role: the C++ equivalent of the reference's pytorchvideo/PyAV decode path
// (reference eilev/data/ego4d.py:79-106 uses pytorchvideo's
// LabeledVideoDataset -> PyAV -> ffmpeg). This framework decodes clips with its
// own libav pipeline: seek to the clip window, decode, uniformly sample N
// frames, color-convert (and optionally resize) with swscale into a caller-
// provided RGB24 buffer that numpy wraps zero-copy. All entry points release
// the GIL (pure C ABI via ctypes), so a Python thread pool gets real decode
// parallelism to overlap with device compute.
//
// Build: g++ -O2 -shared -fPIC video_decoder.cpp -lavformat -lavcodec -lavutil
//        -lswscale, into build/eilev_tpu_torch/ (eilev_tpu_torch/ops/_build.py,
//        build_host).

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libswscale/swscale.h>
}

#include <algorithm>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Decoder {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* codec = nullptr;
  int stream_index = -1;
  AVRational time_base{};
  double duration_sec = 0.0;
  double fps = 0.0;
  std::string error;
};

void set_error(Decoder* d, const std::string& msg, int err = 0) {
  char buf[256] = {0};
  if (err != 0) av_strerror(err, buf, sizeof(buf));
  d->error = msg + (err != 0 ? std::string(": ") + buf : std::string());
}

}  // namespace

extern "C" {

// Opens a video file and prepares the best video stream for decoding.
void* vd_open(const char* path) {
  auto* d = new Decoder();
  int err = avformat_open_input(&d->fmt, path, nullptr, nullptr);
  if (err < 0) {
    set_error(d, "open failed", err);
    return d;
  }
  err = avformat_find_stream_info(d->fmt, nullptr);
  if (err < 0) {
    set_error(d, "stream info failed", err);
    return d;
  }
  const AVCodec* codec = nullptr;
  d->stream_index = av_find_best_stream(d->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &codec, 0);
  if (d->stream_index < 0 || codec == nullptr) {
    set_error(d, "no video stream");
    return d;
  }
  AVStream* stream = d->fmt->streams[d->stream_index];
  d->codec = avcodec_alloc_context3(codec);
  avcodec_parameters_to_context(d->codec, stream->codecpar);
  d->codec->thread_count = 0;  // auto
  err = avcodec_open2(d->codec, codec, nullptr);
  if (err < 0) {
    set_error(d, "codec open failed", err);
    return d;
  }
  d->time_base = stream->time_base;
  if (stream->duration > 0) {
    d->duration_sec = stream->duration * av_q2d(stream->time_base);
  } else if (d->fmt->duration > 0) {
    d->duration_sec = d->fmt->duration / (double)AV_TIME_BASE;
  }
  AVRational fr = stream->avg_frame_rate;
  d->fps = fr.den > 0 ? av_q2d(fr) : 0.0;
  return d;
}

const char* vd_error(void* handle) {
  auto* d = static_cast<Decoder*>(handle);
  return d->error.c_str();
}

double vd_duration(void* handle) { return static_cast<Decoder*>(handle)->duration_sec; }

double vd_fps(void* handle) { return static_cast<Decoder*>(handle)->fps; }

int vd_width(void* handle) {
  auto* d = static_cast<Decoder*>(handle);
  return d->codec ? d->codec->width : 0;
}

int vd_height(void* handle) {
  auto* d = static_cast<Decoder*>(handle);
  return d->codec ? d->codec->height : 0;
}

void vd_close(void* handle) {
  auto* d = static_cast<Decoder*>(handle);
  if (d->codec) avcodec_free_context(&d->codec);
  if (d->fmt) avformat_close_input(&d->fmt);
  delete d;
}

// Decodes [start_sec, end_sec), uniformly samples num_frames, writes RGB24
// (num_frames, out_h, out_w, 3) into `out`. out_h/out_w of 0 keep native size.
// Returns 0 on success, negative on error (message via vd_error).
int vd_decode_clip(void* handle, double start_sec, double end_sec, int num_frames,
                   int out_h, int out_w, unsigned char* out) {
  auto* d = static_cast<Decoder*>(handle);
  if (!d->codec) {
    set_error(d, "decoder not open");
    return -1;
  }
  if (out_h <= 0) out_h = d->codec->height;
  if (out_w <= 0) out_w = d->codec->width;

  int64_t seek_ts = (int64_t)(start_sec / av_q2d(d->time_base));
  int err = av_seek_frame(d->fmt, d->stream_index, seek_ts, AVSEEK_FLAG_BACKWARD);
  if (err < 0) {
    set_error(d, "seek failed", err);
    return -2;
  }
  avcodec_flush_buffers(d->codec);

  // Collect decoded frames that land inside the window. Uniform sampling over
  // the window: target timestamps start + (i + 0.5) * span / num_frames; for
  // each target we keep the latest frame whose pts <= target (nearest-past),
  // matching pytorchvideo's pts-based frame selection closely.
  std::vector<double> targets(num_frames);
  double span = std::max(end_sec - start_sec, 1e-6);
  for (int i = 0; i < num_frames; ++i)
    targets[i] = start_sec + span * (i + 0.5) / num_frames;

  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  AVFrame* rgb = av_frame_alloc();
  rgb->format = AV_PIX_FMT_RGB24;
  rgb->width = out_w;
  rgb->height = out_h;
  av_frame_get_buffer(rgb, 32);

  SwsContext* sws = nullptr;
  std::vector<bool> filled(num_frames, false);
  std::vector<double> filled_pts(num_frames, -1e18);
  int frame_bytes = out_h * out_w * 3;
  bool done = false;
  int ret = 0;

  auto process_frame = [&](AVFrame* f) {
    double pts_sec = (f->best_effort_timestamp == AV_NOPTS_VALUE
                          ? f->pts
                          : f->best_effort_timestamp) *
                     av_q2d(d->time_base);
    if (pts_sec > end_sec + 1.0) {
      done = true;
      return;
    }
    for (int i = 0; i < num_frames; ++i) {
      // nearest-past frame per target (allow slightly-future as fallback when
      // nothing earlier exists)
      bool better = false;
      if (!filled[i]) {
        better = true;
      } else if (pts_sec <= targets[i] && pts_sec > filled_pts[i]) {
        better = true;
      } else if (filled_pts[i] > targets[i] && pts_sec < filled_pts[i]) {
        better = true;  // replace a future frame with a closer one
      }
      if (!better) continue;
      if (sws == nullptr) {
        sws = sws_getContext(f->width, f->height, (AVPixelFormat)f->format, out_w,
                             out_h, AV_PIX_FMT_RGB24, SWS_BILINEAR, nullptr,
                             nullptr, nullptr);
      }
      sws_scale(sws, f->data, f->linesize, 0, f->height, rgb->data, rgb->linesize);
      unsigned char* dst = out + (size_t)i * frame_bytes;
      for (int row = 0; row < out_h; ++row)
        std::memcpy(dst + (size_t)row * out_w * 3, rgb->data[0] + (size_t)row * rgb->linesize[0],
                    (size_t)out_w * 3);
      filled[i] = true;
      filled_pts[i] = pts_sec;
    }
  };

  while (!done && av_read_frame(d->fmt, pkt) >= 0) {
    if (pkt->stream_index == d->stream_index) {
      if (avcodec_send_packet(d->codec, pkt) >= 0) {
        while (avcodec_receive_frame(d->codec, frame) >= 0) process_frame(frame);
      }
    }
    av_packet_unref(pkt);
  }
  // drain
  avcodec_send_packet(d->codec, nullptr);
  while (avcodec_receive_frame(d->codec, frame) >= 0) process_frame(frame);

  for (int i = 0; i < num_frames; ++i) {
    if (!filled[i]) {
      // pad missing trailing frames with the nearest filled one (short clips)
      int src = -1;
      for (int j = i - 1; j >= 0; --j)
        if (filled[j]) { src = j; break; }
      if (src < 0)
        for (int j = i + 1; j < num_frames; ++j)
          if (filled[j]) { src = j; break; }
      if (src < 0) {
        set_error(d, "no frames decoded in window");
        ret = -3;
        break;
      }
      std::memcpy(out + (size_t)i * frame_bytes, out + (size_t)src * frame_bytes,
                  (size_t)frame_bytes);
      filled[i] = true;
    }
  }

  if (sws) sws_freeContext(sws);
  av_frame_free(&rgb);
  av_frame_free(&frame);
  av_packet_free(&pkt);
  return ret;
}

}  // extern "C"

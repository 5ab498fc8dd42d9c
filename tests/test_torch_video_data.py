"""Port vs JAX: the video-reading layer (``eilev_tpu_torch/native``,
``data/clip_sampler.py``, ``data/video_datasets.py``).

The port's decoder builds its own copy of ``video_decoder.cpp`` with g++
into ``build/eilev_tpu_torch/`` (nothing beside the sources) and passes the
y4m tests of ``tests/data/test_native_decoder.py``; both packages' decoders
give the same uint8 frames for the same clips. The clip sampler and the
EPIC-KITCHENS / Ego4D datasets give the JAX package's items (paths,
timestamps, clip order with a seeded rng, frames). The decoder tests skip
only where ``decoder_available()`` is false (no g++ or libav headers), as
the JAX test does.
"""

import csv
import json
import os
import random
from concurrent.futures import ThreadPoolExecutor
from fractions import Fraction

import numpy as np
import pytest

from eilev_tpu.data import clip_sampler as jclip
from eilev_tpu.data import video_datasets as jvd
from eilev_tpu.native import VideoDecoder as JVideoDecoder
from eilev_tpu_torch.data import clip_sampler as tclip
from eilev_tpu_torch.data import video_datasets as tvd
from eilev_tpu_torch.native import VideoDecoder, decoder
from eilev_tpu_torch.native import decoder_available

from .data.test_native_decoder import FPS, H, NFRAMES, W, _write_y4m

needs_decoder = pytest.mark.skipif(not decoder_available(), reason="native decoder unavailable")


@pytest.fixture(scope="module")
def video_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("vid") / "test.y4m"
    _write_y4m(str(p))
    return str(p)


@needs_decoder
def test_builds_under_build_only():
    lib = decoder.library_path()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert lib.exists() and lib.parent == decoder.SOURCE.parents[2] / "build" / "eilev_tpu_torch"
    assert lib.parent.is_relative_to(repo)
    assert not list(decoder.SOURCE.parent.glob("*.so"))


@needs_decoder
def test_metadata(video_path):
    with VideoDecoder(video_path) as dec:
        assert dec.size == (H, W)
        assert abs(dec.fps - FPS) < 0.01
        assert abs(dec.duration - NFRAMES / FPS) < 0.2


@needs_decoder
def test_decode_clip_uniform_sampling(video_path):
    with VideoDecoder(video_path) as dec:
        # frames 10..29 of the 2 s window at 1 s; 4 uniform samples: {12, 17, 22, 27}
        clip = dec.decode_clip(1.0, 3.0, 4)
    assert clip.shape == (3, 4, H, W) and clip.dtype == np.uint8
    reds = clip[0, :, 0, 0].astype(np.float64)
    np.testing.assert_allclose(reds * 219.0 / (4 * 255.0), [12, 17, 22, 27], atol=1.2)
    assert (np.diff(reds) > 0).all()


@needs_decoder
def test_decode_with_resize_and_window_clamped_to_end(video_path):
    with VideoDecoder(video_path) as dec:
        assert dec.decode_clip(0.0, 1.0, 2, height=8, width=12).shape == (3, 2, 8, 12)
        clip = dec.decode_clip(4.0, 6.0, 4)  # the video ends at 5 s
    assert clip.shape == (3, 4, H, W) and clip[0, -1, 0, 0] >= clip[0, 0, 0, 0]


@needs_decoder
def test_open_missing_file_raises():
    with pytest.raises(RuntimeError):
        VideoDecoder("/nonexistent/video.mp4")


@needs_decoder
def test_parallel_decodes(video_path):
    def work(i):
        with VideoDecoder(video_path) as dec:
            return dec.decode_clip(0.5 * (i % 4), 0.5 * (i % 4) + 1.0, 4).sum()

    with ThreadPoolExecutor(8) as ex:
        assert all(s > 0 for s in ex.map(work, range(16)))


@needs_decoder
@pytest.mark.parametrize("window,n,size", [((1.0, 3.0), 4, (0, 0)), ((0.0, 5.0), 8, (8, 12)),
                                           ((4.0, 6.0), 4, (0, 0)), ((0.3, 0.9), 3, (16, 16))])
def test_frames_equal_the_jax_decoders(video_path, window, n, size):
    with VideoDecoder(video_path) as ours, JVideoDecoder(video_path) as ref:
        assert (ours.size, ours.fps, ours.duration) == (ref.size, ref.fps, ref.duration)
        a = ours.decode_clip(*window, n, height=size[0], width=size[1])
        b = ref.decode_clip(*window, n, height=size[0], width=size[1])
    assert a.dtype == b.dtype == np.uint8
    np.testing.assert_array_equal(a, b)


def test_clip_sampler_matches_jax():
    ann = {"narrated_actions": [{"narration_timestamp_sec": t} for t in (2.0, 50.0, 99.0, Fraction(31, 3))]}
    for shuffled in (False, True):
        ours = tclip.NarratedActionClipSampler(random=shuffled, rng=random.Random(9))
        ref = jclip.NarratedActionClipSampler(random=shuffled, rng=random.Random(9))
        for duration in (Fraction(100), Fraction(100), 60.5):
            for _ in range(len(ann["narrated_actions"])):
                a, b = ours(0.0, duration, ann), ref(0.0, duration, ann)
                assert vars(a) == vars(b)
    assert tclip.CLIP_DURATION_SEC == jclip.CLIP_DURATION_SEC == 8


def _same_items(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.keys() == b.keys()
        np.testing.assert_array_equal(a.pop("video"), b.pop("video"))
        assert a == b


@pytest.fixture(scope="module")
def ek_world(tmp_path_factory):
    """tests/data/test_epic_kitchens.py's world: an EK-55 video in train/, one
    only in test/, an EK-100 one, and a row without a narration timestamp."""
    root = tmp_path_factory.mktemp("ek")
    ek55, ek100 = root / "ek55", root / "ek100"
    for d, name in ((ek55 / "videos/train/P01", "P01_01"), (ek55 / "videos/test/P02", "P02_03"),
                    (ek100 / "P01/videos", "P01_101")):
        d.mkdir(parents=True)
        _write_y4m(str(d / f"{name}.MP4"), nframes=150, w=32, h=16, fps=10)
    ann = root / "ann.csv"
    with open(ann, "w", newline="") as f:
        w = csv.DictWriter(f, ["video_id", "narration", "narration_timestamp", "start_timestamp", "stop_timestamp"])
        w.writeheader()
        w.writerow(dict(video_id="P01_01", narration="open door", narration_timestamp="00:00:05.00",
                        start_timestamp="00:00:04.00", stop_timestamp="00:00:06.00"))
        w.writerow(dict(video_id="P02_03", narration="wash carrot", narration_timestamp="",
                        start_timestamp="00:00:02.00", stop_timestamp="00:00:10.00"))
        w.writerow(dict(video_id="P01_101", narration="cut onion", narration_timestamp="00:00:07.00",
                        start_timestamp="00:00:06.00", stop_timestamp="00:00:08.00"))
        w.writerow(dict(video_id="P01_101", narration="wash onion", narration_timestamp="00:00:12.50",
                        start_timestamp="00:00:12.00", stop_timestamp="00:00:13.00"))
    return str(ek55), str(ek100), str(ann)


@needs_decoder
@pytest.mark.parametrize("random_clip", [False, True])
def test_epic_kitchens_matches_jax(ek_world, random_clip):
    ek55, ek100, ann = ek_world
    kw = dict(num_frames=4, random_clip=random_clip)
    ours = tvd.EpicKitchensDataset(ann, ek55, ek100, rng=random.Random(0), **kw)
    ref = jvd.EpicKitchensDataset(ann, ek55, ek100, rng=random.Random(0), **kw)
    assert len(ours) == len(ref) == 4
    items = list(ours)
    assert {it["video_id"] for it in items} == {"P01_01", "P02_03", "P01_101"}
    assert all(it["video"].shape == (3, 4, 16, 32) for it in items)
    assert {it["video_id"]: it for it in items}["P02_03"]["narration_timestamp_sec"] == pytest.approx(6.0)
    _same_items(items, list(ref))


def test_epic_kitchens_missing_video_raises(ek_world, tmp_path):
    ek55, ek100, _ = ek_world
    ann = tmp_path / "bad.csv"
    with open(ann, "w", newline="") as f:
        w = csv.DictWriter(f, ["video_id", "narration", "narration_timestamp", "start_timestamp", "stop_timestamp"])
        w.writeheader()
        w.writerow(dict(video_id="P09_09", narration="x", narration_timestamp="00:00:01.00",
                        start_timestamp="00:00:00.00", stop_timestamp="00:00:02.00"))
    for cls in (tvd.EpicKitchensDataset, jvd.EpicKitchensDataset):
        with pytest.raises(FileNotFoundError):
            cls(str(ann), ek55, ek100, num_frames=2)


def _action(ts, text, verb, noun, rejected=False, valid=True):
    return {"narration_timestamp_sec": ts, "narration_text": text, "structured_verb": verb,
            "is_rejected": rejected, "is_valid_action": valid,
            "frames": [{"frame_type": "pnr_frame", "boxes": [
                {"object_type": "object_of_change", "structured_noun": noun}]}]}


@needs_decoder
def test_ego4d_fho_matches_jax(tmp_path):
    """Two videos of fho_main narrated actions (a rejected one, an invalid
    one and a non-camera-wearer one filtered out), one split: the same items
    with a transform, in order and shuffled."""
    vids = tmp_path / "videos"
    vids.mkdir()
    for uid in ("a", "b"):
        _write_y4m(str(vids / f"{uid}.mp4"), nframes=120, w=32, h=16, fps=10)
    annotations = {"videos": [
        {"video_uid": "a", "annotated_intervals": [{"narrated_actions": [
            _action(3.0, "#C C picks a knife", "pick", "knife"),
            _action(6.0, "#C C cuts an onion", "cut", "onion"),
            _action(7.0, "#C C drops it", "drop", None, rejected=True),
            _action(8.0, "#O a man waves", "wave", None)]}]},
        {"video_uid": "b", "annotated_intervals": [{"narrated_actions": [
            _action(5.0, "#C C opens a drawer", "open", "drawer"),
            _action(9.0, "#C C closes it", "close", "drawer", valid=False)]}]},
    ]}
    (tmp_path / "fho.json").write_text(json.dumps(annotations))
    (tmp_path / "split.json").write_text(json.dumps({"split": "val", "videos": ["a", "b"]}))

    def transform(item):
        return dict(item, video=item["video"][:, ::2])

    for random_clip in (False, True):
        kw = dict(num_frames=4, random_clip=random_clip, transform=transform, decode_height=8, decode_width=16)
        args = (str(tmp_path / "fho.json"), str(tmp_path / "split.json"), str(vids))
        ours = tvd.Ego4dFHOMainDataset(*args, rng=random.Random(3), **kw)
        ref = jvd.Ego4dFHOMainDataset(*args, rng=random.Random(3), **kw)
        assert len(ours) == len(ref) == 3 and ours.split == "val"
        items = list(ours)
        assert all(it["video"].shape == (3, 2, 8, 16) for it in items)
        _same_items(items, list(ref))

"""Video preprocessing (counterpart of ``eilev_tpu/ops/preprocess.py``).

(..., C, T, H, W) videos on the device of the input:

- eval path: uniform temporal subsample -> bicubic antialiased resize ->
  rescale 1/255 -> CLIP-mean/std normalize (:func:`process_videos`);
- train path: subsample -> RandAugment -> rescale -> normalize ->
  RandomResizedCrop (bicubic) -> horizontal flip (:func:`train_transform`),
  and pytorchvideo's short-side scale and random crop.

Each random op is split into a draw and a deterministic apply. The draws are
a few scalars a clip, taken host-side from a seeded CPU ``torch.Generator``
(so the apply needs no device read); the apply runs on the video's device.
A test can feed the JAX function's own draws to an apply. The applies follow
the JAX code, not torchvision's: the crop-and-resize is
``jax.image.scale_and_translate``'s Keys cubic (a = -0.5, antialiased when it
downscales), the affine ops ``map_coordinates``' bilinear with zero fill,
equalize and posterize the JAX formulas.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def uniform_temporal_subsample(video: torch.Tensor, num_samples: int) -> torch.Tensor:
    """pytorchvideo semantics: linspace(0, T-1, num).long() along the T axis of
    (..., C, T, H, W)."""
    t = video.shape[-3]
    idx = torch.linspace(0.0, t - 1, num_samples).long().to(video.device)
    return torch.index_select(video, -3, idx)


@functools.lru_cache(maxsize=64)
def _resize_matrix(in_size: int, out_size: int, antialias: bool) -> np.ndarray:
    """(out, in) separable Keys-cubic (a=-0.5) resampling weights, antialiased
    when downscaling - the same filter family as torchvision/PIL bicubic."""
    scale = out_size / in_size
    kernel_scale = min(scale, 1.0) if antialias else 1.0

    def cubic(x):
        x = np.abs(x)
        a = -0.5
        return np.where(
            x <= 1,
            (a + 2) * x**3 - (a + 3) * x**2 + 1,
            np.where(x < 2, a * x**3 - 5 * a * x**2 + 8 * a * x - 4 * a, 0.0),
        )

    out_pos = (np.arange(out_size) + 0.5) / scale - 0.5  # source coords
    in_pos = np.arange(in_size)
    w = cubic((out_pos[:, None] - in_pos[None, :]) * kernel_scale)
    w = w / w.sum(axis=1, keepdims=True)
    return w.astype(np.float32)


def resize_video(
    video: torch.Tensor, height: int, width: int, *, antialias: bool = True
) -> torch.Tensor:
    """Bicubic resize of the trailing (H, W) dims as two separable matmuls with
    precomputed cubic weights. Returns float32."""
    *_, h, w = video.shape
    x = video.float()
    if (h, w) == (height, width):
        return x
    wh = torch.from_numpy(_resize_matrix(h, height, antialias)).to(video.device)
    ww = torch.from_numpy(_resize_matrix(w, width, antialias)).to(video.device)
    x = torch.einsum("...hw,oh->...ow", x, wh)
    return torch.einsum("...hw,pw->...hp", x, ww)


def rescale(video: torch.Tensor) -> torch.Tensor:
    return video.float() / 255.0


def normalize(
    video: torch.Tensor,
    mean: Sequence[float] = CLIP_MEAN,
    std: Sequence[float] = CLIP_STD,
) -> torch.Tensor:
    """Channel-first normalize over (..., C, T, H, W)."""
    mean_t = torch.tensor(mean, dtype=video.dtype, device=video.device).reshape(-1, 1, 1, 1)
    std_t = torch.tensor(std, dtype=video.dtype, device=video.device).reshape(-1, 1, 1, 1)
    return (video - mean_t) / std_t


def process_videos(
    videos: torch.Tensor,
    num_frames: Optional[int] = None,
    height: int = 224,
    width: int = 224,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """(B, C, T, H, W) uint8 -> subsample -> resize -> rescale -> normalize ->
    (B, C, num_frames, height, width) in ``dtype``. The resize is skipped when
    the size already matches, as in the JAX function."""
    x = videos
    if num_frames is not None:
        x = uniform_temporal_subsample(x, num_frames)
    if tuple(x.shape[-2:]) != (height, width):
        x = resize_video(x, height, width)
    x = rescale(x)
    x = normalize(x)
    return x.to(dtype)


# ---------------------------------------------------------------------------
# training augmentations: each random op is a draw, host-side from a seeded
# CPU torch.Generator, and a deterministic apply on the video's device
# ---------------------------------------------------------------------------

_F32_EPS = float(np.finfo(np.float32).eps)
_MAX_MAGNITUDE = 10.0


def _f32(value) -> float:
    """``value`` rounded to float32, as the JAX functions compute their scalars."""
    return float(np.float32(value))


def _uniform(generator: torch.Generator, shape: tuple = (), low: float = 0.0,
             high: float = 1.0) -> torch.Tensor:
    """float32 uniforms in [low, high) on the CPU, as ``jax.random.uniform``
    maps its draws: ``max(low, u * (high - low) + low)``."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return torch.clamp_min(u * _f32(high - low) + _f32(low), _f32(low))


def horizontal_flip(video: torch.Tensor, flip: bool) -> torch.Tensor:
    return video.flip(-1) if flip else video


def random_horizontal_flip(generator: torch.Generator, video: torch.Tensor, p: float = 0.5) -> torch.Tensor:
    """Flip the W axis with probability ``p`` (``bernoulli(p)``: u < p)."""
    return horizontal_flip(video, bool(torch.rand((), generator=generator) < p))


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """``jax.image``'s Keys cubic (a = -0.5) on |distance| ``x``."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(1.0 - x.abs(), 0.0)


def _scale_translate_matrix(in_size: int, out_size: int, inv_scale: float, shift: float,
                            kernel, device) -> torch.Tensor:
    """(in, out) float32 resampling weights of ``jax.image.scale_and_translate``
    (``compute_weight_mat``, antialiased) for one axis: output pixel o samples
    input position ``(o + 0.5) * inv_scale - shift - 0.5``, where ``inv_scale
    = 1 / scale`` and ``shift = translation * inv_scale`` (float32); when
    downscaling the kernel is widened by ``inv_scale``; columns are
    normalised; a sample outside the input gets no weight (output 0)."""
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - shift - 0.5
    pos = torch.arange(in_size, dtype=torch.float32, device=device)
    w = kernel((sample[None, :] - pos[:, None]).abs() / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _F32_EPS,
                    w / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resample(video: torch.Tensor, wh: torch.Tensor, ww: torch.Tensor) -> torch.Tensor:
    """The trailing (H, W) of ``video`` through (H, H') and (W, W') weights."""
    x = torch.einsum("...hw,ho->...ow", video.float(), wh)
    return torch.einsum("...hw,wp->...hp", x, ww)


def draw_crop(generator: torch.Generator, scale: tuple[float, float] = (0.5, 1.0),
              ratio: tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0), n: int = 10) -> tuple:
    """The draws of :func:`random_resized_crop`: ``n`` candidate area fractions
    in ``scale``, ``n`` log aspect ratios in log ``ratio``, and two uniforms
    for the crop's top and left."""
    area = _uniform(generator, (n,), scale[0], scale[1])
    log_ratio = _uniform(generator, (n,), float(np.log(ratio[0])), float(np.log(ratio[1])))
    u_i, u_j = _uniform(generator), _uniform(generator)
    return area, log_ratio, u_i, u_j


def crop_box(h: int, w: int, draws: tuple,
             ratio: tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0)) -> tuple[float, float, float, float]:
    """(top, left, crop_h, crop_w) of the JAX ``random_resized_crop`` from its
    draws (:func:`draw_crop`): the first of the candidates whose
    ``int(sqrt(area * aspect))`` x ``int(sqrt(area / aspect))`` fits, else a
    center crop at the clamped aspect (torchvision's fallback); the offsets
    ``floor(u * (room + 1))``. float32 throughout, as JAX computes it."""
    area_frac, log_ratio, u_i, u_j = (torch.as_tensor(d, dtype=torch.float32) for d in draws)
    target_area = area_frac * float(h * w)
    aspect = torch.exp(log_ratio)
    cw = torch.sqrt(target_area * aspect).to(torch.int32)
    ch = torch.sqrt(target_area / aspect).to(torch.int32)
    ok = (cw > 0) & (cw <= w) & (ch > 0) & (ch <= h)
    if bool(ok.any()):
        first = int(torch.argmax(ok.to(torch.int32)))
        crop_w, crop_h = float(cw[first]), float(ch[first])
        top = float(torch.floor(u_i * _f32(h - crop_h + 1.0)))
        left = float(torch.floor(u_j * _f32(w - crop_w + 1.0)))
        return top, left, crop_h, crop_w
    in_ratio = w / h
    crop_w = float(round(h * ratio[1])) if in_ratio > ratio[1] else float(w)
    crop_h = float(round(w / ratio[0])) if in_ratio < ratio[0] else float(h)
    return _f32((h - crop_h) / 2.0), _f32((w - crop_w) / 2.0), crop_h, crop_w


def resized_crop(video: torch.Tensor, box: tuple[float, float, float, float],
                 height: int, width: int) -> torch.Tensor:
    """Crop ``box`` (top, left, crop_h, crop_w) and resize it to (height,
    width) in one resampling, ``jax.image.scale_and_translate(method="cubic")``:
    the Keys cubic with a = -0.5, antialiased when it downscales (not
    ``F.interpolate``'s bicubic, a = -0.75). Returns float32."""
    top, left, crop_h, crop_w = box
    *_, h, w = video.shape
    mats = []
    for size, out, offset, extent in ((h, height, top, crop_h), (w, width, left, crop_w)):
        scale = np.float32(out) / np.float32(extent)
        inv = np.float32(1.0) / scale
        shift = np.float32(-np.float32(offset) * scale) * inv
        mats.append(_scale_translate_matrix(size, out, float(inv), float(shift), _keys_cubic, video.device))
    return _resample(video, *mats)


def random_resized_crop(
    generator: torch.Generator,
    video: torch.Tensor,
    height: int,
    width: int,
    scale: tuple[float, float] = (0.5, 1.0),
    ratio: tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
) -> torch.Tensor:
    """torchvision RandomResizedCrop semantics, as the JAX function has them:
    an area in ``scale`` of the source and a log-uniform aspect in ``ratio``,
    ten candidates, the first feasible wins, a center crop otherwise; the crop
    and the bicubic resize are one resampling (:func:`resized_crop`)."""
    box = crop_box(video.shape[-2], video.shape[-1], draw_crop(generator, scale, ratio), ratio)
    return resized_crop(video, box, height, width)


def _blend(a: torch.Tensor, b: torch.Tensor, factor: float) -> torch.Tensor:
    return torch.clamp(b + factor * (a - b), 0.0, 255.0)


def _gray(video: torch.Tensor) -> torch.Tensor:
    """(C, T, H, W) -> (T, H, W) ITU-R 601-2 luma, like PIL convert("L")."""
    return 0.299 * video[0] + 0.587 * video[1] + 0.114 * video[2]


def _affine(video: torch.Tensor, matrix: tuple) -> torch.Tensor:
    """A 2x3 inverse affine ((m00, m01, m02), (m10, m11, m12)) on the (H, W)
    axes of (C, T, H, W) about the image center, bilinear with zero fill:
    ``jax.scipy.ndimage.map_coordinates(order=1, cval=0)``, whose four
    corners are summed in the order (y0, x0), (y0, x1), (y1, x0), (y1, x1)."""
    c, t, h, w = video.shape
    dev = video.device
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = torch.arange(h, dtype=torch.float32, device=dev) - cy
    xx = torch.arange(w, dtype=torch.float32, device=dev) - cx
    gy, gx = torch.meshgrid(yy, xx, indexing="ij")
    (m00, m01, m02), (m10, m11, m12) = matrix
    src_y = m00 * gy + m01 * gx + m02 + cy
    src_x = m10 * gy + m11 * gx + m12 + cx
    flat = video.reshape(c * t, h * w)
    nodes = []
    for coord in (src_y, src_x):
        lower = torch.floor(coord)
        upper_w = coord - lower
        idx = lower.to(torch.int64)
        nodes.append([(idx, 1.0 - upper_w), (idx + 1, upper_w)])
    out = None
    for (iy, wy), (ix, wx) in ((a, b) for a in nodes[0] for b in nodes[1]):
        valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
        index = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).reshape(-1)
        value = torch.where(valid.reshape(-1), flat[:, index], torch.zeros((), device=dev))
        term = (wy * wx).reshape(-1) * value
        out = term if out is None else out + term
    return out.reshape(c, t, h, w)


def _op_identity(v, m, sign):
    return v


def _op_auto_contrast(v, m, sign):
    lo = v.amin(dim=(-2, -1), keepdim=True)
    hi = v.amax(dim=(-2, -1), keepdim=True)
    scale_f = 255.0 / torch.clamp_min(hi - lo, 1e-5)
    return torch.where(hi > lo, (v - lo) * scale_f, v)


def _op_equalize(v, m, sign):
    """Per-frame, per-channel histogram equalization, as the JAX op computes
    it (PIL's step; the LUT is not floored)."""
    c, t, h, w = v.shape
    n = c * t
    img = v.reshape(n, h * w)
    b = torch.clamp(img, 0, 255).to(torch.int64)
    hist = torch.zeros(n, 256, dtype=torch.float32, device=v.device)
    hist.scatter_add_(1, b, torch.ones_like(img))
    last = 255 - torch.argmax((hist > 0).flip(-1).to(torch.int32), dim=-1, keepdim=True)
    step = torch.div(float(h * w) - torch.gather(hist, 1, last), 255.0, rounding_mode="floor")
    cum = torch.cumsum(hist, dim=-1)
    lut = torch.clamp(((cum - hist / 2.0) + step / 2.0) / torch.clamp_min(step, 1.0), 0.0, 255.0)
    out = torch.gather(lut, 1, b)
    return torch.where(step <= 0, img, out).reshape(v.shape)


def _op_solarize(v, m, sign):
    threshold = _f32(255.0 - _f32(_f32(m / _MAX_MAGNITUDE) * 255.0))
    return torch.where(v >= threshold, 255.0 - v, v)


def _op_posterize(v, m, sign):
    # bits = 8 - int(m / 10 * 4), shift = 8 - bits
    shift = int(np.float32(np.float32(m) / np.float32(_MAX_MAGNITUDE)) * np.float32(4.0))
    iv = torch.clamp(v, 0, 255).to(torch.int32)
    return ((iv >> shift) << shift).to(v.dtype)


def _signed(m: float, sign: float) -> float:
    return _f32(np.float32(sign) * np.float32(m) / np.float32(_MAX_MAGNITUDE))


def _factor(m: float, sign: float) -> float:
    """1 + signed magnitude * 0.9, the enhance ops' blend factor (float32)."""
    return _f32(np.float32(1.0) + np.float32(_signed(m, sign)) * np.float32(0.9))


def _op_color(v, m, sign):
    return _blend(v, _gray(v)[None].expand_as(v), _factor(m, sign))


def _op_contrast(v, m, sign):
    mean = _gray(v).mean(dim=(-2, -1), keepdim=True)[None]
    return _blend(v, mean.expand_as(v), _factor(m, sign))


def _op_brightness(v, m, sign):
    return _blend(v, torch.zeros_like(v), _factor(m, sign))


def _op_sharpness(v, m, sign):
    c, t, h, w = v.shape
    kernel = torch.tensor([[1.0, 1.0, 1.0], [1.0, 5.0, 1.0], [1.0, 1.0, 1.0]], device=v.device) / 13.0
    sm = torch.nn.functional.conv2d(v.reshape(c * t, 1, h, w), kernel[None, None], padding=1).reshape(v.shape)
    # PIL only smooths the interior
    interior = torch.zeros(h, w, dtype=torch.bool, device=v.device)
    interior[1:-1, 1:-1] = True
    sm = torch.where(interior, sm, v)
    return _blend(sm, v, _f32(np.float32(1.0) - np.float32(_factor(m, sign))))


def _op_rotate(v, m, sign):
    rad = np.float32(np.float32(_signed(m, sign)) * np.float32(30.0)) * np.float32(np.pi / 180)
    cos, sin = float(np.cos(rad)), float(np.sin(rad))
    return _affine(v, ((cos, sin, 0.0), (-sin, cos, 0.0)))


def _op_shear_x(v, m, sign):
    s = _f32(np.float32(_signed(m, sign)) * np.float32(0.3))
    return _affine(v, ((1.0, 0.0, 0.0), (s, 1.0, 0.0)))


def _op_shear_y(v, m, sign):
    s = _f32(np.float32(_signed(m, sign)) * np.float32(0.3))
    return _affine(v, ((1.0, s, 0.0), (0.0, 1.0, 0.0)))


def _op_translate_x(v, m, sign):
    t = _f32(np.float32(np.float32(_signed(m, sign)) * np.float32(0.45)) * np.float32(v.shape[-1]))
    return _affine(v, ((1.0, 0.0, 0.0), (0.0, 1.0, -t)))


def _op_translate_y(v, m, sign):
    t = _f32(np.float32(np.float32(_signed(m, sign)) * np.float32(0.45)) * np.float32(v.shape[-2]))
    return _affine(v, ((1.0, 0.0, -t), (0.0, 1.0, 0.0)))


# the JAX module's op list, in its order: a draw's op index picks from it
_RAND_AUG_OPS = (
    _op_identity,
    _op_auto_contrast,
    _op_equalize,
    _op_solarize,
    _op_posterize,
    _op_color,
    _op_contrast,
    _op_brightness,
    _op_sharpness,
    _op_rotate,
    _op_shear_x,
    _op_shear_y,
    _op_translate_x,
    _op_translate_y,
)


def draw_rand_augment(generator: torch.Generator, num_layers: int = 2,
                      prob: float = 0.5) -> tuple[tuple[int, bool, float], ...]:
    """The draws of :func:`rand_augment`: per layer (op index, whether it
    applies (u < prob), the sign of the signed ops' magnitude (u < 0.5: +1))."""
    layers = []
    for _ in range(num_layers):
        op = int(torch.randint(len(_RAND_AUG_OPS), (), generator=generator))
        applies = bool(torch.rand((), generator=generator) < prob)
        sign = 1.0 if bool(torch.rand((), generator=generator) < 0.5) else -1.0
        layers.append((op, applies, sign))
    return tuple(layers)


def apply_rand_augment(video: torch.Tensor, layers: tuple, magnitude: float = 5.0) -> torch.Tensor:
    """RandAugment on a (C, T, H, W) video in [0, 255] with the drawn
    ``layers``: one op sequence for all frames (video-consistent). Returns
    float32."""
    v = video.float()
    for op, applies, sign in layers:
        if applies:
            v = _RAND_AUG_OPS[op](v, magnitude, sign)
    return v


def rand_augment(generator: torch.Generator, video: torch.Tensor, magnitude: float = 5.0,
                 num_layers: int = 2, prob: float = 0.5) -> torch.Tensor:
    """RandAugment (Cubuk et al.) with the JAX module's op set: ``num_layers``
    ops, each applied with probability ``prob``."""
    return apply_rand_augment(video, draw_rand_augment(generator, num_layers, prob), magnitude)


@dataclasses.dataclass(frozen=True)
class TrainDraws:
    """The draws of one clip's :func:`train_transform`."""

    augment: tuple  # draw_rand_augment
    crop: tuple  # draw_crop
    flip: bool


def draw_train_transform(generator: torch.Generator, num_layers: int = 2) -> TrainDraws:
    augment = draw_rand_augment(generator, num_layers)
    crop = draw_crop(generator)
    flip = bool(torch.rand((), generator=generator) < 0.5)
    return TrainDraws(augment, crop, flip)


def apply_train_transform(
    video: torch.Tensor,
    draws: TrainDraws,
    num_frames: int = 8,
    height: int = 224,
    width: int = 224,
    magnitude: float = 5.0,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """(C, T, H, W) uint8 -> subsample -> RandAugment -> rescale -> normalize
    -> RandomResizedCrop(0.5-1.0, bicubic) -> hflip, with ``draws``."""
    x = uniform_temporal_subsample(video, num_frames)
    x = apply_rand_augment(x, draws.augment, magnitude)
    x = normalize(rescale(x))
    x = resized_crop(x, crop_box(x.shape[-2], x.shape[-1], draws.crop), height, width)
    return horizontal_flip(x, draws.flip).to(dtype)


def train_transform(
    generator: torch.Generator,
    video: torch.Tensor,
    num_frames: int = 8,
    height: int = 224,
    width: int = 224,
    magnitude: float = 5.0,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The train_v2 augmentation stack (reference train_v2.py:143-167) on one
    clip, on its device: draws from ``generator`` (a CPU generator), then
    :func:`apply_train_transform`."""
    return apply_train_transform(video, draw_train_transform(generator), num_frames, height, width,
                                 magnitude, dtype)


def short_side_scale(video: torch.Tensor, size: int) -> torch.Tensor:
    """Resize so the short side is ``size`` (the long side ``floor(long /
    short * size)``), ``jax.image.resize(method="bilinear")``: a triangle
    kernel, antialiased when it downscales. Returns float32."""
    *_, h, w = video.shape
    if h < w:
        nh, nw = size, int(np.floor(w / h * size))
    else:
        nh, nw = int(np.floor(h / w * size)), size
    out = video.float()
    if nh != h:  # jax.image.resize leaves an unchanged axis alone
        out = torch.einsum("...hw,ho->...ow", out,
                           _scale_translate_matrix(h, nh, _f32(1.0 / (nh / h)), 0.0, _triangle, video.device))
    if nw != w:
        out = torch.einsum("...hw,wp->...hp", out,
                           _scale_translate_matrix(w, nw, _f32(1.0 / (nw / w)), 0.0, _triangle, video.device))
    return out


def random_short_side_scale(generator: torch.Generator, video: torch.Tensor, min_size: int,
                            max_size: int) -> torch.Tensor:
    """pytorchvideo RandomShortSideScale: the short side a uniform random int
    in [min_size, max_size] (bilinear)."""
    return short_side_scale(video, int(torch.randint(min_size, max_size + 1, (), generator=generator)))


def crop(video: torch.Tensor, top: int, left: int, height: int, width: int) -> torch.Tensor:
    """The (height, width) window at (top, left) of the trailing (H, W),
    its start clamped into the frame as ``lax.dynamic_slice`` clamps it."""
    h, w = video.shape[-2], video.shape[-1]
    top, left = min(max(top, 0), h - height), min(max(left, 0), w - width)
    return video[..., top : top + height, left : left + width]


def random_crop(generator: torch.Generator, video: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Uniform random spatial crop of the trailing (H, W) dims."""
    h, w = video.shape[-2], video.shape[-1]
    top = int(torch.randint(0, max(h - height, 0) + 1, (), generator=generator))
    left = int(torch.randint(0, max(w - width, 0) + 1, (), generator=generator))
    return crop(video, top, left, height, width)

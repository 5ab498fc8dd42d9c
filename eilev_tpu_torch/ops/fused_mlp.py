"""LayerNorm -> fc1 -> gelu -> fc2 kernel (counterpart of ``eilev_tpu/ops/fused_mlp.py``).

:func:`ln_mlp` is K6, the EVA-ViT MLP behind its pre-LayerNorm, with
:func:`ln_mlp_reference`, its plain twin. As in the JAX package, no model
calls it: the ViT runs LayerNorm and its MLP as separate modules
(``models/vision.py``), and K6 stands beside them as an op held against its
twin. The wrapper runs the twin for a CPU tensor; for a CUDA tensor it
launches the hand-written kernels of ``csrc/fused_mlp.cu`` on the current
stream or raises, and counts the call in ``ln_mlp.launches``: the bf16 body
for bf16 x and weights, the fp32 body for fp32 ones (an fp32 model; counted
also in ``ln_mlp.launches_f32``), ``TypeError`` for anything else. It has
no backward: with grad mode on, an input that requires grad raises
``RuntimeError`` on both devices.

The JAX function's ``_pick_fb`` and its fallback to XLA are a TPU VMEM budget
(one frame's fp32 fc1 activation under ~26 MB). They have no counterpart
here: on the card the kernel takes every shape the wrapper accepts.

Rounding points, as ``_xla_fallback`` and the Pallas body have them: LayerNorm
statistics and the affine in fp32, h rounded to the model dtype; fc1
accumulated in fp32, + b1, exact-erf gelu in fp32, rounded to the model dtype;
fc2 accumulated in fp32, + b2, rounded to the model dtype. In fp32 each
rounding is the identity.
"""

from __future__ import annotations

import torch

from .fused_attention import refuse_grad

# the kernels' row indices and TMA coordinates are int32, and the last
# tile (rows < M + 264) must fit: csrc/fused_mlp.cu:MAX_ROWS (the
# product kernels' grids are persistent, one block an SM, so no grid
# dimension limits M)
_MAX_ROWS = 2**31 - 512


def _mm_acc(a: torch.Tensor, w: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    """(M, K) @ (K, N) with exact products accumulated in ``acc``: fp32 (the
    JAX ``preferred_element_type=float32``), or fp64 for fp64 inputs."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(a, w, out_dtype=torch.float32)
    return a.to(acc) @ w.to(acc)


def ln_mlp_reference(
    x: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    *,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Plain twin of K6 (the JAX ``_xla_fallback``): x (B, S, D), w1 (D, F),
    w2 (F, D); returns (B, S, D) in x.dtype. Statistics and sums in fp32, or
    in fp64 for fp64 inputs (the yardstick of the fp32 body's numerics)."""
    b, s, d = x.shape
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf = x.to(acc)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    h = (xf - mu) * torch.rsqrt(var + eps)
    h = (h * ln_scale.to(acc) + ln_bias.to(acc)).to(x.dtype)
    a = _mm_acc(h.reshape(b * s, d), w1, acc) + b1.to(acc)
    a = torch.nn.functional.gelu(a).to(x.dtype)
    o = _mm_acc(a, w2, acc) + b2.to(acc)
    return o.to(x.dtype).reshape(b, s, d)


def _check(x, ln_scale, ln_bias, w1, b1, w2, b2) -> None:
    """Raise on anything the CUDA kernel does not take."""
    if x.ndim != 3:
        raise ValueError(f"x must be (B, S, D), got {tuple(x.shape)}")
    d = x.shape[2]
    if w1.ndim != 2 or w1.shape[0] != d:
        raise ValueError(f"w1 must be (D={d}, F), got {tuple(w1.shape)}")
    f = w1.shape[1]
    if tuple(w2.shape) != (f, d):
        raise ValueError(f"w2 must be (F={f}, D={d}), got {tuple(w2.shape)}")
    for name, vec, n in (("ln_scale", ln_scale, d), ("ln_bias", ln_bias, d), ("b1", b1, f), ("b2", b2, d)):
        if tuple(vec.shape) != (n,):
            raise ValueError(f"{name} must be ({n},), got {tuple(vec.shape)}")
    for name, t in (("x", x), ("ln_scale", ln_scale), ("ln_bias", ln_bias), ("w1", w1), ("b1", b1),
                    ("w2", w2), ("b2", b2)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32) or w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise TypeError(f"the CUDA kernels take x, w1, w2 all bf16 or all fp32, got "
                        f"{x.dtype}, {w1.dtype}, {w2.dtype}")
    bf16 = x.dtype == torch.bfloat16
    for name, t in (("x", x), ("w1", w1), ("w2", w2)):
        if not t.is_contiguous():
            raise ValueError(f"the CUDA kernel takes a contiguous {name}")
        if bf16 and t.data_ptr() % 16:
            raise ValueError(f"the CUDA kernel takes a 16-byte aligned {name}")
    if bf16 and (d % 8 or f % 8):
        raise ValueError(f"the CUDA kernel takes D % 8 == 0 and F % 8 == 0 (16-byte rows), got D={d}, F={f}")
    if x.shape[0] * x.shape[1] > _MAX_ROWS:
        raise ValueError(f"the CUDA kernel takes at most {_MAX_ROWS} rows (B*S), got {x.shape[0] * x.shape[1]}")


def _f32(vec: torch.Tensor) -> torch.Tensor:
    """A small vector as the kernel reads it: fp32 (the reference casts it so
    too), contiguous, 16-byte aligned."""
    out = vec.to(torch.float32).contiguous()
    return out if out.data_ptr() % 16 == 0 else out.clone()


def ln_mlp(
    x: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    *,
    eps: float = 1e-6,
) -> torch.Tensor:
    """K6: fc2(gelu(fc1(layernorm(x)))). x (B, S, D); w1 (D, F); w2 (F, D),
    the JAX (in, out) layout. Returns (B, S, D) in x.dtype."""
    refuse_grad("ln_mlp", "ln_mlp_reference", x, ln_scale, ln_bias, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return ln_mlp_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln_mlp runs on cpu or cuda tensors, got {x.device}")
    _check(x, ln_scale, ln_bias, w1, b1, w2, b2)
    from ._build import fused_mlp_lib

    b, s, d = x.shape
    f = w1.shape[1]
    m = b * s
    vecs = [_f32(v) for v in (ln_scale, ln_bias, b1, b2)]
    h = torch.empty(m, d, dtype=x.dtype, device=x.device)
    act = torch.empty(m, f, dtype=x.dtype, device=x.device)
    out = torch.empty(b, s, d, dtype=x.dtype, device=x.device)
    f32 = x.dtype == torch.float32
    lib = fused_mlp_lib()
    rc = (lib.eilev_ln_mlp_f32 if f32 else lib.eilev_ln_mlp_bf16)(
        x.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(), w1.data_ptr(), vecs[2].data_ptr(),
        w2.data_ptr(), vecs[3].data_ptr(), h.data_ptr(), act.data_ptr(), out.data_ptr(),
        m, d, f, eps, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"ln_mlp kernel launch failed: cudaError_t {rc}")
    ln_mlp.launches += 1
    ln_mlp.launches_f32 += f32
    return out


ln_mlp.launches = 0
ln_mlp.launches_f32 = 0

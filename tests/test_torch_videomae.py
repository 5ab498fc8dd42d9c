"""Port vs JAX: the VideoMAE classifier (models/videomae.py) at the config of
``tests/models/test_videomae.py`` (32^2, 4 frames, width 24, 2 layers).

- logits and loss against flax under ``xla`` and under ``flash`` (set in both
  packages, restored; JAX's flash runs in interpret mode, the port's its
  plain twin on the CPU), fp32 at 1e-5, bf16 (``dtype``) at 2e-2;
- ``convert_videomae`` against the flax tree (HF names made from the same
  numpy arrays), and ``state_dict_to_flax`` giving the tree back;
- the dispatch at the full VideoMAE-base geometry (16 x 224^2, 1,568 tokens,
  12 x 64), with both packages' kernels replaced by recorders and no compute
  (meta tensors, ``jax.eval_shape``): plain under ``auto`` (kv 1,568 < 2,048)
  in both, K5 12 times under ``flash``, bidirectional, no mask, no bias;
- the bf16 q, k, v that the attention hands K5 meet the CUDA wrapper's
  packed-row and alignment rules, and take its mma.sync body (head dim 64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eilev_tpu.ops.attention as jattn
import eilev_tpu.ops.flash_attention as jflash
import eilev_tpu_torch.ops.attention as tattn
import eilev_tpu_torch.ops.flash_attention as tflash
from eilev_tpu.models import videomae as jvm
from eilev_tpu_torch.models import videomae as tvm
from eilev_tpu_torch.models.convert import flax_to_state_dict, params_from_jax, state_dict_to_flax

from ._torch_port import random_params, to_np

TINY = dict(image_size=32, patch_size=16, num_frames=4, tubelet_size=2, hidden_size=24,
            num_hidden_layers=2, num_attention_heads=2, intermediate_size=48, num_labels=5)


@pytest.fixture(params=["xla", "flash"])
def impl(request):
    jattn.set_default_attention_impl(request.param)
    tattn.set_default_attention_impl(request.param)
    yield request.param
    jattn.set_default_attention_impl("auto")
    tattn.set_default_attention_impl("auto")


def _setup(seed=0, **overrides):
    jcfg, tcfg = jvm.VideoMAEConfig(**{**TINY, **overrides}), tvm.VideoMAEConfig(**{**TINY, **overrides})
    pixel = np.zeros((1, 3, jcfg.num_frames, jcfg.image_size, jcfg.image_size), np.float32)
    params = random_params(jvm.VideoMAEForVideoClassification(jcfg), seed, jnp.asarray(pixel))
    return jcfg, tcfg, jax.tree.map(np.asarray, params)


def _port(tcfg, params, dtype=torch.float32):
    model = tvm.VideoMAEForVideoClassification(tcfg, device="cpu", dtype=dtype)
    model.load_state_dict(params_from_jax(params, tcfg), strict=True)
    return model.requires_grad_(False).eval()


@pytest.mark.parametrize("dtype,tol", [("fp32", 1e-5), ("bf16", 2e-2)])
def test_logits_and_loss_match_flax(impl, dtype, tol):
    jcfg, tcfg, params = _setup(seed=1)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    rng = np.random.default_rng(2)
    pixel = rng.normal(size=(3, 3, 4, 32, 32)).astype(np.float32)
    labels = np.array([1, 3, 4])
    ref = jvm.VideoMAEForVideoClassification(jcfg, dtype=jdt).apply(
        {"params": params}, jnp.asarray(pixel), labels=jnp.asarray(labels))
    out = _port(tcfg, params, tdt)(torch.from_numpy(pixel), labels=torch.from_numpy(labels))
    assert out["logits"].dtype == tdt and out["loss"].dtype == torch.float32
    np.testing.assert_allclose(to_np(out["logits"]), np.asarray(ref["logits"], np.float32), atol=tol, rtol=tol)
    np.testing.assert_allclose(float(out["loss"]), float(ref["loss"]), atol=tol, rtol=tol)


def test_cls_pooling_matches_flax():
    """use_mean_pooling=False: the final layernorm and the first token."""
    jcfg, tcfg, params = _setup(seed=3, use_mean_pooling=False)
    pixel = np.random.default_rng(4).normal(size=(2, 3, 4, 32, 32)).astype(np.float32)
    ref = jvm.VideoMAEForVideoClassification(jcfg).apply({"params": params}, jnp.asarray(pixel))
    out = _port(tcfg, params)(torch.from_numpy(pixel))
    np.testing.assert_allclose(to_np(out["logits"]), np.asarray(ref["logits"]), atol=1e-5, rtol=1e-5)


def hf_state_dict(params, cfg) -> dict:
    """HF VideoMAEForVideoClassification names of a flax tree
    (``convert_videomae``'s inverse)."""
    d = cfg.hidden_size
    kernel = np.asarray(params["patch_kernel"])
    sd = {"videomae.embeddings.patch_embeddings.projection.weight": kernel.T.reshape(
              d, cfg.num_channels, cfg.tubelet_size, cfg.patch_size, cfg.patch_size).copy(),
          "videomae.embeddings.patch_embeddings.projection.bias": params["patch_bias"],
          "classifier.weight": params["classifier"]["kernel"].T, "classifier.bias": params["classifier"]["bias"],
          "fc_norm.weight": params["fc_norm"]["scale"], "fc_norm.bias": params["fc_norm"]["bias"]}
    for i in range(cfg.num_hidden_layers):
        layer, base = params[f"layers_{i}"], f"videomae.encoder.layer.{i}"
        att = layer["attention"]
        for name in ("query", "key", "value"):
            sd[f"{base}.attention.attention.{name}.weight"] = att[name]["kernel"].T
        sd[f"{base}.attention.attention.q_bias"] = att["q_bias"]
        sd[f"{base}.attention.attention.v_bias"] = att["v_bias"]
        for ours, theirs in (("attention.output", "attention.output.dense"), ("intermediate", "intermediate.dense"),
                             ("output", "output.dense")):
            node = att["output"] if ours == "attention.output" else layer[ours]
            sd[f"{base}.{theirs}.weight"] = node["kernel"].T
            sd[f"{base}.{theirs}.bias"] = node["bias"]
        for name in ("layernorm_before", "layernorm_after"):
            sd[f"{base}.{name}.weight"] = layer[name]["scale"]
            sd[f"{base}.{name}.bias"] = layer[name]["bias"]
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}


def test_convert_videomae_matches_the_flax_tree():
    jcfg, tcfg, params = _setup(seed=5)
    sd = hf_state_dict(params, jcfg)
    jtree = jvm.convert_videomae(sd, jcfg)
    want = flax_to_state_dict(params)
    assert all(torch.equal(flax_to_state_dict(jtree)[k], want[k]) for k in want)
    ours = tvm.convert_videomae({k: torch.from_numpy(v) for k, v in sd.items()}, tcfg)
    assert ours.keys() == want.keys()
    assert all(torch.equal(ours[k], want[k]) for k in want)
    # and back: the port module's flax tree is the one it was loaded from
    back = state_dict_to_flax(_port(tcfg, params))
    flat, ref = jax.tree_util.tree_flatten_with_path(back), jax.tree_util.tree_flatten_with_path(params)
    assert [p for p, _ in flat[0]] == [p for p, _ in ref[0]]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(flat[0], ref[0]))


def _record(monkeypatch, module, name, log, shape_only=False):
    """Log every call of ``module.name``; ``shape_only``: return an empty
    tensor of q's shape instead of calling it (the kernel on meta tensors)."""
    inner = getattr(module, name)

    def recording(*args, **kwargs):
        log.append((args, kwargs))
        return torch.empty_like(args[0]) if shape_only else inner(*args, **kwargs)

    monkeypatch.setattr(module, name, recording)


@pytest.mark.parametrize("mode", ["auto", "flash"])
def test_full_geometry_dispatch_matches_jax(monkeypatch, mode):
    """VideoMAE-base at 16 x 224^2 (1,568 tokens): plain under ``auto`` in
    both packages (q >= 1,024 but kv < 2,048), K5 once a layer under
    ``flash``; shapes only, no compute."""
    jcfg, tcfg = jvm.VideoMAEConfig(num_labels=7), tvm.VideoMAEConfig(num_labels=7)
    assert jcfg.num_patches == 1568 and jcfg.head_dim == 64
    jlog = {"flash": [], "xla": []}
    tlog = {"flash": [], "plain": []}
    _record(monkeypatch, jflash, "flash_attention", jlog["flash"])
    _record(monkeypatch, jattn, "_xla_attention", jlog["xla"])
    _record(monkeypatch, tflash, "flash_attention", tlog["flash"], shape_only=True)
    _record(monkeypatch, tattn, "plain_attention", tlog["plain"])
    jattn.set_default_attention_impl(mode)
    tattn.set_default_attention_impl(mode)
    try:
        model = jvm.VideoMAEForVideoClassification(jcfg)
        pixel = jax.ShapeDtypeStruct((1, 3, 16, 224, 224), jnp.float32)
        shapes = jax.eval_shape(lambda x: model.init(jax.random.PRNGKey(0), x), pixel)
        jlog["flash"].clear(), jlog["xla"].clear()  # count the apply only
        jout = jax.eval_shape(lambda p, x: model.apply(p, x), shapes, pixel)
        tmodel = tvm.VideoMAEForVideoClassification(tcfg, device="meta").requires_grad_(False)
        with torch.no_grad():
            out = tmodel(torch.empty(1, 3, 16, 224, 224, device="meta"))
    finally:
        jattn.set_default_attention_impl("auto")
        tattn.set_default_attention_impl("auto")
    assert tuple(out["logits"].shape) == jout["logits"].shape == (1, 7)
    flash_layers = 12 if mode == "flash" else 0
    assert len(jlog["flash"]) == len(tlog["flash"]) == flash_layers
    assert len(jlog["xla"]) == len(tlog["plain"]) == 12 - flash_layers
    for args, kwargs in tlog["flash"] + tlog["plain"]:
        q, k, v = args
        assert tuple(q.shape) == tuple(k.shape) == tuple(v.shape) == (1, 1568, 12, 64)
        assert kwargs.get("padding_mask") is None and kwargs.get("bias") is None and not kwargs.get("causal")
        assert kwargs["scale"] == 64**-0.5


def test_bf16_qkv_meet_the_cuda_wrapper_rules(monkeypatch):
    """The three projections' (B, S, H, 64) views are packed rows the K5
    wrapper reads in place, 16-byte aligned, and take its Hopper body (head
    dim 64, no bias: k5_body's "sm90")."""
    seen = []
    _record(monkeypatch, tflash, "flash_attention", seen)
    tattn.set_default_attention_impl("flash")
    try:
        _, tcfg, params = _setup(seed=6, hidden_size=128, num_attention_heads=2, intermediate_size=64)
        _port(tcfg, params, torch.bfloat16)(torch.randn(2, 3, 4, 32, 32))
    finally:
        tattn.set_default_attention_impl("auto")
    assert len(seen) == 2
    for args, kwargs in seen:
        q, k, v = args
        assert q.dtype == torch.bfloat16 and q.shape[-1] == 64
        tflash._check_cuda(q, k, v, None, None)  # raises on anything the kernel does not take
        assert tflash.k5_body(q, k, v) == "sm90" and tflash.uses_sm90_body(q, k, v)

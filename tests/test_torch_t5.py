"""Port vs JAX: the T5 modules (models/t5.py) at tiny_config(text_model="t5"),
fp32, atol 1e-4, on the same numpy weights and inputs.

The relative-position bucket tables are bit-equal to JAX's at every (q_len,
k_len, q_offset) the paths use, past max_distance (128) included. The
encoder, the decoder without a cache and its cached steps (the stacked
in-place cache, entry by entry) and the class scoring run under both the
plain path ("xla") and K5's twin ("flash"), the implementation set in both
packages and restored.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eilev_tpu import configs
from eilev_tpu.models import t5 as jt5
from eilev_tpu.ops import attention as jattn
from eilev_tpu_torch import configs as tconfigs
from eilev_tpu_torch.models import t5 as tt5
from eilev_tpu_torch.ops import attention as tattn
from eilev_tpu_torch.ops import gelu as tgelu

from ._torch_port import load_port, random_params, to_np

ATOL = 1e-4
B, S, S_DEC, MAX_LEN = 2, 9, 5, 7


def _cfgs(**kw):
    j = configs.tiny_config(text_model="t5").text_config
    t = tconfigs.tiny_config(text_model="t5").text_config
    return dataclasses.replace(j, **kw), dataclasses.replace(t, **kw)


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[1, -3:] = 0  # a padded encoder row
    dec = rng.integers(0, cfg.vocab_size, size=(B, S_DEC)).astype(np.int32)
    dec_mask = np.ones((B, S_DEC), np.int32)
    dec_mask[0, -1] = 0
    return emb, mask, dec, dec_mask


def _pair(seed=1, **kw):
    jcfg, tcfg = _cfgs(**kw)
    emb, mask, dec, _ = _inputs(jcfg)
    jmodel = jt5.T5ForConditionalGeneration(jcfg)
    params = jax.tree.map(np.asarray, random_params(jmodel, seed, emb, mask, dec))
    return jcfg, jmodel, params, load_port(tt5.T5ForConditionalGeneration(tcfg), params)


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.fixture(params=["xla", "flash"])
def impl(request):
    """The attention implementation, set in both packages and restored."""
    jattn.set_default_attention_impl(request.param)
    tattn.set_default_attention_impl(request.param)
    yield request.param
    jattn.set_default_attention_impl("auto")
    tattn.set_default_attention_impl("auto")


def _close(ours, ref, atol=ATOL):
    np.testing.assert_allclose(to_np(ours), np.asarray(ref, np.float32), atol=atol, rtol=0)


# (q_len, k_len, q_offset): the encoder at tiny and narration lengths (766
# spans every bucket, both signs past 128), the cached decoder steps over 33
# slots, a long offset (slots past max_distance) and the class scoring's
BUCKET_SHAPES = [(9, 9, 0), (766, 766, 0), (1, 33, 0), (1, 33, 17), (1, 33, 32), (1, 400, 399),
                 (3, 300, 150), (4, 4, 0)]


@pytest.mark.parametrize("bidirectional", [True, False])
def test_bucket_tables_bit_equal(bidirectional):
    for q_len, k_len, off in BUCKET_SHAPES:
        ref = jt5.relative_position_bucket(
            jt5.relative_positions(q_len, k_len, off), bidirectional=bidirectional,
            num_buckets=32, max_distance=128)
        ours = tt5.relative_position_bucket(
            tt5.relative_positions(q_len, k_len, off), bidirectional=bidirectional,
            num_buckets=32, max_distance=128)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref), err_msg=str((q_len, k_len, off)))
    # every distance to +-1000, far past max_distance: every bucket a sign can reach
    n = np.arange(-1000, 1000, dtype=np.int32)[None]
    ref = jt5.relative_position_bucket(jnp.asarray(n), bidirectional=bidirectional, num_buckets=32,
                                       max_distance=128)
    got = tt5.relative_position_bucket(torch.from_numpy(n), bidirectional=bidirectional, num_buckets=32,
                                       max_distance=128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert len(torch.unique(got)) == (31 if bidirectional else 32)  # bidirectional: +0 has no bucket


# (q_len, k_len, q_offset) of the biases the forwards build: the encoder at
# tiny and narration lengths (766 keys: a bf16 row of 1,532 bytes unpadded),
# a cached decoder step over 33 slots, the decoder without a cache
BIAS_LAYOUT_SHAPES = [(9, 9, 0), (766, 766, 0), (1, 33, 17), (5, 5, 0)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stack", ["encoder", "decoder"])
def test_relative_bias_buffer_holds_jax_compute_bias(pair, stack, dtype):
    """compute_bias gathers into an (H, q_len, k_pad) buffer, k_pad the
    multiple of 8 at or above k_len, and returns its [..., :k_len] view:
    keys contiguous, rows on 16-byte boundaries in bf16 (what K5's Hopper
    body reads by TMA), the values exactly JAX's compute_bias in the same
    dtype."""
    jcfg, _, params, model = pair
    jatt = jt5.T5Attention(jcfg, has_relative_attention_bias=True, bidirectional=stack == "encoder",
                           dtype=getattr(jnp, dtype))
    variables = {"params": params[stack]["layers_0"]["self_attention"]["attention"]}
    att = getattr(model, stack).layers[0].self_attention.attention
    for q_len, k_len, off in BIAS_LAYOUT_SHAPES:
        ref = jatt.apply(variables, q_len, k_len, off, method=jatt.compute_bias)
        with torch.no_grad():
            ours = att.compute_bias(q_len, k_len, off, dtype=getattr(torch, dtype))
        k_pad = -(-k_len // 8) * 8
        assert ours.shape == (1, jcfg.num_heads, q_len, k_len) and ours.dtype == getattr(torch, dtype)
        assert ours.stride()[1:] == (q_len * k_pad, k_pad, 1), (ours.stride(), k_len)
        np.testing.assert_array_equal(to_np(ours), np.asarray(ref.astype(jnp.float32)))


def test_encoder_builds_its_bias_once_in_padded_rows(pair, monkeypatch):
    """One bias a forward: every encoder layer's attention gets the same
    (H, S, S) view of the padded buffer, in the model dtype."""
    jcfg, _, _, model = pair
    emb, mask, _, _ = _inputs(jcfg)
    seen = []
    real = tt5.dot_product_attention

    def record(q, k, v, **kw):
        seen.append(kw.get("bias"))
        return real(q, k, v, **kw)

    monkeypatch.setattr(tt5, "dot_product_attention", record)
    with torch.no_grad():
        model.encode(torch.from_numpy(emb), torch.from_numpy(mask))
    assert len(seen) == jcfg.num_layers and all(b is seen[0] for b in seen)
    assert seen[0].shape == (jcfg.num_heads, S, S) and seen[0].stride() == (S * 16, 16, 1)
    assert seen[0].dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    """The variance in fp32, y rounded to the model dtype, times the fp32
    scale, rounded again: in bf16 within one ulp of the output."""
    jcfg, _ = _cfgs()
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, jcfg.d_model)).astype(np.float32) * 3.0
    scale = (1.0 + 0.1 * rng.normal(size=(jcfg.d_model,))).astype(np.float32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref = jt5.T5LayerNorm(jcfg, dtype=jd).apply({"params": {"scale": scale}}, jnp.asarray(x, jd))
    ln = tt5.T5LayerNorm(jcfg.d_model, jcfg.layer_norm_epsilon)  # fp32 scale, as flax's param
    ln.weight.data.copy_(torch.from_numpy(scale))
    out = ln(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert out.dtype == getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else 2 ** -7 * float(np.abs(np.asarray(ref, np.float32)).max())
    _close(out, ref, atol=tol)


def test_encoder_matches_jax(pair, impl):
    jcfg, jmodel, params, model = pair
    emb, mask, _, _ = _inputs(jcfg)
    ref = jmodel.apply({"params": params}, jnp.asarray(emb), jnp.asarray(mask), method=jmodel.encode)
    with torch.no_grad():
        ours = model.encode(torch.from_numpy(emb), torch.from_numpy(mask))
    _close(ours, ref)


def test_decoder_no_cache_matches_jax(pair, impl):
    """The training forward: encoder, causal decoder with its own padding
    mask, cross-attention over the padded encoder states, untied head."""
    jcfg, jmodel, params, model = pair
    emb, mask, dec, dec_mask = _inputs(jcfg)
    ref = jmodel.apply({"params": params}, jnp.asarray(emb), jnp.asarray(mask), jnp.asarray(dec),
                       jnp.asarray(dec_mask))
    with torch.no_grad():
        ours = model(torch.from_numpy(emb), torch.from_numpy(mask), torch.from_numpy(dec),
                     torch.from_numpy(dec_mask))
    assert ours.shape == (B, S_DEC, jcfg.vocab_size)
    _close(ours, ref)


def test_cached_decode_matches_jax(pair, impl):
    """init_decode_cache (the stacked cross K/V) and one-token steps: logits
    and every cache entry, written in place, equal JAX's functional cache."""
    jcfg, jmodel, params, model = pair
    emb, mask, dec, _ = _inputs(jcfg)
    v = {"params": params}
    jenc = jmodel.apply(v, jnp.asarray(emb), jnp.asarray(mask), method=jmodel.encode)
    jcache = jmodel.apply(v, jenc, MAX_LEN, method=jmodel.init_decode_cache)
    with torch.no_grad():
        cache = model.init_decode_cache(model.encode(torch.from_numpy(emb), torch.from_numpy(mask)), MAX_LEN)
    assert cache["k"].shape == (jcfg.num_decoder_layers, B, MAX_LEN, jcfg.num_heads, jcfg.d_kv)
    for key in ("cross_k", "cross_v"):
        _close(cache[key], jcache[key])
    for step in range(S_DEC):
        tok = dec[:, step : step + 1]
        jlogits, jcache = jmodel.apply(v, jnp.asarray(tok), jenc, jnp.asarray(mask), jcache,
                                       method=jmodel.decode_step)
        with torch.no_grad():
            logits, cache = model.decode_step(torch.from_numpy(tok), None, torch.from_numpy(mask), cache)
        _close(logits, jlogits)
        assert cache["index"] == int(jcache["index"]) == step + 1
        for key in ("k", "v"):
            _close(cache[key], jcache[key])


def test_score_classes_matches_jax(pair, impl):
    """(B, C, L) class continuations over the shared encoder states, a (C, L)
    class mask with padding (its -inf rows, as JAX's)."""
    jcfg, jmodel, params, model = pair
    emb, mask, _, _ = _inputs(jcfg)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, jcfg.vocab_size, size=(3, 4)).astype(np.int32)
    cls_mask = np.ones((3, 4), np.int32)
    cls_mask[1, 2:] = 0
    v = {"params": params}
    jenc = jmodel.apply(v, jnp.asarray(emb), jnp.asarray(mask), method=jmodel.encode)
    ref = jmodel.apply(v, jnp.asarray(ids), jnp.asarray(cls_mask), jenc, jnp.asarray(mask),
                       method=jmodel.score_classes)
    with torch.no_grad():
        enc = model.encode(torch.from_numpy(emb), torch.from_numpy(mask))
        ours = model.score_classes(torch.from_numpy(ids), torch.from_numpy(cls_mask), enc, torch.from_numpy(mask))
    assert ours.shape == (B, 3, 4, jcfg.vocab_size)
    _close(ours, ref)


@pytest.mark.parametrize("variant", [
    dict(tie_word_embeddings=True),  # the head scales by d_model**-0.5 first
    dict(is_gated_act=False, dense_act_fn="relu"),
    dict(is_gated_act=False, dense_act_fn="gelu"),
], ids=["tied_head", "relu_ff", "gelu_ff"])
def test_head_and_ff_variants_match_jax(variant):
    jcfg, jmodel, params, model = _pair(seed=2, **variant)
    emb, mask, dec, dec_mask = _inputs(jcfg, seed=4)
    ref = jmodel.apply({"params": params}, jnp.asarray(emb), jnp.asarray(mask), jnp.asarray(dec),
                       jnp.asarray(dec_mask))
    with torch.no_grad():
        ours = model(torch.from_numpy(emb), torch.from_numpy(mask), torch.from_numpy(dec),
                     torch.from_numpy(dec_mask))
    _close(ours, ref)


def test_gelu_switch_leaves_t5_alone(pair):
    """T5's tanh gelu is its own: the process-wide vision switch
    (ops/gelu.py) does not move the logits."""
    jcfg, _, _, model = pair
    emb, mask, dec, dec_mask = (torch.from_numpy(a) for a in _inputs(jcfg))
    with torch.no_grad():
        ref = model(emb, mask, dec, dec_mask)
        try:
            tgelu.set_gelu_impl("fast")
            fast = model(emb, mask, dec, dec_mask)
        finally:
            tgelu.set_gelu_impl("exact")
    assert torch.equal(ref, fast)

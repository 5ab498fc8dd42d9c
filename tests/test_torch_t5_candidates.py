"""Port vs JAX: T5's contrastive-search helpers (models/t5.py, models/video_blip.py)
at tiny_config(text_model="t5"), B = 2 with a padded encoder row, on the same
numpy weights and inputs.

Each level against its JAX method: ``T5Attention.shared_prefix``,
``T5SelfAttentionLayer.shared_prefix``, ``T5DecoderLayer.shared_prefix``,
``T5Decoder.candidates``, ``T5ForConditionalGeneration.candidates`` and
``decode_step_hidden``, and VideoBLIP's ``t5_candidates`` /
``t5_decode_step_hidden``; fp32 at atol 1e-4, bf16 (a bf16 compute over the
fp32 weights in both packages) at atol = rtol = 2e-2 with NaN positions equal;
under "xla" and "flash" (set in both packages and restored), after 0, 1 and 3
committed decode steps. In the port alone: each candidate's hidden is the
hidden the committed decode step gives for that token (fp32 1e-4; bf16 min
cosine > 0.999, the card's bar), and ``candidates`` writes nothing into the
cache. The tensor-parallel case runs in tests/test_torch_parallel_tp.py.

The helpers add no parameters: ``models/convert.py``'s ``params_from_jax`` /
``flax_to_state_dict`` carry the same weights into the port unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eilev_tpu import configs
from eilev_tpu.models import t5 as jt5
from eilev_tpu.models.video_blip import VideoBlipForConditionalGeneration as JVB
from eilev_tpu.ops import attention as jattn
from eilev_tpu_torch import configs as tconfigs
from eilev_tpu_torch.models import VideoBlipForConditionalGeneration, params_from_jax
from eilev_tpu_torch.models import t5 as tt5
from eilev_tpu_torch.ops import attention as tattn

from ._torch_port import load_port, random_params, to_np

B, S, MAX_LEN, C = 2, 9, 7, 4
TOL = {"float32": dict(atol=1e-4, rtol=0), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
JDTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
STEPS = [0, 1, 3]


def _cfgs():
    return configs.tiny_config(text_model="t5").text_config, tconfigs.tiny_config(text_model="t5").text_config


def _inputs(cfg, seed=0):
    """Encoder embeddings (row 1 padded by 3), decoder tokens, candidate tokens."""
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[1, -3:] = 0
    dec = rng.integers(0, cfg.vocab_size, size=(B, MAX_LEN)).astype(np.int32)
    cands = rng.integers(0, cfg.vocab_size, size=(B, C)).astype(np.int32)
    return emb, mask, dec, cands


@pytest.fixture(scope="module")
def pairs():
    """Per dtype: (JAX config, JAX model, numpy params, port model); bf16 is a
    bf16 compute over the fp32 weights in both."""
    jcfg, tcfg = _cfgs()
    emb, mask, dec, _ = _inputs(jcfg)
    params = jax.tree.map(np.asarray, random_params(jt5.T5ForConditionalGeneration(jcfg), 1, emb, mask, dec[:, :3]))
    out = {}
    for name, jd in JDTYPE.items():
        compute = None if name == "float32" else torch.bfloat16
        model = load_port(tt5.T5ForConditionalGeneration(tcfg, compute_dtype=compute), params)
        out[name] = (jcfg, jt5.T5ForConditionalGeneration(jcfg, dtype=jd), params, model)
    return out


@pytest.fixture(params=["xla", "flash"])
def impl(request):
    """The attention implementation, set in both packages and restored."""
    jattn.set_default_attention_impl(request.param)
    tattn.set_default_attention_impl(request.param)
    yield request.param
    jattn.set_default_attention_impl("auto")
    tattn.set_default_attention_impl("auto")


def _close(ours, ref, dtype):
    ours, ref = to_np(ours), np.asarray(ref, np.float32)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    np.testing.assert_allclose(np.nan_to_num(ours), np.nan_to_num(ref), **TOL[dtype])


def _t(x, dtype):
    return torch.from_numpy(np.array(x, np.float32)).to(getattr(torch, dtype))


@pytest.fixture(scope="module")
def states(pairs):
    """``states(dtype, steps)``: both packages' decode caches after ``steps``
    committed decode steps of the same tokens (JAX's cache functional, the
    port's written in place), made once for each (dtype, attention
    implementation, steps); the port's returned as a fresh copy."""
    made = {}

    def get(dtype, steps):
        key = (dtype, tattn.get_default_attention_impl(), steps)
        if key not in made:
            made[key] = _make_states(pairs[dtype], dtype, steps)
        jcache, cache = made[key]
        return jcache, _clone(cache)

    return get


def _make_states(pair, dtype, steps):
    jcfg, jmodel, params, model = pair
    emb, mask, dec, _ = _inputs(jcfg)
    v = {"params": params}
    jenc = jmodel.apply(v, jnp.asarray(emb, JDTYPE[dtype]), jnp.asarray(mask), method=jmodel.encode)
    jcache = jmodel.apply(v, jenc, MAX_LEN, method=jmodel.init_decode_cache)
    with torch.no_grad():
        enc = model.encode(_t(emb, dtype), torch.from_numpy(mask))
        cache = model.init_decode_cache(enc, MAX_LEN)
    for j in range(steps):
        tok = dec[:, j : j + 1]
        _, jcache = jmodel.apply(v, jnp.asarray(tok), jenc, jnp.asarray(mask), jcache, method=jmodel.decode_step)
        with torch.no_grad():
            _, cache = model.decode_step(torch.from_numpy(tok), None, torch.from_numpy(mask), cache)
    return jcache, cache


LEVELS = ["attention", "self_layer", "decoder_layer"]


@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shared_prefix_matches_jax(pairs, states, impl, dtype, level, steps):
    """The attention and each layer's shared_prefix on the same inputs: (B, C,
    L = 2) continuations over JAX's cache after ``steps`` steps as the prefix
    (its unfilled slots masked by finfo.min), a random relative prefix bias,
    a self bias with the causal mask, the padded encoder row's bias."""
    jcfg, _, params, model = pairs[dtype]
    jcache, _ = states(dtype, steps)
    rng = np.random.default_rng(20 + steps)
    nh, l = jcfg.num_heads, 2
    x = rng.normal(size=(B, C, l, jcfg.d_model)).astype(np.float32)
    filled = np.arange(MAX_LEN) < steps
    neg = np.finfo(np.float32).min
    prefix_bias = (rng.normal(size=(1, 1, nh, l, MAX_LEN)).astype(np.float32)
                   + np.where(filled, 0.0, neg).astype(np.float32)[None, None, None, None])
    causal = np.where(np.tril(np.ones((l, l), bool)), 0.0, neg).astype(np.float32)
    self_bias = rng.normal(size=(1, 1, nh, l, l)).astype(np.float32) + causal
    _, mask, _, _ = _inputs(jcfg)
    enc_bias = np.where(mask.astype(bool), 0.0, neg).astype(np.float32)[:, None, None, None, :]
    pk, pv, ck, cv = (np.asarray(jcache[key][0], np.float32) for key in ("k", "v", "cross_k", "cross_v"))

    jd = JDTYPE[dtype]
    dec_params = params["decoder"]["layers_0"]
    if level == "attention":
        jmod = jt5.T5Attention(jcfg, has_relative_attention_bias=True, bidirectional=False, dtype=jd)
        variables, ours_mod = dec_params["self_attention"]["attention"], model.decoder.layers[0].self_attention.attention
    elif level == "self_layer":
        jmod = jt5.T5SelfAttentionLayer(jcfg, has_relative_attention_bias=True, bidirectional=False, dtype=jd)
        variables, ours_mod = dec_params["self_attention"], model.decoder.layers[0].self_attention
    else:
        jmod = jt5.T5DecoderLayer(jcfg, has_relative_attention_bias=True, dtype=jd)
        variables, ours_mod = dec_params, model.decoder.layers[0]
    args = [x, pk, pv, prefix_bias, self_bias] + ([ck, cv, enc_bias] if level == "decoder_layer" else [])
    cast = {0, 1, 2, 5, 6}  # the hidden and the K/V in the model dtype; the biases fp32
    ref = jmod.apply({"params": variables}, *(jnp.asarray(a, jd if i in cast else jnp.float32)
                                              for i, a in enumerate(args)), method=jmod.shared_prefix)
    with torch.no_grad():
        ours = ours_mod.shared_prefix(*(_t(a, dtype) if i in cast else torch.from_numpy(a)
                                        for i, a in enumerate(args)))
    assert ours.dtype == getattr(torch, dtype)
    _close(ours, ref, dtype)


@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_candidates_and_step_hidden_match_jax(pairs, states, impl, dtype, steps):
    """After ``steps`` committed steps: T5Decoder.candidates on the candidate
    embeddings, T5ForConditionalGeneration.candidates on their ids, and
    decode_step_hidden (logits, final-norm hidden and the cache it writes)
    equal JAX's over the same cache."""
    jcfg, jmodel, params, model = pairs[dtype]
    jcache, cache = states(dtype, steps)
    if dtype == "bfloat16":
        # the port's buffers take JAX's values: the two CPU backends' bf16
        # encoders already differ by an ulp in the cross K/V (ROADMAP, facts),
        # which two layers carry past 2e-2; fp32 keeps each package's own
        for key in ("k", "v", "cross_k", "cross_v"):
            cache[key].copy_(_t(jcache[key], dtype))
    _, mask, dec, cands = _inputs(jcfg)
    v = {"params": params}
    jmask, tmask = jnp.asarray(mask), torch.from_numpy(mask)
    jemb = jmodel.apply(v, jnp.asarray(cands), method=jmodel.embed)[:, :, None]
    ref_dec = jmodel.apply(v, jemb, jmask, jcache, method=lambda m, *a: m.decoder.candidates(*a))
    ref = jmodel.apply(v, jnp.asarray(cands), jmask, jcache, method=jmodel.candidates)
    with torch.no_grad():
        ours_dec = model.decoder.candidates(_t(np.asarray(jemb, np.float32), dtype), tmask, cache)
        ours = model.candidates(torch.from_numpy(cands), tmask, cache)
    assert ours_dec.shape == (B, C, 1, jcfg.d_model) and ours.shape == (B, C, jcfg.d_model)
    _close(ours_dec, ref_dec, dtype)
    _close(ours, ref, dtype)

    tok = dec[:, steps : steps + 1]
    jlogits, jhidden, jcache = jmodel.apply(v, jnp.asarray(tok), None, jmask, jcache,
                                            method=jmodel.decode_step_hidden)
    with torch.no_grad():
        logits, hidden, cache = model.decode_step_hidden(torch.from_numpy(tok), None, tmask, cache)
    _close(logits, jlogits, dtype)
    _close(hidden, jhidden, dtype)
    assert cache["index"] == int(jcache["index"]) == steps + 1
    for key in ("k", "v"):
        _close(cache[key], jcache[key], dtype)


@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_candidate_is_the_committed_step(pairs, states, impl, dtype, steps):
    """Each candidate's hidden is the final-norm hidden decode_step_hidden
    gives when that token is committed on a clone of the cache (fp32 1e-4,
    bf16 min cosine > 0.999); decode_step_hidden's logits are decode_step's
    bit for bit; candidates leaves every cache tensor and the index as they
    were."""
    jcfg, _, _, model = pairs[dtype]
    _, cache = states(dtype, steps)
    _, mask, _, cands = _inputs(jcfg)
    tmask = torch.from_numpy(mask)
    before = _clone(cache)
    with torch.no_grad():
        hidden = model.candidates(torch.from_numpy(cands), tmask, cache)
    assert cache.keys() == before.keys() and cache["index"] == before["index"] == steps
    for key in ("k", "v", "cross_k", "cross_v"):
        assert torch.equal(cache[key], before[key]), key
    for c in range(C):
        tok = torch.from_numpy(cands[:, c : c + 1])
        with torch.no_grad():
            logits, committed, _ = model.decode_step_hidden(tok, None, tmask, _clone(cache))
            plain, _ = model.decode_step(tok, None, tmask, _clone(cache))
        assert torch.equal(logits, plain)
        if dtype == "float32":
            np.testing.assert_allclose(to_np(hidden[:, c]), to_np(committed[:, 0]), atol=1e-4, rtol=0)
        else:
            cos = torch.nn.functional.cosine_similarity(hidden[:, c].float(), committed[:, 0].float(), dim=-1)
            assert cos.min().item() > 0.999, cos


def _clone(cache: dict) -> dict:
    return {k: v.clone() if torch.is_tensor(v) else v for k, v in cache.items()}


@pytest.fixture(scope="module")
def vb_pair():
    """A tiny VideoBLIP-T5 in both packages on the same numpy weights."""
    cfg, tcfg = configs.tiny_config(text_model="t5"), tconfigs.tiny_config(text_model="t5")
    rng = np.random.default_rng(13)
    ids = rng.integers(4, cfg.text_config.vocab_size, size=(B, 12)).astype(np.int32)
    vim = np.zeros((B, 12), np.int32)
    vim[:, 2 : 2 + cfg.num_query_tokens] = 1
    jmodel = JVB(cfg)
    params = random_params(jmodel, 14, input_ids=jnp.asarray(ids), pixel_values=jnp.zeros((B, 3, 2, 16, 16)),
                           video_input_mask=jnp.asarray(vim), decoder_input_ids=jnp.zeros((B, 1), jnp.int32))
    params = jax.tree.map(np.asarray, params)
    model = VideoBlipForConditionalGeneration(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(params, tcfg), strict=True)
    return cfg, jmodel, params, model.eval()


@pytest.mark.parametrize("steps", STEPS)
def test_videoblip_t5_helpers_match_jax(vb_pair, impl, steps):
    """VideoBLIP's t5_decode_step_hidden and t5_candidates (fp32) over the
    cache of its language model after ``steps`` steps, against JAX's."""
    cfg, jmodel, params, model = vb_pair
    emb, mask, dec, cands = _inputs(cfg.text_config, seed=steps)
    v = {"params": params}
    jmask, tmask = jnp.asarray(mask), torch.from_numpy(mask)
    jenc = jmodel.apply(v, jnp.asarray(emb), jmask, method=lambda m, e, k: m.language_model.encode(e, k))
    jcache = jmodel.apply(v, jenc, MAX_LEN, method=lambda m, e, n: m.language_model.init_decode_cache(e, n))
    with torch.no_grad():
        cache = model.language_model.init_decode_cache(model.t5_encode(torch.from_numpy(emb), tmask), MAX_LEN)
    for j in range(steps + 1):
        tok = dec[:, j : j + 1]
        jlogits, jhidden, jcache = jmodel.apply(v, jnp.asarray(tok), jenc, jmask, jcache,
                                                method=JVB.t5_decode_step_hidden)
        with torch.no_grad():
            logits, hidden, cache = model.t5_decode_step_hidden(torch.from_numpy(tok), None, tmask, cache)
        _close(logits, jlogits, "float32")
        _close(hidden, jhidden, "float32")
    ref = jmodel.apply(v, jnp.asarray(cands), jmask, jcache, method=JVB.t5_candidates)
    with torch.no_grad():
        ours = model.t5_candidates(torch.from_numpy(cands), tmask, cache)
    _close(ours, ref, "float32")

"""Port vs JAX: the T5 branch of the serving engine and the T5 pieces it reaches.

Modules: the decoder's cached step over the engine's slot cache (per-row
``mask``) and ``decode_append`` (``T5Decoder.spec_append``: intra-block
causal, relative bias over attended-token distances) against the flax
methods on the same cache with dead prefixes and a speculative hole, fp32
logits within 1e-4, under ``xla`` and (the step) ``flash``, where the
step's self and cross attention take K5's bias form. The engine (mirrors of
``tests/serving/``'s T5 cases): plain and speculative rows token-identical
to JAX's isolated seq2seq ``generate`` (its new tokens), with staggered
admission, slot reuse, compaction, the gamma-0 pressure fallback, eviction
with replay and the full defrag, the stats equal to the JAX engine's; a
point-mass temperature gives the greedy rows; in bf16 each engine gives its
own package's isolated generate, and the requests admitted into a slot that
decoded while empty are token 0 in both engines (the reference's NaN).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eilev_tpu.models.video_blip import VideoBlipForConditionalGeneration as JVB
from eilev_tpu.ops import attention as jattention
from eilev_tpu_torch.ops import attention as tattention

from ._torch_serving import assert_rows, drive_topped_up, engine, jax_engine, make_world, reference_rows, to_jax


@pytest.fixture(scope="module")
def world():
    return make_world("t5")


@pytest.fixture(params=["xla", "flash"])
def impl(request):
    jattention.set_default_attention_impl(request.param)
    tattention.set_default_attention_impl(request.param)
    yield request.param
    jattention.set_default_attention_impl("auto")
    tattention.set_default_attention_impl("auto")


def _slot_cache(w, seed=0):
    """A (3 slots, 10 positions) slot cache with random k/v and cross K/V,
    index 6: row 0 live over [1, 6) with a hole at 3, row 1 over [4, 6),
    row 2 empty; encoder masks with padded tails."""
    cfg = w.cfg.text_config
    rng = np.random.default_rng(seed)
    L, H, D = cfg.num_decoder_layers, cfg.num_heads, cfg.d_kv
    arr = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    mask = np.zeros((3, 10), np.int32)
    mask[0, 1:6], mask[0, 3], mask[1, 4:6] = 1, 0, 1
    enc_mask = np.ones((3, 7), np.int32)
    enc_mask[1, 5:], enc_mask[2, 3:] = 0, 0
    return dict(k=arr(L, 3, 10, H, D), v=arr(L, 3, 10, H, D), cross_k=arr(L, 3, 7, H, D),
                cross_v=arr(L, 3, 7, H, D), mask=mask, index=6), enc_mask


def _jax_cache(c):
    return {k: jnp.asarray(v, jnp.int32 if k in ("index", "mask") else jnp.float32) for k, v in c.items()}


def _torch_cache(c):
    return {k: v if k == "index" else torch.from_numpy(v.copy()) for k, v in c.items()}


def test_decode_step_over_slot_cache_matches_jax(world, impl):
    c, enc_mask = _slot_cache(world)
    ids = np.array([[5], [9], [0]])
    jlogits, jcache = world.jmodel.apply(world.variables, jnp.asarray(ids), None, jnp.asarray(enc_mask),
                                         _jax_cache(c), method=JVB.t5_decode_step)
    cache = _torch_cache(c)
    with torch.inference_mode():
        logits, _ = world.model.t5_decode_step(torch.from_numpy(ids), None, torch.from_numpy(enc_mask), cache)
    torch.testing.assert_close(logits, torch.from_numpy(np.asarray(jlogits)), atol=1e-4, rtol=1e-4)
    assert cache["index"] == int(jcache["index"]) == 7
    np.testing.assert_array_equal(cache["mask"].numpy(), np.asarray(jcache["mask"]))
    for key in ("k", "v"):
        torch.testing.assert_close(cache[key], torch.from_numpy(np.asarray(jcache[key])), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("gate", ["rows", "positions"])
def test_decode_append_matches_jax(world, gate):
    """A 3-token verify block appended at index 6 over dead prefixes and a
    hole; ``active`` gates whole rows (the verify pass) or block positions
    (the replay of a right-padded block)."""
    c, enc_mask = _slot_cache(world, seed=1)
    ids = np.array([[5, 7, 11], [9, 3, 2], [0, 0, 0]])
    active = np.array([True, True, False]) if gate == "rows" else np.array([[1, 1, 0], [1, 0, 0], [0, 0, 0]], bool)
    jlogits, jcache = world.jmodel.apply(world.variables, jnp.asarray(ids), jnp.asarray(enc_mask), _jax_cache(c),
                                         jnp.asarray(active), method=JVB.t5_decode_append)
    cache = _torch_cache(c)
    with torch.inference_mode():
        logits, _ = world.model.t5_decode_append(torch.from_numpy(ids), torch.from_numpy(enc_mask), cache,
                                                 torch.from_numpy(active))
    # gated rows and positions attend their own slot only (logits the engine
    # discards, computed the same way in both packages)
    torch.testing.assert_close(logits, torch.from_numpy(np.asarray(jlogits)), atol=1e-4, rtol=1e-4)
    assert cache["index"] == int(jcache["index"]) == 9
    np.testing.assert_array_equal(cache["mask"].numpy(), np.asarray(jcache["mask"]))


GEN6 = dict(max_new_tokens=6, pad_token_id=0)
T5_KW = dict(max_slots=2, prefill_bucket=8, max_prompt_len=24)


def test_engine_t5_batch_matches_isolated_generate(world):
    requests = [world.make_request(seed, extra_text=seed % 3) for seed in range(4)]
    ref = reference_rows(world, requests, **GEN6)
    eng = engine(world, GEN6, max_len=32, chunk_tokens=3, **T5_KW)
    assert_rows(eng.run([dataclasses.replace(r) for r in requests]), ref)
    assert len({tuple(r) for r in ref}) > 1


def test_engine_t5_flash_matches_isolated_generate(world, impl):
    """Under ``flash`` the decoder's self and cross steps take K5's bias
    form (its twin here) over the per-row mask."""
    requests = [world.make_request(seed, extra_text=seed % 3) for seed in range(3)]
    with_impl = reference_rows(world, requests, **GEN6)
    eng = engine(world, GEN6, max_len=32, chunk_tokens=3, **T5_KW)
    assert_rows(eng.run([dataclasses.replace(r) for r in requests]), with_impl)


def test_engine_t5_staggered_and_compaction(world):
    """Staggered arrivals into a tight decoder cache: slot reuse and rolling
    compaction (T5's bias is translation-invariant), stats the JAX engine's."""
    gen = dict(max_new_tokens=4, pad_token_id=0)
    requests = [world.make_request(60 + seed, extra_text=seed % 2) for seed in range(6)]
    ref = reference_rows(world, requests, **gen)
    kw = dict(max_len=12, chunk_tokens=3, **T5_KW)
    eng = engine(world, gen, **kw)
    assert_rows(drive_topped_up(eng, requests, first_alone=True), ref)
    jeng = jax_engine(world, gen, **kw)
    drive_topped_up(jeng, [to_jax(r) for r in requests], first_alone=True)
    assert eng.stats == jeng.stats and eng.stats["compactions"] >= 1, (eng.stats, jeng.stats)


def test_engine_t5_rejects_oversized_prompt(world):
    eng = engine(world, dict(max_new_tokens=4, pad_token_id=0), max_slots=1, max_len=12, chunk_tokens=2,
                 prefill_bucket=8, max_prompt_len=8)
    eng.submit(world.make_request(99))  # 14 tokens > max_prompt_len 8
    with pytest.raises(ValueError, match="max_prompt_len"):
        eng.step()


def spec_t5(w, gen, **kw):
    kw = {**T5_KW, "max_len": 64, "spec_gamma": 3, "spec_match_len": 2, **kw}
    return engine(w, gen, speculative="prompt_lookup", **kw)


def test_spec_t5_matches_isolated_generate(world):
    requests = [world.make_request(seed, extra_text=seed % 3) for seed in range(4)]
    ref = reference_rows(world, requests, **GEN6)
    eng, done = spec_t5(world, GEN6), {}
    eng.submit(dataclasses.replace(requests[0]))
    done.update((c.rid, c) for c in eng.step())
    for r in requests[1:]:
        eng.submit(dataclasses.replace(r))
    while not eng.idle:
        done.update((c.rid, c) for c in eng.step())
    assert_rows(done, ref)
    assert eng.stats["spec_passes"] > 0


def test_spec_t5_extra_corpus_acceptance(world):
    gen = dict(max_new_tokens=8, pad_token_id=0)
    base = world.make_request(11)
    ref = reference_rows(world, [base], **gen)
    eng = spec_t5(world, gen, spec_gamma=4, spec_match_len=1, spec_extra_corpus=32)
    assert_rows(eng.run([dataclasses.replace(base, extra_corpus=ref[0].astype(np.int64))]), ref)
    assert eng.stats["spec_tokens"] > eng.stats["spec_rows"], eng.stats


@pytest.mark.parametrize("case", ["fallback", "defrag"])
def test_spec_t5_pressure_fallback_eviction_and_defrag(world, case):
    """A decoder cache too small for the speculative windows: compaction,
    the gamma-0 hole-aware step, eviction with in-place replay and (all rows
    admitted together, each pinning the others) the full defrag. Rows
    identical, stats the JAX engine's."""
    gen = dict(max_new_tokens=8, pad_token_id=0)
    requests = [world.make_request(seed) for seed in range(4)]
    ref = reference_rows(world, requests, **gen)
    kw = dict(max_len=14, prefill_bucket=4) if case == "fallback" else dict(max_len=12, prefill_bucket=2)
    eng = spec_t5(world, gen, **kw)
    assert_rows(eng.run([dataclasses.replace(r) for r in requests]), ref)
    jeng = jax_engine(world, gen, speculative="prompt_lookup", **{**T5_KW, "spec_gamma": 3, "spec_match_len": 2,
                                                                    **kw})
    assert_rows(jeng.run([to_jax(r) for r in requests]), ref)
    assert eng.stats == jeng.stats, (eng.stats, jeng.stats)
    assert eng.stats["spec_fallback_chunks"] + eng.stats["evictions"] + eng.stats["defrags"] > 0


@pytest.mark.parametrize("seed", [0, 5])
def test_spec_t5_sampling_point_mass_equals_greedy(world, seed):
    requests = [world.make_request(s, extra_text=s % 2) for s in range(3)]
    ref = reference_rows(world, requests, **GEN6)
    eng = spec_t5(world, dict(GEN6, do_sample=True, temperature=1e-7), generator=torch.Generator().manual_seed(seed))
    assert_rows(eng.run([dataclasses.replace(r) for r in requests]), ref)
    assert eng.stats["spec_passes"] > 0


@pytest.fixture(scope="module")
def bf16_world():
    return make_world("t5", dtype=torch.bfloat16)


def _own_generate(w, r, gen):
    """The port's isolated bf16 generate of ``r`` as an engine row."""
    from eilev_tpu_torch.generation import GenerationConfig, generate

    ours = generate(w.model, input_ids=torch.from_numpy(r.input_ids[None]),
                    pixel_values=torch.from_numpy(r.pixel_values).to(torch.bfloat16),
                    video_input_mask=torch.from_numpy(r.video_input_mask[None]),
                    generation_config=GenerationConfig(**gen))[0, 1:].numpy()
    row = np.full(gen["max_new_tokens"], gen["pad_token_id"], np.int32)
    row[: len(ours)] = ours
    return row


def test_engine_t5_bf16_empty_slot_nan_as_in_jax(bf16_world):
    """bf16, staggered (the first request decodes a chunk alone): a slot
    that decodes while empty has an all-zero encoder mask, so its cross
    attention is fully masked, NaN in bf16 on the plain path, and the NaN
    k/v it leaves in its self-cache row reach its next occupant behind the
    mask (p = 0 times NaN v). Both engines give exactly those requests token
    0 throughout (the reference's behaviour); each other row is its own
    package's isolated bf16 generate."""
    w = bf16_world
    gen = dict(max_new_tokens=4, pad_token_id=0)
    requests = [w.make_request(60 + seed, extra_text=seed % 2) for seed in range(4)]
    kw = dict(max_len=12, chunk_tokens=3, **T5_KW)
    done = drive_topped_up(engine(w, gen, **kw), requests, first_alone=True)
    jdone = drive_topped_up(jax_engine(w, gen, **kw), [to_jax(r) for r in requests], first_alone=True)
    jref = reference_rows(w, requests, **gen)
    nan = {rid for rid in range(4) if (done[rid].tokens == 0).all() and not (_own_generate(w, requests[rid], gen) == 0).all()}
    jnan = {rid for rid in range(4) if (jdone[rid].tokens == 0).all() and not (jref[rid] == 0).all()}
    assert nan == jnan and nan, (nan, jnan)
    for rid in set(range(4)) - nan:
        np.testing.assert_array_equal(done[rid].tokens, _own_generate(w, requests[rid], gen))
        np.testing.assert_array_equal(jdone[rid].tokens, jref[rid])


def test_engine_t5_bf16_rows_are_isolated_generate(bf16_world):
    """bf16, every slot filled before the first decode: T5 prompts are
    right-padded into the cross buffers, so no query row is fully masked.
    Each package's engine rows equal its own isolated bf16 generate, so the port's engine row equals JAX's engine row exactly
    where the two packages' isolated bf16 generates agree (their bf16
    roundings differ: at these std-0.5 weights they part on some rows)."""
    w = bf16_world
    requests = [w.make_request(seed, extra_text=seed % 3) for seed in range(4)]
    kw = dict(max_len=32, chunk_tokens=3, **T5_KW)
    done = engine(w, GEN6, **kw).run([dataclasses.replace(r) for r in requests])
    jdone = jax_engine(w, GEN6, **kw).run([to_jax(r) for r in requests])
    jref = reference_rows(w, requests, **GEN6)
    assert_rows(jdone, jref)
    for rid, r in enumerate(requests):
        row = _own_generate(w, r, GEN6)
        np.testing.assert_array_equal(done[rid].tokens, row, err_msg=str(rid))
        assert np.array_equal(done[rid].tokens, jdone[rid].tokens) == np.array_equal(row, jref[rid])

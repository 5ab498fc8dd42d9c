"""Port vs JAX: per-slot prompt-lookup speculative serving, decoder-only,
greedy (the sampling cases are in ``tests/test_torch_serving_spec_sampling.py``,
so that ``--dist loadfile`` runs the two halves in two workers).

Mirrors ``tests/serving/test_engine_spec.py``'s OPT cases: every engine row
is token-identical to JAX's isolated greedy ``generate``, while each slot
advances by its own acceptance, across staggered admission, eos, slot
reuse, compaction, the plain-decode pressure fallback and eviction with
recompute; the scheduling cases hold the port's ``stats`` to the JAX
engine's.
"""

import dataclasses

import numpy as np
import pytest

from eilev_tpu_torch.generation import GenerationConfig
from eilev_tpu_torch.serving import ContinuousBatchingEngine

from ._torch_serving import assert_rows, engine, jax_engine, make_world, reference_rows, to_jax

GEN = dict(max_new_tokens=6, pad_token_id=1)


@pytest.fixture(scope="module")
def world():
    return make_world("opt")


def spec(w, gen, **kw):
    kw = {"max_slots": 2, "max_len": 96, "prefill_bucket": 16, "spec_gamma": 4, "spec_match_len": 2, **kw}
    return engine(w, gen, speculative="prompt_lookup", **kw)


def jax_spec(w, gen, **kw):
    kw = {"max_slots": 2, "max_len": 96, "prefill_bucket": 16, "spec_gamma": 4, "spec_match_len": 2, **kw}
    return jax_engine(w, gen, speculative="prompt_lookup", **kw)


def test_spec_engine_matches_isolated_generate(world):
    requests = [world.make_request(seed, extra_text=seed % 3) for seed in range(4)]
    ref = reference_rows(world, requests, **GEN)
    eng = spec(world, GEN)
    assert_rows(eng.run([dataclasses.replace(r) for r in requests]), ref)
    assert eng.stats["spec_passes"] > 0 and eng.stats["spec_tokens"] >= eng.stats["spec_rows"]
    jeng = jax_spec(world, GEN)
    jeng.run([to_jax(r) for r in requests])
    assert eng.stats == jeng.stats, (eng.stats, jeng.stats)


def test_spec_engine_staggered_arrivals(world):
    requests = [world.make_request(seed, extra_text=seed % 2) for seed in range(3)]
    ref = reference_rows(world, requests, **GEN)
    eng, done = spec(world, GEN), {}
    for r in requests:
        eng.submit(dataclasses.replace(r))
        done.update((c.rid, c) for c in eng.step())
    while not eng.idle:
        done.update((c.rid, c) for c in eng.step())
    assert_rows(done, ref)


def test_spec_acceptance_exceeds_one_on_echo_prompt(world):
    """A prompt whose tail repeats its own greedy continuation: the matcher
    accepts more than one token a pass, and the row is still generate's."""
    gen = dict(max_new_tokens=8, pad_token_id=1)
    base = world.make_request(7)
    first = reference_rows(world, [base], **gen)[0]
    echo = [int(t) for t in first[:4]] * 2
    req = dataclasses.replace(base, input_ids=np.concatenate([base.input_ids, np.asarray(echo, np.int64)]),
                              video_input_mask=np.concatenate([base.video_input_mask, np.zeros(8, np.int64)]))
    ref = reference_rows(world, [req], **gen)
    eng = spec(world, gen, max_len=128)
    assert_rows(eng.run([req]), ref)
    assert eng.stats["spec_tokens"] > eng.stats["spec_rows"], eng.stats


def test_spec_engine_extra_corpus(world):
    """``Request.extra_corpus`` feeds the matcher only: the true continuation
    there lifts acceptance above one token a pass; a garbage one changes
    nothing."""
    gen = dict(max_new_tokens=8, pad_token_id=1)
    base = world.make_request(11)
    ref = reference_rows(world, [base], **gen)
    eng = spec(world, gen, spec_extra_corpus=32, spec_match_len=1)
    assert_rows(eng.run([dataclasses.replace(base, extra_corpus=ref[0].astype(np.int64))]), ref)
    assert eng.stats["spec_tokens"] > eng.stats["spec_rows"], eng.stats
    eng = spec(world, gen, spec_extra_corpus=32)
    assert_rows(eng.run([dataclasses.replace(base, extra_corpus=np.arange(40, 70, dtype=np.int64))]), ref)


def test_spec_engine_slot_reuse_and_eos(world):
    """Rows ending early on eos free slots that later requests reuse."""
    requests = [world.make_request(seed) for seed in range(6)]
    probe = reference_rows(world, requests, max_new_tokens=5, pad_token_id=1)
    gen = dict(max_new_tokens=5, pad_token_id=1, eos_token_id=(int(probe[0][2]),))
    ref = reference_rows(world, requests, **gen)
    assert any((row == gen["pad_token_id"]).any() for row in ref)
    assert_rows(spec(world, gen).run([dataclasses.replace(r) for r in requests]), ref)


@pytest.mark.parametrize("case", ["compaction", "eviction"])
def test_spec_engine_under_pressure(world, case):
    """compaction: a max_len too small for the backlog (rolling compaction
    and the plain-decode fallback); eviction: no headroom for speculative
    windows nor plain chunks mid-flight, so a row is evicted and recomputed
    from [prompt + emitted]. Rows identical, stats the JAX engine's."""
    if case == "compaction":
        gen, requests = GEN, [world.make_request(seed) for seed in range(5)]
        kw = dict(max_len=48)
    else:
        gen = dict(max_new_tokens=10, pad_token_id=1)
        requests = [world.make_request(seed) for seed in range(3)]
        kw = dict(max_len=28, chunk_tokens=4, prefill_bucket=4)
    ref = reference_rows(world, requests, **gen)
    eng = spec(world, gen, **kw)
    assert_rows(eng.run([dataclasses.replace(r) for r in requests]), ref)
    jeng = jax_spec(world, gen, **kw)
    assert_rows(jeng.run([to_jax(r) for r in requests]), ref)
    assert eng.stats == jeng.stats, (eng.stats, jeng.stats)
    if case == "compaction":
        assert eng.stats["compactions"] + eng.stats["resets"] + eng.stats["spec_fallback_chunks"] > 0
    else:
        assert eng.stats["evictions"] >= 1, eng.stats


def test_spec_engine_rejects_unknown_mode(world):
    with pytest.raises(ValueError, match="unknown speculative mode"):
        ContinuousBatchingEngine(world.model, GenerationConfig(**GEN), speculative="banana")


def test_spec_engine_int8_kv():
    """Speculative serving over the int8 KV cache: the verify pass reads the
    dequantized cache, holes and rollbacks act on its mask and pos."""
    w = make_world("opt", modes={"int8_kv": True})
    requests = [w.make_request(seed) for seed in range(3)]
    ref = reference_rows(w, requests, **GEN)
    assert_rows(spec(w, GEN).run([dataclasses.replace(r) for r in requests]), ref)

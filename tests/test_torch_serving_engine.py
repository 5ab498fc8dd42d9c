"""Port vs JAX: the continuous-batching engine, decoder-only, plain decode.

Each case mirrors one of ``tests/serving/test_engine.py``: every engine row
of the port is token-identical to JAX's isolated ``generate`` of the same
request (fp32), whenever it was admitted, in whichever slot, behind however
much left-padding, across flushes, resets and compactions; where a case is
about the engine's own scheduling, the JAX engine runs beside the port's and
their ``stats`` are equal. In bf16 the port reproduces the reference's
contract: a request's rows are finite exactly when its admission was not
left-padded (the mask value is -inf in bf16, so a padded admission's fully
masked query rows are NaN); the padded rows come out token 0, as JAX's
engine gives them.
"""

import dataclasses

import numpy as np
import pytest
import torch

from eilev_tpu.serving import VideoFeatureCache as JVideoFeatureCache
from eilev_tpu_torch.generation import GenerationConfig, generate
from eilev_tpu_torch.serving import ContinuousBatchingEngine, VideoFeatureCache

from ._torch_serving import (
    assert_rows,
    drive_topped_up,
    engine,
    jax_engine,
    make_world,
    reference_rows,
    to_jax,
)


@pytest.fixture(scope="module")
def world():
    return make_world("opt")


def test_engine_batch_matches_isolated_generate(world):
    gen = dict(max_new_tokens=6, pad_token_id=1)
    requests = [world.make_request(seed, extra_text=seed % 3) for seed in range(4)]
    ref = reference_rows(world, requests, **gen)
    eng = engine(world, gen, max_slots=2, max_len=96, chunk_tokens=3, prefill_bucket=16)
    assert_rows(eng.run([dataclasses.replace(r) for r in requests]), ref)
    assert len({tuple(r) for r in ref}) > 1  # the rows differ


@pytest.mark.parametrize("video_bucket", [0, 2])
def test_engine_mixed_video_geometry(world, video_bucket):
    """0, 1, 2 and 4 videos a request through one engine; ``video_bucket``
    routes every vision encode through fixed buckets of videos."""
    gen = dict(max_new_tokens=5, pad_token_id=1)
    requests = [world.make_request(seed, n_videos=n) for seed, n in ((31, 1), (32, 4), (33, 0), (34, 2), (35, 4))]
    ref = reference_rows(world, requests, **gen)
    eng = engine(world, gen, max_slots=2, max_len=96, chunk_tokens=3, prefill_bucket=8, video_bucket=video_bucket)
    assert_rows(eng.run([dataclasses.replace(r) for r in requests]), ref)


def test_engine_staggered_arrivals_match(world):
    """Requests arriving mid-decode (different chunks, reused slots)."""
    gen = dict(max_new_tokens=5, pad_token_id=1)
    requests = [world.make_request(10 + seed, extra_text=seed % 4) for seed in range(5)]
    ref = reference_rows(world, requests, **gen)
    eng = engine(world, gen, max_slots=2, max_len=128, chunk_tokens=2, prefill_bucket=16)
    arrival = {0: 0, 1: 0, 2: 1, 3: 2, 4: 4}  # rid -> chunk of submission
    done, chunk, pending = {}, 0, list(range(5))
    while pending or not eng.idle:
        for rid in [r for r in pending if arrival[r] <= chunk]:
            assert eng.submit(dataclasses.replace(requests[rid])) == rid
            pending.remove(rid)
        done.update((c.rid, c) for c in eng.step())
        chunk += 1
        assert chunk < 200
    assert_rows(done, ref)
    for rid in range(5):
        assert done[rid].admitted_at_chunk >= arrival[rid]


def test_engine_session_flush_and_reset(world):
    """A max_len too small for two requests at once: the cache is
    reclaimed between requests, counted as JAX's engine counts it."""
    gen = dict(max_new_tokens=4, pad_token_id=1)
    requests = [world.make_request(20 + seed) for seed in range(3)]
    ref = reference_rows(world, requests, **gen)
    kw = dict(max_slots=1, max_len=24, chunk_tokens=2, prefill_bucket=8)
    eng = engine(world, gen, **kw)
    assert_rows(eng.run([dataclasses.replace(r) for r in requests]), ref)
    jeng = jax_engine(world, gen, **kw)
    jdone = jeng.run([to_jax(r) for r in requests])
    assert_rows(jdone, ref)
    assert eng.stats == jeng.stats, (eng.stats, jeng.stats)
    assert eng.stats["compactions"] + eng.stats["resets"] >= 1, eng.stats


def test_engine_rolling_compaction_no_drain(world):
    """Cache pressure compacts (a left shift of the dead prefix) instead of
    draining: rows identical, the JAX engine's compactions and no reset."""
    gen = dict(max_new_tokens=4, pad_token_id=1)
    requests = [world.make_request(40 + seed, extra_text=seed % 2) for seed in range(8)]
    ref = reference_rows(world, requests, **gen)
    kw = dict(max_slots=2, max_len=32, chunk_tokens=2, prefill_bucket=8)
    eng = engine(world, gen, **kw)
    assert_rows(drive_topped_up(eng, requests), ref)
    jeng = jax_engine(world, gen, **kw)
    drive_topped_up(jeng, [to_jax(r) for r in requests])
    assert eng.stats == jeng.stats, (eng.stats, jeng.stats)
    assert eng.stats["compactions"] >= 1 and eng.stats["resets"] == 0, eng.stats


def test_compaction_shifts_the_cache_in_place(world):
    """``_compact_cache`` rolls each layer of k/v along the slot axis and
    zeroes the mask past the new index, in the same buffers, leaving pos."""
    from eilev_tpu_torch.models import init_cache
    from eilev_tpu_torch.serving.engine import _compact_cache

    cache = init_cache(world.model.config.text_config, 3, 10)
    g = torch.Generator().manual_seed(0)
    for key in ("k", "v"):
        cache[key].copy_(torch.randn(cache[key].shape, generator=g))
    cache["mask"][:, 3:8] = 1
    cache["mask"][1, 3:5] = 0
    cache["index"], cache["pos"][:] = 8, 5
    before = {key: cache[key].clone() for key in ("k", "v", "mask", "pos")}
    ptrs = {key: cache[key].data_ptr() for key in ("k", "v", "mask")}
    _compact_cache(cache, 3)
    assert cache["index"] == 5
    for key in ("k", "v"):
        torch.testing.assert_close(cache[key], torch.roll(before[key], -3, dims=2), rtol=0, atol=0)
    want = torch.roll(before["mask"], -3, dims=1)
    want[:, 5:] = 0
    assert torch.equal(cache["mask"], want) and torch.equal(cache["pos"], before["pos"])
    assert {key: cache[key].data_ptr() for key in ptrs} == ptrs


def test_engine_rejects_oversized_prompt(world):
    gen = dict(max_new_tokens=8, pad_token_id=1)
    eng = engine(world, gen, max_slots=1, max_len=24, chunk_tokens=2, prefill_bucket=8)
    eng.submit(world.make_request(30, extra_text=40))  # prompt 54 > 24 - 8
    with pytest.raises(ValueError, match="cannot fit"):
        eng.step()


@pytest.mark.parametrize("lazy", [False, True])
def test_engine_feature_cache_matches(world, lazy):
    """A VideoFeatureCache (a shared video encoded once; lazily, frames
    fetched for the misses only) gives the pixel path's rows, and counts hits
    and misses as JAX's engine with JAX's cache does."""
    gen = dict(max_new_tokens=6, pad_token_id=1)
    requests = [world.make_request(60 + seed, extra_text=seed % 3) for seed in range(3)]
    if lazy:
        frames = {f"v{i}": r.pixel_values[0] for i, r in enumerate(requests)}
        requests_in = [dataclasses.replace(r, pixel_values=None, feature_keys=[f"v{i}"])
                       for i, r in enumerate(requests)]
    else:
        shared = requests[0].pixel_values
        requests = [dataclasses.replace(r, pixel_values=shared, feature_keys=["shared"]) for r in requests]
        requests_in = requests
    ref = reference_rows(world, requests, **gen)

    def run(cache_cls, eng_fn, model_args, convert):
        loads = []

        def loader(key):
            loads.append(key)
            return frames[key]

        cache = cache_cls(*model_args, bucket=2)
        eng = eng_fn(world, gen, max_slots=2, max_len=96, chunk_tokens=3, prefill_bucket=16, feature_cache=cache,
                     feature_loader=loader if lazy else None)
        return eng.run([convert(r) for r in requests_in]), cache, loads

    done, cache, loads = run(VideoFeatureCache, engine, (world.model,), lambda r: dataclasses.replace(r))
    assert_rows(done, ref)
    _, jcache, jloads = run(JVideoFeatureCache, jax_engine, (world.jmodel, world.variables), to_jax)
    assert (cache.hits, cache.misses, loads) == (jcache.hits, jcache.misses, jloads)
    assert (cache.misses, cache.hits) == ((3, 0) if lazy else (1, 2))


def test_engine_vision_chunks_match(world):
    gen = dict(max_new_tokens=5, pad_token_id=1)
    requests = [world.make_request(70 + seed, n_videos=2) for seed in range(2)]
    ref = reference_rows(world, requests, **gen)
    eng = engine(world, gen, max_slots=2, max_len=96, chunk_tokens=3, prefill_bucket=8, vision_chunks=2)
    assert_rows(eng.run([dataclasses.replace(r) for r in requests]), ref)


@pytest.mark.parametrize("knobs,error,match", [
    (dict(max_length=64), NotImplementedError, "max_length"),
    (dict(min_length=8), NotImplementedError, "min_length"),
    (dict(repetition_penalty=1.2), NotImplementedError, "repetition_penalty"),
    (dict(num_return_sequences=2, do_sample=True), NotImplementedError, "one sequence"),
    (dict(penalty_alpha=0.6, top_k=4), NotImplementedError, "contrastive"),
    (dict(max_new_tokens=120), ValueError, "cannot hold one prompt bucket"),
])
def test_engine_refusals(world, knobs, error, match):
    """Every knob JAX's engine refuses, refused with its message."""
    cfg = GenerationConfig(**{"max_new_tokens": 4, "pad_token_id": 1, **knobs})
    with pytest.raises(error, match=match):
        ContinuousBatchingEngine(world.model, cfg, max_slots=2, max_len=128, prefill_bucket=16)


def test_engine_feature_loader_needs_cache(world):
    with pytest.raises(ValueError, match="feature_loader requires feature_cache"):
        ContinuousBatchingEngine(world.model, GenerationConfig(max_new_tokens=4, pad_token_id=1),
                                 feature_loader=lambda key: None)


def test_engine_int8_kv_matches_isolated_generate():
    """The int8 KV cache serving mode: admission, decode (K4's twin) and
    compaction over int8 k/v with bf16 scales."""
    w = make_world("opt", int8_kv=True)
    gen = dict(max_new_tokens=4, pad_token_id=1)
    requests = [w.make_request(40 + seed, extra_text=seed % 2) for seed in range(5)]
    ref = reference_rows(w, requests, **gen)
    eng = engine(w, gen, max_slots=2, max_len=32, chunk_tokens=2, prefill_bucket=8)
    assert_rows(drive_topped_up(eng, requests), ref)
    assert eng.stats["compactions"] >= 1


def test_engine_bf16_left_padded_admissions_are_nan_as_in_jax():
    """bf16, the three requests of the reference run at prefill_bucket 16:
    every admission left-pads (W = bucket(max(index, P)) > P), so every
    row is token 0 in both engines (NaN logits); a 16-token request alone
    is not padded, finite, and equals isolated bf16 generate."""
    w = make_world("opt", dtype=torch.bfloat16)
    gen = dict(max_new_tokens=8, pad_token_id=1)
    kw = dict(max_slots=2, max_len=128, chunk_tokens=4, prefill_bucket=16)
    requests = [w.make_request(1), w.make_request(2, extra_text=5), w.make_request(3, extra_text=2)]
    finite = []
    hook = w.model.language_model.register_forward_hook(
        lambda mod, args, out: finite.append((args[0].shape[1], bool(torch.isfinite(out[0]).all()))))
    try:
        done = engine(w, gen, **kw).run([dataclasses.replace(r) for r in requests])
    finally:
        hook.remove()
    jdone = jax_engine(w, gen, **kw).run([to_jax(r) for r in requests])
    for rid in range(3):
        np.testing.assert_array_equal(done[rid].tokens, jdone[rid].tokens, err_msg=str(rid))
        assert (done[rid].tokens == 0).all(), done[rid].tokens
    prefills = [ok for s_len, ok in finite if s_len > 1]
    assert len(prefills) == 3 and not any(prefills)  # each padded admission's logits are NaN

    # 16 tokens: W = P. Each engine's row is its own package's isolated bf16
    # generate (the packages' bf16 roundings differ, so their rows may part)
    alone = w.make_request(1, extra_text=2)
    done = engine(w, gen, **kw).run([dataclasses.replace(alone)])
    ref = generate(w.model, input_ids=torch.from_numpy(alone.input_ids[None]),
                   pixel_values=torch.from_numpy(alone.pixel_values).to(torch.bfloat16),
                   video_input_mask=torch.from_numpy(alone.video_input_mask[None]),
                   generation_config=GenerationConfig(**gen))
    np.testing.assert_array_equal(done[0].tokens, ref[0].numpy())
    np.testing.assert_array_equal(jax_engine(w, gen, **kw).run([to_jax(alone)])[0].tokens,
                                  reference_rows(w, [alone], **gen)[0])
    assert (done[0].tokens != 0).any()

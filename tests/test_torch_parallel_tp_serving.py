"""Tensor-parallel serving against the JAX package: the continuous-batching
engine, the video-feature cache, ``ChatSession`` and ``serve
--model_parallel``, at ``tiny_config(hidden=32, heads=4, vocab_size=61)``,
fp32, tp 2 over gloo.

One ``torch.multiprocessing.spawn`` of 2 gloo ranks (tests/_torch_tp_worker.py:
``serving_main``) runs every case, each rank its own engine on the same
requests; the JAX references and the one-process port runs are computed
meanwhile in this process:

- greedy engine rows equal JAX's isolated ``generate`` rows (as
  tests/serving/test_engine.py builds them) on both ranks: OPT with
  staggered submits and compaction under a small ``max_len``, the int8 KV
  cache, prompt-lookup speculative serving, the T5 engine, and a
  ``VideoFeatureCache`` over three shared video keys at capacity 2, whose hits,
  misses, evictions and LRU order are the same on both ranks and in one
  process (the cache runs no collective of its own);
- every case's engine stats equal the one-process port engine's;
- sampled rows (one generator seed on every rank) are the same on both ranks
  and in the one-process port engine with that seed;
- ``ChatSession``'s two turns equal ``eilev_tpu.serving.ChatSession``'s;
- ``serve --model_parallel 2 --arrival_rate 5``, with rank 1's
  ``time.perf_counter`` running 3x slow, writes the CSV of one process
  (rank 0 alone writes it and prints the metrics line): rank 0's clock
  decides the arrivals for both ranks.
"""

import csv
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eilev_tpu.generation import GenerationConfig as JGenerationConfig
from eilev_tpu.serving import ChatSession as JChatSession
from eilev_tpu_torch.cli import serve

from . import _torch_tp_worker as worker
from ._torch_serving import make_world, reference_rows
from .test_torch_cli import world  # noqa: F401  (the module-scoped world fixture)
from .test_torch_serving_cli import _serve_argv

GEOMETRY = dict(hidden=32, heads=4, vocab_size=61)
GEN = dict(max_new_tokens=8, pad_token_id=1)
T5_GEN = dict(max_new_tokens=4, pad_token_id=0)
SAMPLED = dict(max_new_tokens=8, pad_token_id=1, do_sample=True, top_k=8)
CHAT_GEN = dict(max_new_tokens=6, pad_token_id=1)
CHAT_KW = dict(max_len=128, bucket=8)
ARRIVALS = ["--arrival_rate", "5"]
GREEDY_CASES = ["staggered", "int8_kv", "prompt_lookup", "t5", "feature_cache"]
SHARED_KEYS = [0, 1, 0, 2]  # the feature-cache requests' videos: a hit, misses and an LRU eviction at capacity 2


def _cases(worlds) -> dict:
    """The engine cases of ``_torch_tp_worker._engine_cases``: (world,
    generation kwargs, engine kwargs, requests, cache capacity, generator
    seed)."""
    opt, int8, t5 = worlds["opt"], worlds["opt_int8_kv"], worlds["t5"]
    requests = [opt.make_request(40 + s) for s in range(4)]  # one prompt length: JAX compiles generate once
    videos = [r.pixel_values for r in requests[:3]]
    shared = [dataclasses.replace(r, pixel_values=videos[k], feature_keys=[f"v{k}"])
              for k, r in zip(SHARED_KEYS, requests)]
    plain = dict(max_slots=2, max_len=96, chunk_tokens=3, prefill_bucket=16)
    return {
        "staggered": ("opt", GEN, dict(max_slots=2, max_len=24, chunk_tokens=2, prefill_bucket=8), requests, 0,
                      None),
        "int8_kv": ("opt_int8_kv", GEN, plain, [int8.make_request(s) for s in range(3)], 0, None),
        "prompt_lookup": ("opt", GEN, dict(max_slots=2, max_len=96, prefill_bucket=16, speculative="prompt_lookup",
                                           spec_gamma=4, spec_match_len=2), requests, 0, None),
        "t5": ("t5", T5_GEN, dict(max_slots=2, max_len=32, chunk_tokens=3, prefill_bucket=8, max_prompt_len=24),
               [t5.make_request(s) for s in range(3)], 0, None),
        "feature_cache": ("opt", GEN, plain, shared, 2, None),
        "sampled": ("opt", SAMPLED, dict(max_slots=2, max_len=96, chunk_tokens=2, prefill_bucket=16), requests, 0,
                    11),
    }


def _chat_turns(w) -> list:
    """Two turns: a video and 8 text tokens, then 7 more text tokens (each
    turn's arrays extend the conversation; the reply goes between them)."""
    q, img = w.cfg.num_query_tokens, w.cfg.vision_config.image_size
    r = np.random.default_rng(5)
    ids1 = r.integers(4, w.cfg.text_config.vocab_size, size=(q + 8,))
    vim1 = np.zeros(q + 8, np.int64)
    vim1[:q] = 1
    video = r.normal(size=(1, 3, 2, img, img)).astype(np.float32)
    ids2 = r.integers(4, w.cfg.text_config.vocab_size, size=(7,))
    return [(ids1, video, vim1), (ids2, video, np.zeros(7, np.int64))]


def _jax_chat(w, turns) -> list:
    sess = JChatSession(w.jmodel, w.variables, JGenerationConfig(**CHAT_GEN), **CHAT_KW)
    replies, ids, vim = [], None, None
    for extra_ids, videos, extra_vim in turns:
        ids = extra_ids if ids is None else np.concatenate([ids, replies[-1].astype(ids.dtype), extra_ids])
        vim = extra_vim if vim is None else np.concatenate([vim, np.zeros(len(replies[-1]), vim.dtype), extra_vim])
        replies.append(np.asarray(sess.turn(ids, jnp.asarray(videos), vim)))
    return replies


@pytest.fixture(scope="module")
def ranks(world, tmp_path_factory):  # noqa: F811
    """Spawn the ranks, then compute JAX's rows and chat replies, the
    one-process port engines and the one-process serve CSV; (rank results,
    references, one-process results, CSV paths)."""
    out_dir = tmp_path_factory.mktemp("tp_serving")
    worlds = {"opt": make_world("opt", geometry=GEOMETRY),
              "opt_int8_kv": make_world("opt", modes={"int8_kv": True}, geometry=GEOMETRY),
              "t5": make_world("t5", geometry=GEOMETRY)}
    models = {name: (w.tcfg, w.variables["params"]) for name, w in worlds.items()}
    cases = _cases(worlds)
    turns = _chat_turns(worlds["opt"])
    paths = {"tp": str(out_dir / "tp.csv"), "one": str(out_dir / "one.csv")}
    ctx = worker.spawn(worker.serving_main, str(out_dir), models, cases, ("opt", turns, CHAT_GEN, CHAT_KW),
                       _serve_argv(world, paths["tp"]) + ARRIVALS)

    refs = {name: reference_rows(worlds[case[0]], case[3], **case[1]) for name, case in cases.items()
            if name in GREEDY_CASES}
    refs["chat"] = _jax_chat(worlds["opt"], turns)
    one = worker._engine_cases({name: w.model for name, w in worlds.items()}, cases)
    one["serve"] = serve.main(_serve_argv(world, paths["one"]) + ARRIVALS + ["--device", "cpu"])
    return worker.join(ctx, str(out_dir)), refs, one, paths


@pytest.mark.parametrize("name", GREEDY_CASES)
def test_tp_engine_rows_match_jax_generate(ranks, name):
    results, refs, one, _ = ranks
    for out in results:
        rows = out[name]["rows"]
        assert sorted(rows) == list(range(len(refs[name])))
        for rid, row in enumerate(refs[name]):
            np.testing.assert_array_equal(rows[rid].numpy(), row, err_msg=f"{name} rid {rid}")
        assert out[name]["stats"] == one[name]["stats"], (out[name]["stats"], one[name]["stats"])
    assert len({tuple(r) for r in refs[name]}) > 1  # the rows differ


def test_tp_engine_scheduling_cases_exercise_their_paths(ranks):
    results, _, one, _ = ranks
    stats = results[0]
    assert stats["staggered"]["stats"]["compactions"] >= 1, stats["staggered"]["stats"]
    assert stats["prompt_lookup"]["stats"]["spec_passes"] > 0
    hits, misses, evictions, order = stats["feature_cache"]["cache"]
    assert (hits, misses, evictions, order) == (1, 3, 1, ["v0", "v2"]), stats["feature_cache"]["cache"]
    for out in results:  # the LRU order is the same on every rank and in one process
        assert out["feature_cache"]["cache"] == one["feature_cache"]["cache"]


def test_tp_sampled_rows_match_across_ranks_and_one_process(ranks):
    results, _, one, _ = ranks
    for out in results:
        assert out["sampled"]["rows"].keys() == one["sampled"]["rows"].keys()
        for rid, row in one["sampled"]["rows"].items():
            assert torch.equal(out["sampled"]["rows"][rid], row), rid
    greedy = results[0]["staggered"]["rows"]
    assert any(not torch.equal(row, greedy[rid]) for rid, row in one["sampled"]["rows"].items())


def test_tp_chat_session_matches_jax(ranks):
    results, refs, _, _ = ranks
    for out in results:
        assert len(out["chat"]) == len(refs["chat"]) == 2
        for mine, theirs in zip(out["chat"], refs["chat"]):
            np.testing.assert_array_equal(mine, theirs)


def test_tp_serve_writes_the_one_process_csv(ranks):
    results, _, one, paths = ranks
    with open(paths["tp"], newline="") as f_tp, open(paths["one"], newline="") as f_one:
        ours, theirs = list(csv.DictReader(f_tp)), list(csv.DictReader(f_one))
    assert ours == theirs and len(ours) == 4
    (rows0, metrics0), (rows1, metrics1) = (out["serve"] for out in results)
    assert rows0 == rows1 == ours
    assert metrics1 is None and metrics0["requests"] == 4 and metrics0["arrival_rate"] == 5.0
    assert one["serve"][1]["requests"] == 4

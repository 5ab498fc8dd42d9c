"""Port vs JAX: the serve CLI and the demo's chat modes, on the CPU.

The serve CLI runs through its ``main`` with ``--device cpu`` on the tiny
world of ``tests/test_torch_cli.py`` (PNG frames, the offline tokenizer, the
checkpoint the JAX package exported); its CSV equals the JAX script's, row
for row, in fp32, plain, speculative and with the feature cache, and its
metrics line carries the JAX script's keys plus the time to first chunk.
The demo's ``EilevChat`` (loaded from the same checkpoint) answers a
question about a video as the JAX demo's does in each mode: the original beam-5 turn,
``kv_reuse`` (a persistent ChatSession) and ``engine`` (a persistent
engine), and the greedy modes equal each other and the greedy stream.
"""

import csv
import json
import os
import runpy

import numpy as np
import pytest

from eilev_tpu_torch.cli import serve
from eilev_tpu_torch.demo import eilev_demo

from .test_torch_cli import REPO, _run_jax_script, world  # noqa: F401  (the module-scoped world fixture)


def _serve_argv(world, out_csv: str) -> list[str]:  # noqa: F811
    return [
        "--model", str(world / "checkpoint"), "--dtype", "fp32",
        "--eval_frames_dir", str(world / "frames"),
        "--in_context_query_map_file", str(world / "icl_map.jsonl"),
        "--in_context_example_frames_dir", str(world / "frames"),
        "--num_eval_datapoints", "4", "--max_new_tokens", "4",
        "--max_slots", "2", "--max_len", "256", "--chunk_tokens", "2", "--prefill_bucket", "16",
        "--output_csv", out_csv,
    ]


def _read(path: str) -> list[dict]:
    with open(path, newline="") as f:  # generated text may hold a bare "\r"
        return list(csv.DictReader(f))


@pytest.mark.parametrize("extra", [[], ["--draft", "prompt_lookup"], ["--vision_cache", "8"]],
                         ids=["plain", "prompt_lookup", "vision_cache"])
def test_serve_cli_matches_jax(world, tmp_path, capsys, extra):  # noqa: F811
    ours_csv, ref_csv = str(tmp_path / "ours.csv"), str(tmp_path / "ref.csv")
    rows, metrics = serve.main(_serve_argv(world, ours_csv) + extra + ["--device", "cpu"])
    capsys.readouterr()
    _run_jax_script("serve.py", _serve_argv(world, ref_csv) + extra)
    jmetrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ours, ref = _read(ours_csv), _read(ref_csv)
    assert ours == ref == rows and len(ours) == 4
    assert any(r["generated"] for r in ours)
    assert set(jmetrics) <= set(metrics)
    assert metrics["requests"] == 4 and metrics["first_chunk_p50_sec"] <= metrics["latency_p50_sec"]
    assert (metrics["cache_compactions"], metrics["cache_resets"]) == (jmetrics["cache_compactions"],
                                                                       jmetrics["cache_resets"])
    if extra[:1] == ["--draft"]:
        assert metrics["spec_passes"] == jmetrics["spec_passes"] > 0


def test_serve_cli_arrival_clock_and_refusals(world, tmp_path):  # noqa: F811
    """An open-loop arrival rate gives the same rows; --model_parallel > 1 in
    one process raises, naming the torchrun it needs."""
    plain, timed = str(tmp_path / "plain.csv"), str(tmp_path / "timed.csv")
    serve.main(_serve_argv(world, plain) + ["--device", "cpu"])
    _, metrics = serve.main(_serve_argv(world, timed) + ["--arrival_rate", "50", "--device", "cpu"])
    assert _read(plain) == _read(timed)
    assert metrics["arrival_rate"] == 50.0
    with pytest.raises(ValueError, match="--model_parallel 2 runs one process a shard"):
        serve.main(_serve_argv(world, plain) + ["--model_parallel", "2", "--device", "cpu"])


QUESTION = "what is the camera wearer doing"


def _chat(chat, frames):
    """A video, then the question (one turn: a second would pass the tiny
    checkpoint's 128 positions, which the JAX model clamps silently)."""
    chat.prompts, chat.videos = [("", 1)], [frames]
    return chat


def test_demo_chat_modes_match_jax(world):  # noqa: F811
    jdemo = runpy.run_path(os.path.join(REPO, "demo", "eilev_demo.py"))
    frames = np.random.default_rng(0).integers(0, 256, size=(3, 8, 32, 32), dtype=np.uint8)
    ckpt = str(world / "checkpoint")
    replies = {}
    for mode in ("beam", "kv_reuse", "engine"):
        kw = {"kv_reuse": mode == "kv_reuse", "engine": mode == "engine"}
        ours = _chat(eilev_demo.EilevChat.load(ckpt, dtype_name="fp32", device="cpu", **kw), frames)
        ref = _chat(jdemo["EilevChat"](ckpt, dtype_name="fp32", **kw), frames)
        replies[mode] = ours.respond(QUESTION)
        assert replies[mode] == ref.respond(QUESTION), mode
        assert ours.prompts == ref.prompts
    assert replies["kv_reuse"] == replies["engine"]
    for kv_reuse in (False, True):
        chat = _chat(eilev_demo.EilevChat.load(ckpt, dtype_name="fp32", device="cpu", kv_reuse=kv_reuse), frames)
        assert "".join(chat.respond_stream(QUESTION)).strip() == replies["kv_reuse"]

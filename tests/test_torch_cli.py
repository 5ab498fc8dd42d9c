"""Port vs JAX: the three user CLIs on a tiny world, in process on the CPU.

The world: PNG frames written with imageio, the offline tokenizer of
``tests/util_tokenizer.py`` and the tiny checkpoint of ``tests/_torch_hf.py``
(written by the JAX package's exporter). Each port CLI runs through its
``main`` with ``--device cpu``; the reference is the JAX package's own CLI
under ``scripts/``, run in process on the same arguments:

- icl_eval: the F1 JSON (F1s and every prediction) equals the JAX CLI's in
  fp32; at the defaults (bf16) every left-padded row's scores are NaN in
  both, as in the original, and the argmax over such a row is JAX's;
- generate_narration_texts: the CSV equals the JAX CLI's, row for row;
- train_v2: 2 steps with finite losses; its ``--export_hf`` directory loads
  through both packages' ``load_model`` to the trainer's trainable tensors;
- ``StepTimer`` summaries equal JAX's; ``WandbLogger`` prints without wandb.
"""

import csv
import json
import os
import re
import runpy
import sys

import numpy as np
import pytest
import torch

from eilev_tpu.models import auto as jauto
from eilev_tpu.utils import StepTimer as JStepTimer
from eilev_tpu_torch.cli import generate_narration_texts, icl_eval, train_v2
from eilev_tpu_torch.models import auto, params_from_jax
from eilev_tpu_torch.training import partition_params
from eilev_tpu_torch.utils import StepTimer, WandbLogger, maybe_wandb

from ._torch_hf import write_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VERBS = ["take", "cut"]
NOUNS = ["knife", "onion"]


def _write_frames(frames_dir, n: int, n_frames: int, rng) -> list[dict]:
    import imageio.v3 as iio

    os.makedirs(frames_dir, exist_ok=True)
    rows = []
    for i in range(n):
        uid, fp = f"vid{i}", f"vid{i}|0"
        os.makedirs(os.path.join(frames_dir, fp))
        for t in range(n_frames):
            iio.imwrite(os.path.join(frames_dir, fp, f"{fp}|{t}.png"),
                        rng.integers(0, 255, (32, 32, 3)).astype(np.uint8), extension=".png")
        v, nn = VERBS[i % 2], NOUNS[i // 2 % 2]
        rows.append(dict(frame_path=fp, video_uid=uid, clip_index="0", narration_timestamp_sec="4.0",
                         narration_text=f"#C C does {v} {nn}", structured_verb=v, structured_noun=nn))
    with open(os.path.join(frames_dir, "narrated_actions.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return rows


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_world")
    rng = np.random.default_rng(0)
    rows = _write_frames(str(root / "frames"), 4, 2, rng)
    _write_frames(str(root / "train_frames"), 4, 4, rng)
    fho = {"videos": [{"video_uid": r["video_uid"], "annotated_intervals": [{"narrated_actions": [{
        "structured_verb": r["structured_verb"],
        "frames": [{"frame_type": "pnr_frame", "boxes": [
            {"object_type": "object_of_change", "structured_noun": r["structured_noun"]}]}],
    }]}]} for r in rows]}
    (root / "fho_main.json").write_text(json.dumps(fho))
    (root / "taxonomy.json").write_text(json.dumps({"verbs": VERBS, "nouns": NOUNS}))
    (root / "verb_prompts.csv").write_text("prompt,structured_verb\ntakes,take\ncuts,cut\n")
    (root / "noun_prompts.csv").write_text("prompt,structured_noun\na knife,knife\nan onion,onion\n")
    with open(root / "icl_map.jsonl", "w") as f:
        for q in range(4):
            f.write(json.dumps({"context": [rows[(q + 1) % 4]["frame_path"], rows[(q + 2) % 4]["frame_path"]],
                                "query": rows[q]["frame_path"]}) + "\n")
    write_checkpoint(str(root / "checkpoint"), seed=33, tokenizer=True)
    return root


def _run_jax_script(name: str, argv: list[str]) -> None:
    """The JAX package's own CLI, in this process."""
    old = sys.argv
    sys.argv = [name, *argv]
    try:
        runpy.run_path(os.path.join(REPO, "scripts", name), run_name="__main__")
    finally:
        sys.argv = old


def _icl_argv(world, out_json: str, dtype: str = "fp32") -> list[str]:
    argv = [
        "--model", str(world / "checkpoint"),
        "--fho_lta_taxonomy", str(world / "taxonomy.json"),
        "--fho_main", str(world / "fho_main.json"),
        "--structured_verb_prompt", str(world / "verb_prompts.csv"),
        "--structured_noun_prompt", str(world / "noun_prompts.csv"),
        "--train_narrated_actions_dir", str(world / "frames"),
        "--eval_narrated_actions_dir", str(world / "frames"),
        "--num_shot", "1", "--num_eval_datapoints", "3", "--class_batch_size", "2",
        "--output_json", out_json,
    ]
    return argv + (["--dtype", dtype] if dtype != "bf16" else [])


def test_icl_eval_cli_matches_jax(world, tmp_path):
    ours_json, ref_json = str(tmp_path / "ours.json"), str(tmp_path / "ref.json")
    icl_eval.main(_icl_argv(world, ours_json) + ["--device", "cpu"])
    _run_jax_script("icl_eval.py", _icl_argv(world, ref_json))
    ours, ref = json.load(open(ours_json)), json.load(open(ref_json))
    assert ours == ref
    assert len(ours["verb_predictions"]) == len(ours["noun_predictions"]) == 3
    assert all(p["predicted_verb_prompt"] in {"takes", "cuts"} for p in ours["verb_predictions"])


def _record_scores(monkeypatch, module, convert) -> list:
    """Wrap ``module.classify`` to keep every score matrix it returns (as
    numpy) beside the prompt attention mask it was given."""
    seen = []
    inner = module.classify

    def recording(model, *args, **kwargs):
        out = inner(model, *args, **kwargs)
        seen.append((convert(out), convert(kwargs["prompt_attention_mask"])))
        return out

    monkeypatch.setattr(module, "classify", recording)
    return seen


def test_icl_eval_cli_bf16_nan_rows_match_jax(world, tmp_path, monkeypatch):
    """bf16 at the CLI's defaults: every left-padded row scores NaN on every
    class in both packages (the original's behaviour, kept: the prompt cache
    holds NaN k/v at padded slots), so the prediction is numpy's argmax of
    an all-NaN row, the first class, as in JAX; the JSONs are equal."""
    import eilev_tpu.eval.icl as jicl
    import eilev_tpu_torch.eval.icl as ticl

    ours_seen = _record_scores(monkeypatch, ticl, lambda t: t.float().cpu().numpy())
    ref_seen = _record_scores(monkeypatch, jicl, lambda a: np.asarray(a, np.float32))
    ours_json, ref_json = str(tmp_path / "ours.json"), str(tmp_path / "ref.json")
    icl_eval.main(_icl_argv(world, ours_json, dtype="bf16") + ["--device", "cpu"])
    _run_jax_script("icl_eval.py", _icl_argv(world, ref_json, dtype="bf16"))
    assert len(ours_seen) == len(ref_seen) == 2  # the verb and noun stage of one batch of 3
    padded_rows = 0
    for (scores, mask), (ref_scores, ref_mask) in zip(ours_seen, ref_seen):
        np.testing.assert_array_equal(mask, ref_mask)
        padded = mask[:, 0] == 0
        padded_rows += int(padded.sum())
        np.testing.assert_array_equal(np.isnan(scores), np.isnan(ref_scores))
        assert np.isnan(scores[padded]).all()
        assert (scores.argmax(-1) == ref_scores.argmax(-1)).all()
    assert padded_rows > 0
    assert json.load(open(ours_json)) == json.load(open(ref_json))


def _narration_argv(world, out_csv: str) -> list[str]:
    return [
        "--model", str(world / "checkpoint"), "--dtype", "fp32",
        "--eval_frames_dir", str(world / "frames"),
        "--in_context_query_map_file", str(world / "icl_map.jsonl"),
        "--in_context_example_frames_dir", str(world / "frames"),
        "--batch_size", "2", "--num_eval_datapoints", "3",
        "--generation_config", '{"max_new_tokens": 4}',
        "--output_csv", out_csv,
    ]


@pytest.mark.parametrize("vision_cache", [0, 8])
def test_generate_narration_texts_cli_matches_jax(world, tmp_path, vision_cache):
    ours_csv, ref_csv = str(tmp_path / "ours.csv"), str(tmp_path / "ref.csv")
    extra = ["--vision_cache", str(vision_cache)] if vision_cache else []
    rows = generate_narration_texts.main(_narration_argv(world, ours_csv) + extra + ["--device", "cpu"])
    _run_jax_script("generate_narration_texts.py", _narration_argv(world, ref_csv))
    ours, ref = list(csv.DictReader(open(ours_csv))), list(csv.DictReader(open(ref_csv)))
    assert ours == ref and len(ours) == 3 == len(rows)
    assert any(r["generated"] for r in ours)


@pytest.mark.parametrize("draft", [["--draft", "prompt_lookup"], ["--draft_layers", "1"]],
                         ids=["prompt_lookup", "draft_layers"])
def test_generate_narration_texts_cli_speculative_matches_greedy(world, tmp_path, draft):
    """--draft prompt_lookup and --draft_layers 1: the plain greedy CSV, and
    the JAX CLI's with the same flags."""
    plain, ours, ref = (str(tmp_path / f"{n}.csv") for n in ("plain", "ours", "ref"))
    generate_narration_texts.main(_narration_argv(world, plain) + ["--device", "cpu"])
    generate_narration_texts.main(_narration_argv(world, ours) + draft + ["--device", "cpu"])
    _run_jax_script("generate_narration_texts.py", _narration_argv(world, ref) + draft)
    rows = [list(csv.DictReader(open(f))) for f in (plain, ours, ref)]
    assert rows[1] == rows[0] == rows[2] and len(rows[1]) == 3


def test_cli_unported_modes_raise():
    # --draft/--draft_layers are ported
    # (test_generate_narration_texts_cli_speculative_matches_greedy);
    # --model_parallel runs one process a shard under torchrun
    # (tests/test_torch_parallel_tp_generate.py), so one process asking for 2 raises
    base = ["--model", "m", "--eval_frames_dir", "e", "--in_context_query_map_file", "q",
            "--in_context_example_frames_dir", "c", "--output_csv", "o", "--device", "cpu"]
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        generate_narration_texts.main(base + ["--model_parallel", "2"])
    # train_v2's --multihost, --data_parallel, --pipeline_parallel and
    # --zero_shard_opt_state run (tests/test_torch_parallel_cli.py), and
    # --model_parallel under torchrun (tests/test_torch_parallel_tp_train.py),
    # so one process asking for 2 raises
    train = ["--model_name_or_path", "m", "--train_frames_dir", "t", "--val_frames_dir", "v",
             "--output_dir", "o", "--device", "cpu"]
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        train_v2.main(train + ["--model_parallel", "2"])
    with pytest.raises(ValueError, match="exclusive"):
        train_v2.main(train + ["--model_parallel", "2", "--pipeline_parallel", "2"])


def test_train_v2_cli_exports_what_it_trained(world, tmp_path, capsys):
    out = str(tmp_path / "train_out")
    trainer = train_v2.main([
        "--model_name_or_path", str(world / "checkpoint"), "--dtype", "fp32", "--device", "cpu",
        "--train_frames_dir", str(world / "train_frames"), "--val_frames_dir", str(world / "train_frames"),
        "--train_num_in_context_examples_per_sample", "1", "--val_num_in_context_examples_per_sample", "1",
        "--num_subsample_frames", "2", "--max_length", "64", "--output_dir", out,
        "--num_train_steps", "2", "--per_device_train_batch_size", "1", "--gradient_accumulation_steps", "2",
        "--learning_rate", "1e-3", "--warmup_steps", "0", "--eval_steps", "2", "--save_steps", "2",
        "--logging_steps", "1", "--data_parallel", "1", "--export_hf",
    ])
    assert trainer.state.step == 2
    losses = [float(x) for x in re.findall(r"'loss': ([-0-9.e+naninf]+)", capsys.readouterr().out)]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert [d for d in os.listdir(out) if d.isdigit()] == ["2"]
    trained, _ = partition_params(dict(trainer.model.named_parameters()))
    hf_dir = os.path.join(out, "hf")
    assert sorted(os.listdir(hf_dir)) == ["config.json", "model.safetensors"]
    model, cfg = auto.load_model(hf_dir, device="cpu")
    _, jvars, _ = jauto.load_model(hf_dir)
    for loaded in (model.state_dict(), params_from_jax(jvars["params"], cfg)):
        for k, p in trained.items():
            assert torch.equal(loaded[k], p.detach()), k
    # the frozen towers went out as they came in
    source, _ = auto.load_model(str(world / "checkpoint"), device="cpu")
    frozen = {k: v for k, v in source.state_dict().items() if k not in trained}
    assert all(torch.equal(model.state_dict()[k], v) for k, v in frozen.items())
    assert not all(torch.equal(source.state_dict()[k], p.detach()) for k, p in trained.items())


def test_step_timer_and_logger_match_jax(capsys):
    times = [0.5, 0.125, 2.0, 0.25, 1.0, 0.75, 3.0]
    ours, ref = StepTimer(), JStepTimer()
    for t in (ours, ref):
        assert np.isnan(t.p50()) and t.summary()["n"] == 0
        t.times.extend(times)
    assert ours.summary() == ref.summary() == {"p50_sec": 0.75, "p90_sec": ref.p90(), "mean_sec": ref.mean(), "n": 7}
    with ours.measure():
        pass
    assert len(ours.times) == 8 and ours.times[-1] >= 0
    assert maybe_wandb() is None  # not installed here: the logger prints
    logger = WandbLogger(project="p")
    logger(3, {"loss": 0.123456789, "step_time_sec": 2})
    logger.log_table("t", ["a", "b"], [[1, 2]])
    printed = capsys.readouterr().out
    assert "[step 3] {'loss': 0.12346, 'step_time_sec': 2}" in printed and "[table t] ['a', 'b']" in printed

"""Port vs JAX: the evaluation CLIs of the port, each through its ``main``
with ``--device cpu``, against the JAX package's script run in process on
the same arguments (``runpy``), on the world of ``tests/test_torch_cli.py``
(PNG frames, the offline tokenizer, the tiny checkpoint of
``tests/_torch_hf.py``):

- generation_eval: equal metric JSON (with the STS bi-encoder on a tiny
  MPNet checkpoint, within 1e-5);
- sample_in_context_examples: equal JSONL;
- verify_quality --generated_csv: equal PASS/FAIL lines, JSON and exit
  code; its full mode runs the port's own CLIs in process (no subprocess);
- get_vision_model_embs: equal ``_embs.npy`` (1e-5) and ``_index.json``;
- train_v1: 2 steps, finite losses and the eval loss equal to JAX's in fp32
  (the Q-Former's dropout off in both packages' TrainerConfig).
"""

import contextlib
import csv
import functools
import io
import json
import subprocess

import numpy as np
import pytest

import eilev_tpu_torch.training.trainer as ttrainer
import eilev_tpu_torch.utils as tutils
from eilev_tpu_torch.cli import (
    generation_eval,
    get_vision_model_embs,
    sample_in_context_examples,
    train_v1,
    verify_quality,
)

from ._torch_hf import hf_config, write_checkpoint
from .test_torch_cli import _run_jax_script, world  # noqa: F401  (the module-scoped world fixture)
from .test_torch_encoder import _write_checkpoint


def _narrations_csv(path, n: int = 4, same: bool = False) -> str:
    rng = np.random.default_rng(0)
    words = ["the", "camera", "wearer", "cuts", "an", "onion", "opens", "drawer", "knife"]
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, ["frame_path", "generated", "ground_truth"])
        w.writeheader()
        for i in range(n):
            truth = "The camera wearer " + " ".join(rng.choice(words, 4))
            w.writerow({"frame_path": f"vid{i}|0", "ground_truth": truth,
                        "generated": truth if same else "The camera wearer " + " ".join(rng.choice(words, 5))})
    return str(path)


def _run_both(capsys, port_main, script: str, argv: list, port_extra=("--device", "cpu")):
    """(port stdout, JAX stdout, port exit code, JAX exit code); a
    ``SystemExit`` gives its code, a normal return 0."""
    out = []
    for run in (lambda: port_main(argv + list(port_extra)), lambda: _run_jax_script(script, argv)):
        try:
            run()
            code = 0
        except SystemExit as e:
            code = e.code
        out.append((capsys.readouterr().out, code))
    return out[0][0], out[1][0], out[0][1], out[1][1]


def test_generation_eval_matches_jax(tmp_path, capsys):
    mpnet = str(tmp_path / "mpnet")
    _write_checkpoint(mpnet, "mpnet", seed=31)
    gen_csv = _narrations_csv(tmp_path / "gen.csv")
    ours, ref = str(tmp_path / "ours.json"), str(tmp_path / "ref.json")
    common = ["--input_csv", gen_csv, "--sts_biencoder_model", mpnet]
    generation_eval.main(common + ["--output_json", ours, "--device", "cpu"])
    _run_jax_script("generation_eval.py", common + ["--output_json", ref])
    ours, ref = json.load(open(ours)), json.load(open(ref))
    assert ours.keys() == ref.keys() == {"bleu", "rougeL", "sts_biencoder"}
    assert ours["bleu"] == ref["bleu"] and ours["rougeL"] == ref["rougeL"] and ref["rougeL"] > 0
    assert ours["sts_biencoder"] == pytest.approx(ref["sts_biencoder"], abs=1e-5)
    # BLEU and ROUGE-L alone: the same JSON, byte for byte
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    generation_eval.main(["--input_csv", gen_csv, "--output_json", a, "--device", "cpu"])
    _run_jax_script("generation_eval.py", ["--input_csv", gen_csv, "--output_json", b])
    assert open(a).read() == open(b).read()


def test_sample_in_context_examples_matches_jax(world, tmp_path, capsys):  # noqa: F811
    argv = ["--in_context_frames_dir", str(world / "train_frames"), "--eval_frames_dir", str(world / "frames"),
            "--num_shot", "2", "--verb_noun_ratio", "0.5", "--random_seed", "7"]
    ours = sample_in_context_examples.main(argv + ["--output_prefix", str(tmp_path / "ours")])
    _run_jax_script("sample_in_context_examples.py", argv + ["--output_prefix", str(tmp_path / "ref")])
    lines = open(ours).read().splitlines()
    assert lines == open(tmp_path / "ref-2-shot.jsonl").read().splitlines()
    assert len(lines) == 4 and all(len(json.loads(x)["context"]) == 2 for x in lines)


@pytest.mark.parametrize("tolerance,code", [("0.02", 1), ("1.0", 0)])
def test_verify_quality_mocked_mode_matches_jax(tmp_path, capsys, tolerance, code):
    csvs = [f"0={_narrations_csv(tmp_path / 'gen0.csv')}", f"16={_narrations_csv(tmp_path / 'gen16.csv', same=True)}"]
    argv = ["--generated_csv", *csvs, "--tolerance", tolerance]
    ours_out, ref_out, ours_code, ref_code = _run_both(
        capsys, verify_quality.main, "verify_quality.py", argv + ["--output_json", str(tmp_path / "q.json")])
    assert ours_code == ref_code == code
    assert ours_out == ref_out
    assert "[skip] 16-shot sts_biencoder" in ours_out and ("FAIL" in ours_out) == (code == 1)
    ours_json = json.load(open(tmp_path / "q.json"))
    _run_jax_script_quiet = functools.partial(_run_jax_script, "verify_quality.py")
    with contextlib.suppress(SystemExit):
        _run_jax_script_quiet(argv + ["--output_json", str(tmp_path / "r.json")])
    assert ours_json == json.load(open(tmp_path / "r.json"))


def test_verify_quality_full_mode_runs_in_process(world, tmp_path, monkeypatch):  # noqa: F811
    """sample -> generate -> score -> diff through the port's own CLIs, in this
    process: no subprocess, no script under scripts/."""
    def refuse(*args, **kwargs):
        raise AssertionError(f"subprocess started: {args}")

    # the generation CLI's default of 512 new tokens needs positions past 128
    ckpt = str(tmp_path / "checkpoint")
    write_checkpoint(ckpt, hf_config(max_position_embeddings=640), seed=33, tokenizer=True)
    monkeypatch.setattr(subprocess, "run", refuse)
    out_json = str(tmp_path / "quality.json")
    result = verify_quality.main([
        "--model", ckpt, "--dtype", "fp32", "--device", "cpu",
        "--eval_frames_dir", str(world / "frames"), "--in_context_frames_dir", str(world / "frames"),
        "--num_shots", "1", "--num_eval_datapoints", "2", "--batch_size", "2", "--tolerance", "1.0",
        "--output_json", out_json, "--work_dir", str(tmp_path / "work"),
    ])
    assert result["failures"] == []
    rows = list(csv.DictReader(open(tmp_path / "work" / "generated-1shot.csv")))
    assert len(rows) == 2
    written = json.load(open(out_json))
    assert written["results"]["1"]["rougeL"] == result["results"]["1"]["rougeL"]
    # the generated CSV scored as generation_eval scores it
    metrics = generation_eval.main(["--input_csv", str(tmp_path / "work" / "generated-1shot.csv"),
                                    "--device", "cpu"])
    assert metrics == written["results"]["1"]


def test_get_vision_model_embs_matches_jax(world, tmp_path, capsys):  # noqa: F811
    argv = ["--model", str(world / "checkpoint"), "--dtype", "fp32", "--frames_dir", str(world / "frames"),
            "--batch_size", "3", "--num_subsample_frames", "2"]
    embs = get_vision_model_embs.main(argv + ["--output_prefix", str(tmp_path / "ours"), "--device", "cpu"])
    _run_jax_script("get_vision_model_embs.py", argv + ["--output_prefix", str(tmp_path / "ref")])
    ref = np.load(tmp_path / "ref_embs.npy")
    ours = np.load(tmp_path / "ours_embs.npy")
    assert ours.shape == ref.shape == embs.shape == (4, 16) and ours.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-5)
    assert json.load(open(tmp_path / "ours_index.json")) == json.load(open(tmp_path / "ref_index.json")) == [
        f"vid{i}|0" for i in range(4)]


class _Recorder:
    """The port Trainer's logger: keeps every (step, metrics)."""

    calls: list = []

    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, step, metrics):
        type(self).calls.append((step, dict(metrics)))


def _jax_v1_reference(ckpt: str, train_dir: str, val_dir: str, steps: int, lr: float) -> list:
    """What JAX's train_v1 computes without dropout, step by step: the v1
    module's loss and its gradient (``jax.value_and_grad``), JAX's AdamW
    (``make_optimizer``), JAX's batches (``train_batch_iterator``, not
    interleaved, the Trainer's seed), then the eval loss. (JAX's own script
    cannot run: its train step passes ``deterministic`` to the v1 module,
    which takes none.)"""
    import jax
    import jax.numpy as jnp
    import optax

    from eilev_tpu.data.frame import FrameDataset
    from eilev_tpu.models.auto import load_model, load_tokenizer
    from eilev_tpu.training.data_module import train_batch_iterator
    from eilev_tpu.training.train_state import (
        OptimizerConfig, eval_step, make_optimizer, merge_params, partition_params)

    model, variables, cfg = load_model(ckpt, version="v1", dtype=jnp.float32)
    tok = load_tokenizer(ckpt)
    trainable, frozen = partition_params(variables["params"])
    tx = make_optimizer(OptimizerConfig(learning_rate=lr, warmup_steps=0, total_steps=steps, weight_decay=0.05))
    opt = tx.init(trainable)

    def batches(data_dir, seed, epochs):
        return train_batch_iterator(
            FrameDataset(data_dir), tok, num_query_tokens=cfg.num_query_tokens, decoder_only_lm=True,
            accum_steps=1, micro_batch_size=2, max_length=48, num_frames=2,
            image_size=cfg.vision_config.image_size, augment=False, seed=seed, epochs=epochs,
            dtype=jnp.float32, interleaved=False)

    def loss_fn(t, micro):
        return model.apply({"params": merge_params(t, frozen)}, **micro)["loss"]

    @jax.jit
    def step_fn(trainable, opt, micro):
        loss, grads = jax.value_and_grad(loss_fn)(trainable, micro)
        updates, opt = tx.update(grads, opt, trainable)
        return optax.apply_updates(trainable, updates), opt, loss, optax.global_norm(grads)

    log = []
    it = batches(train_dir, 42, None)
    for step in range(1, steps + 1):
        micro = {k: jnp.asarray(v[0]) for k, v in next(it).items()}
        trainable, opt, loss, grad_norm = step_fn(trainable, opt, micro)
        log.append((step, {"loss": float(loss), "grad_norm": float(grad_norm)}))
    params = merge_params(trainable, frozen)
    evaluate = jax.jit(functools.partial(eval_step, model))
    evals = [float(evaluate(params, {k: jnp.asarray(v[0]) for k, v in b.items()})) for b in batches(val_dir, 0, 1)]
    log.append((steps, {"eval_loss": float(np.mean(evals))}))
    return log


def test_train_v1_matches_jax(world, tmp_path, monkeypatch):  # noqa: F811
    # the Q-Former's dropout off (JAX's v1 module has none), so the run is deterministic
    monkeypatch.setattr(ttrainer, "TrainerConfig", functools.partial(ttrainer.TrainerConfig, dropout=False))
    monkeypatch.setattr(tutils, "WandbLogger", _Recorder)
    _Recorder.calls = []
    trainer = train_v1.main([
        "--model_name_or_path", str(world / "checkpoint"), "--dtype", "fp32", "--device", "cpu",
        "--train_frames_dir", str(world / "train_frames"), "--val_frames_dir", str(world / "frames"),
        "--num_subsample_frames", "2", "--max_length", "48", "--num_train_steps", "2",
        "--per_device_train_batch_size", "2", "--gradient_accumulation_steps", "1", "--learning_rate", "1e-3",
        "--warmup_steps", "0", "--eval_steps", "2", "--save_steps", "2", "--logging_steps", "1",
        "--output_dir", str(tmp_path / "out")])
    assert trainer.state.step == 2
    ours = [(s, {k: v for k, v in m.items() if k in ("loss", "grad_norm", "eval_loss")}) for s, m in _Recorder.calls]
    ref = _jax_v1_reference(str(world / "checkpoint"), str(world / "train_frames"), str(world / "frames"), 2, 1e-3)
    assert [s for s, _ in ours] == [s for s, _ in ref] == [1, 2, 2]  # two steps, then the eval
    for (_, a), (_, b) in zip(ours, ref):
        assert a.keys() == b.keys()
        for key in b:
            assert np.isfinite(a[key]) and a[key] == pytest.approx(b[key], abs=1e-5, rel=1e-5), key


def test_train_v1_refuses_data_parallel():
    argv = ["--model_name_or_path", "m", "--train_frames_dir", "t", "--val_frames_dir", "v", "--output_dir", "o",
            "--device", "cpu", "--data_parallel", "2"]
    with pytest.raises(NotImplementedError, match="parallel/"):
        train_v1.main(argv)


def test_generation_eval_prints_the_metrics(tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        metrics = generation_eval.main(["--input_csv", _narrations_csv(tmp_path / "g.csv", same=True),
                                        "--device", "cpu"])
    assert json.loads(buf.getvalue().split("\n[step")[0]) == metrics and metrics["rougeL"] == 1.0

"""Port vs JAX: the baselines (cli/baselines/), each through its ``main`` or
``run`` with ``--device cpu``, against the JAX package's script run in
process (``runpy``) on the same arguments, on the frames of
``tests/test_torch_cli.py``'s world:

- videomae_train at the tiny VideoMAE config (32^2, 4 frames, width 24, 2
  layers), 2 steps from the first parameters JAX's script initialised
  (recorded), with the augmentation's draws taken out of the compared run in
  both packages (short-side scale, crop and flip made the identity): losses
  and the trained ``params.pkl`` equal to JAX's in fp32; the port's own
  augmentation gives finite losses and the same run for the same seed;
- the ``params.pkl`` round trip: JAX's videomae_predict reads a classifier
  the port trained and the port's reads one JAX trained, and their CSVs and
  F1 lines are equal;
- videomae_generate_full_sent / majority_generate_full_sent over the tiny
  OPT ``TextLM`` checkpoint of ``tests/test_torch_text_lm.py`` at 512
  positions (fp32 in both): equal CSVs;
- majority_predict with a stub ``spacy`` in ``sys.modules`` for both: equal
  CSVs; without spaCy both raise ``SystemExit``.
"""

import csv
import functools
import os
import pickle
import re
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eilev_tpu.generation.text_lm as jtext_lm
import eilev_tpu.ops.preprocess as jpp
import eilev_tpu_torch.generation.text_lm as ttext_lm
import eilev_tpu_torch.ops.preprocess as tpp
from eilev_tpu.models import videomae as jvm
from eilev_tpu_torch.cli.baselines import (
    majority_generate_full_sent,
    majority_predict,
    videomae_generate_full_sent,
    videomae_predict,
    videomae_train,
)

from .test_torch_cli import _run_jax_script, world  # noqa: F401  (the module-scoped world fixture)
from .util_tokenizer import build_tiny_tokenizer

TINY_ARGS = ["--num_frames", "4", "--image_size", "32", "--hidden_size", "24", "--num_hidden_layers", "2",
             "--num_attention_heads", "2"]


def _jax_baseline(name: str, argv: list) -> None:
    _run_jax_script(os.path.join("baselines", name), argv)


def _train_argv(world, out, verb: bool = True) -> list:  # noqa: F811
    return ["--train_frames_dir", str(world / "train_frames"), "--val_frames_dir", str(world / "frames"),
            "--output_dir", str(out), "--num_train_steps", "2", "--batch_size", "2", "--learning_rate", "1e-3",
            "--warmup_steps", "0", "--eval_steps", "2", "--logging_steps", "1", "--seed", "3",
            *TINY_ARGS, *(["--verb"] if verb else [])]


def _no_augmentation_draws(monkeypatch) -> None:
    """Short-side scale, crop and flip as the identity (a 32^2 crop of 32^2
    frames) in both packages."""
    for pp in (jpp, tpp):
        monkeypatch.setattr(pp, "random_short_side_scale", lambda key, x, lo, hi: x)
        monkeypatch.setattr(pp, "random_crop", lambda key, x, h, w: x[..., :h, :w])
        monkeypatch.setattr(pp, "random_horizontal_flip", lambda key, x: x)


@pytest.fixture(scope="module")
def trained(world, tmp_path_factory):  # noqa: F811
    """JAX's and the port's verb classifiers from the same first parameters
    (augmentation draws out), and the port's noun classifier with its own
    augmentation. Returns their dirs, JAX's printed log and the port's
    results."""
    root = tmp_path_factory.mktemp("videomae")
    mp = pytest.MonkeyPatch()
    first = []
    inner = jvm.VideoMAEForVideoClassification.init

    def recording_init(self, *args, **kwargs):
        out = inner(self, *args, **kwargs)
        first.append(jax.tree.map(np.asarray, out["params"]))
        return out

    from contextlib import redirect_stdout
    from io import StringIO

    try:
        _no_augmentation_draws(mp)
        mp.setattr(jvm.VideoMAEForVideoClassification, "init", recording_init)
        buf = StringIO()
        with redirect_stdout(buf):
            _jax_baseline("videomae_train.py", _train_argv(world, root / "jax_verb"))
        mp.setattr(jvm.VideoMAEForVideoClassification, "init", inner)
        args = videomae_train.parse_args(_train_argv(world, root / "port_verb") + ["--device", "cpu"])
        ours = videomae_train.run(args, videomae_train.load_datasets(args), init_params=first[0])
    finally:
        mp.undo()
    noun_args = videomae_train.parse_args(_train_argv(world, root / "port_noun", verb=False) + ["--device", "cpu"])
    noun = videomae_train.run(noun_args, videomae_train.load_datasets(noun_args))
    return {"root": root, "jax_log": buf.getvalue(), "ours": ours, "noun": noun, "first": first[0]}


def _pkl(path):
    with open(os.path.join(path, "params.pkl"), "rb") as f:
        return pickle.load(f)


def test_videomae_train_matches_jax(trained):
    root, ours = trained["root"], trained["ours"]
    jax_losses = [float(x) for x in re.findall(r"step \d+: loss ([-0-9.]+)", trained["jax_log"])]
    assert len(jax_losses) == len(ours["losses"]) == 2
    np.testing.assert_allclose(ours["losses"], jax_losses, atol=6e-5)  # JAX prints 4 decimals
    jf1 = re.findall(r"val macro F1 ([0-9.]+)", trained["jax_log"])
    assert len(jf1) == 1
    ref, got = _pkl(root / "jax_verb"), _pkl(root / "port_verb")
    flat_ref, flat_got = jax.tree_util.tree_flatten_with_path(ref)[0], jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_ref] == [p for p, _ in flat_got]
    for (path, a), (_, b) in zip(flat_ref, flat_got):
        assert b.dtype == np.float32 and b.shape == a.shape
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=1e-5, err_msg=jax.tree_util.keystr(path))
    # the two steps moved the parameters
    first = jax.tree_util.tree_leaves(trained["first"])
    assert any(not np.array_equal(a, b) for a, b in zip(first, jax.tree_util.tree_leaves(got)))
    with open(root / "jax_verb" / "labels.json") as f, open(root / "port_verb" / "labels.json") as g:
        assert f.read() == g.read()


def test_videomae_train_augmented_is_seeded(trained, world, tmp_path):  # noqa: F811
    losses = trained["noun"]["losses"]
    assert len(losses) == 2 and np.isfinite(losses).all()
    args = videomae_train.parse_args(_train_argv(world, tmp_path / "again", verb=False) + ["--device", "cpu"])
    again = videomae_train.run(args, videomae_train.load_datasets(args))
    assert again["losses"] == losses


def test_videomae_predict_reads_both_packages_classifiers(trained, world, tmp_path, capsys):  # noqa: F811
    root = trained["root"]
    argv = ["--verb_classifier", str(root / "jax_verb"), "--noun_classifier", str(root / "port_noun"),
            "--frames_dir", str(world / "frames"), "--batch_size", "3", "--print_predictions"]
    capsys.readouterr()
    rows = videomae_predict.main(argv + ["--output_csv", str(tmp_path / "ours.csv"), "--device", "cpu"])
    ours_out = capsys.readouterr().out
    _jax_baseline("videomae_predict.py", argv + ["--output_csv", str(tmp_path / "ref.csv")])
    ref_out = capsys.readouterr().out
    ours, ref = (list(csv.DictReader(open(tmp_path / f"{n}.csv"))) for n in ("ours", "ref"))
    assert ours == ref and len(ours) == len(rows) == 4
    assert ours_out.replace("ours.csv", "X") == ref_out.replace("ref.csv", "X")
    assert "verb F1:" in ours_out


@pytest.fixture(scope="module")
def opt_checkpoint(tmp_path_factory):
    """The tiny OPT TextLM checkpoint of tests/test_torch_text_lm.py with 512
    positions: the sentence-ifier's few-shot prompt and its 64 new tokens."""
    from transformers import OPTConfig as HFOPTConfig, OPTForCausalLM

    d = str(tmp_path_factory.mktemp("opt_ckpt"))
    cfg = HFOPTConfig(vocab_size=384, hidden_size=16, num_hidden_layers=2, num_attention_heads=2, ffn_dim=32,
                      max_position_embeddings=512, word_embed_proj_dim=16, dropout=0.0, attention_dropout=0.0)
    torch.manual_seed(0)
    OPTForCausalLM(cfg).eval().save_pretrained(d, safe_serialization=True)
    build_tiny_tokenizer(d, vocab_size=384)
    return d


def _predictions_csv(path) -> str:
    rows = [("cut_(chop)", "onion"), ("take", "knife_(tool)"), ("", ""), ("wash", "plate")]
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, ["frame_path", "predicted_verb", "predicted_noun", "ground_truth_narration_text"])
        w.writeheader()
        for i, (v, n) in enumerate(rows):
            w.writerow({"frame_path": f"vid{i}|0", "predicted_verb": v, "predicted_noun": n,
                        "ground_truth_narration_text": f"#C C does {i}"})
    return str(path)


@pytest.mark.parametrize("module,script", [(videomae_generate_full_sent, "videomae_generate_full_sent.py"),
                                           (majority_generate_full_sent, "majority_generate_full_sent.py")])
def test_generate_full_sent_matches_jax(opt_checkpoint, tmp_path, monkeypatch, module, script):  # noqa: F811
    # fp32 in both packages (the scripts' TextLM computes in bf16 by default)
    monkeypatch.setattr(jtext_lm, "TextLM", functools.partial(jtext_lm.TextLM, dtype=jnp.float32))
    monkeypatch.setattr(ttext_lm, "TextLM", functools.partial(ttext_lm.TextLM, dtype=torch.float32))
    argv = ["--model", opt_checkpoint, "--predictions_csv", _predictions_csv(tmp_path / "pred.csv"),
            "--batch_size", "3"]
    rows = module.main(argv + ["--output_csv", str(tmp_path / "ours.csv"), "--device", "cpu"])
    _jax_baseline(script, argv + ["--output_csv", str(tmp_path / "ref.csv")])
    ours, ref = (list(csv.DictReader(open(tmp_path / f"{n}.csv"))) for n in ("ours", "ref"))
    assert ours == ref and len(ours) == len(rows) == 4
    assert all(r["generated"].endswith(".") and r["ground_truth"].startswith("#C C") for r in ours)


class _Token:
    def __init__(self, text, dep, children=()):
        self.lemma_, self.dep_, self.children = text.lower(), dep, list(children)


def _stub_spacy() -> types.ModuleType:
    """A spaCy stand-in: the first word of a narration is its ROOT verb and
    the last its dobj noun."""
    def parse(text):
        words = text.rstrip(".").split()
        obj = _Token(words[-1], "dobj")
        return [_Token(words[0], "ROOT", [obj]), obj] if len(words) > 1 else [_Token(words[0], "ROOT")]

    nlp = types.SimpleNamespace(pipe=lambda texts, disable=(): [parse(t) for t in texts])
    return types.SimpleNamespace(load=lambda name: nlp)


def test_majority_predict_matches_jax(world, tmp_path, monkeypatch):  # noqa: F811
    argv = ["--eval_frames_dir", str(world / "frames"), "--in_context_query_map_file", str(world / "icl_map.jsonl"),
            "--in_context_example_frames_dir", str(world / "frames"), "--print_predictions"]
    monkeypatch.setitem(sys.modules, "spacy", _stub_spacy())
    rows = majority_predict.main(argv + ["--output_csv", str(tmp_path / "ours.csv")])
    _jax_baseline("majority_predict.py", argv + ["--output_csv", str(tmp_path / "ref.csv")])
    ours, ref = (list(csv.DictReader(open(tmp_path / f"{n}.csv"))) for n in ("ours", "ref"))
    assert ours == ref and len(ours) == len(rows) == 4
    assert all(r["predicted_verb"] and r["predicted_noun"] for r in ours)
    # without spaCy both refuse the same way
    monkeypatch.setitem(sys.modules, "spacy", None)
    for run in (lambda: majority_predict.main(argv + ["--output_csv", str(tmp_path / "x.csv")]),
                lambda: _jax_baseline("majority_predict.py", argv + ["--output_csv", str(tmp_path / "y.csv")])):
        with pytest.raises(SystemExit, match="spaCy model unavailable"):
            run()

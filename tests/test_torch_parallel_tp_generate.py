"""Tensor-parallel inference (``tp=`` models, ``parallel/tensor.py``) against
the JAX package's ``generate`` and ``classify``, at tests/parallel/test_tp_generate.py's
``tiny_config(hidden=32, heads=4)`` (here with an odd vocabulary of 61, so
the vocab blocks are uneven), fp32, tp 2.

One ``torch.multiprocessing.spawn`` of 2 gloo ranks (tests/_torch_tp_worker.py)
runs every case; the JAX references are computed meanwhile in this process:

- OPT greedy, OPT beam-3, T5 greedy and OPT with an int8 KV cache (K4's twin
  on the local heads) are token-identical to ``eilev_tpu.generation.generate``,
  on both ranks;
- ``classify`` (OPT and T5; vocab-parallel log-likelihoods) is within 2e-5 of
  ``eilev_tpu.generation.classify.classify``;
- the ranks hold the same tokens and scores;
- ``generate_narration_texts`` and ``icl_eval`` with ``--model_parallel 2``
  (on tests/test_torch_cli.py's world) write the same CSV and JSON as with
  ``--model_parallel 1``.
"""

import csv
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eilev_tpu import configs
from eilev_tpu.generation import GenerationConfig as JGenerationConfig
from eilev_tpu.generation import generate as jgenerate
from eilev_tpu.generation.classify import classify as jclassify
from eilev_tpu.models.video_blip import VideoBlipForConditionalGeneration as JVB
from eilev_tpu_torch import configs as tconfigs
from eilev_tpu_torch.cli import generate_narration_texts, icl_eval

from . import _torch_tp_worker as worker
from ._torch_port import random_params
from .test_torch_cli import _icl_argv, _narration_argv, world  # noqa: F401  (the module-scoped world fixture)

VOCAB = 61
GENERATE_CASES = [("opt", 1), ("opt", 3), ("opt_int8_kv", 1), ("t5", 1)]


def _config(mod, name):
    cfg = mod.tiny_config(text_model="t5" if name == "t5" else "opt", hidden=32, heads=4, vocab_size=VOCAB)
    if name == "opt_int8_kv":
        cfg = dataclasses.replace(cfg, text_config=dataclasses.replace(cfg.text_config, int8_kv_cache=True))
    return cfg


def _inputs(cfg):
    """test_tp_generate.py's batch (4 rows, one 2-frame video each, 16
    tokens), one row left-padded; 6 classes of 3 tokens."""
    rng = np.random.default_rng(0)
    b, t, s, img = 4, 2, 16, cfg.vision_config.image_size
    mask = np.ones((b, s), np.int64)
    mask[1, :2] = 0
    vim = np.zeros((b, s), np.int64)
    vim[:, 3:3 + cfg.num_query_tokens] = 1
    return {"pixel_values": rng.normal(size=(b, 3, t, img, img)).astype(np.float32),
            "input_ids": rng.integers(4, VOCAB, size=(b, s)).astype(np.int64), "attention_mask": mask,
            "video_input_mask": vim, "class_ids": np.random.default_rng(1).integers(4, VOCAB, size=(6, 3))}


@pytest.fixture(scope="module")
def ranks(world, tmp_path_factory):  # noqa: F811
    """Spawn the ranks, then compute JAX's tokens and scores and the CLIs'
    one-process outputs; (rank results, references, output paths)."""
    out_dir = tmp_path_factory.mktemp("tp_generate")
    models, jmodels = {}, {}
    inputs = _inputs(_config(configs, "opt"))
    for seed, name in enumerate(("opt", "opt_int8_kv", "t5")):
        jmodel = JVB(_config(configs, name))
        params = random_params(jmodel, seed, input_ids=jnp.asarray(inputs["input_ids"]),
                               pixel_values=jnp.asarray(inputs["pixel_values"]),
                               video_input_mask=jnp.asarray(inputs["video_input_mask"]),
                               labels=jnp.asarray(inputs["input_ids"]))
        jmodels[name] = (jmodel, params)
        models[name] = (_config(tconfigs, name), jax.tree.map(np.asarray, params))
    paths = {"csv": str(out_dir / "tp.csv"), "json": str(out_dir / "tp.json"),
             "csv1": str(out_dir / "one.csv"), "json1": str(out_dir / "one.json")}
    cli_runs = [("generate_narration_texts", _narration_argv(world, paths["csv"])),
                ("icl_eval", _icl_argv(world, paths["json"]))]
    ctx = worker.spawn(worker.generate_main, str(out_dir), models, inputs, cli_runs)

    batch = {k: jnp.asarray(inputs[k]) for k in ("input_ids", "attention_mask", "pixel_values", "video_input_mask")}
    refs = {}
    for name, beams in GENERATE_CASES:
        jmodel, params = jmodels[name]
        cfg = JGenerationConfig(max_new_tokens=5, num_beams=beams, pad_token_id=1)
        refs[f"{name}_beams{beams}"] = np.asarray(jgenerate(jmodel, {"params": params}, generation_config=cfg,
                                                            **batch))
    for name in ("opt", "t5"):
        jmodel, params = jmodels[name]
        refs[f"{name}_classify"] = np.asarray(jclassify(
            jmodel, {"params": params}, prompt_input_ids=batch["input_ids"],
            prompt_attention_mask=batch["attention_mask"], pixel_values=batch["pixel_values"],
            prompt_video_input_mask=batch["video_input_mask"], class_input_ids=jnp.asarray(inputs["class_ids"]),
            class_batch_size=4))
    generate_narration_texts.main(_narration_argv(world, paths["csv1"]) + ["--device", "cpu"])
    icl_eval.main(_icl_argv(world, paths["json1"]) + ["--device", "cpu"])
    return worker.join(ctx, str(out_dir)), refs, paths


@pytest.mark.parametrize("name,beams", GENERATE_CASES, ids=[f"{n}_beams{b}" for n, b in GENERATE_CASES])
def test_tp_generate_matches_jax(ranks, name, beams):
    results, refs, _ = ranks
    key = f"{name}_beams{beams}"
    for out in results:
        np.testing.assert_array_equal(out[key].numpy(), refs[key])


@pytest.mark.parametrize("name", ["opt", "t5"])
def test_tp_classify_matches_jax(ranks, name):
    results, refs, _ = ranks
    key = f"{name}_classify"
    for out in results:
        assert out[key].shape == refs[key].shape == (4, 6)
        np.testing.assert_allclose(out[key].numpy(), refs[key], rtol=2e-5, atol=2e-5)


def test_tp_ranks_hold_the_same_tokens(ranks):
    results, _, _ = ranks
    assert results[0].keys() == results[1].keys()
    for key, value in results[0].items():
        assert torch.equal(value, results[1][key]), key


def test_tp_clis_write_what_one_process_writes(ranks):
    _, _, paths = ranks
    ours, one = (list(csv.DictReader(open(paths[k]))) for k in ("csv", "csv1"))
    assert ours == one and len(ours) == 3
    assert json.load(open(paths["json"])) == json.load(open(paths["json1"]))

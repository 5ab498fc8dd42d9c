"""The int8 weight modes under tensor parallelism against the JAX package, at
``tiny_config(hidden=32, heads=4, vocab_size=61)``, fp32, tp 2 over gloo.

One ``torch.multiprocessing.spawn`` of 2 gloo ranks (tests/_torch_tp_worker.py:
``int8_main``) runs every case; the JAX references are computed meanwhile in
this process:

- ``quantize_model_`` on a tensor-parallel model: each rank's ``w8`` of a
  row-parallel OPT, ViT and Q-Former layer is its slice of
  ``eilev_tpu.ops.quantization.quantize_int8`` of the whole kernel, and its
  ``scale`` is the whole kernel's, exactly (the absmax an all_reduce MAX);
- a row-parallel ``Int8W8A8Dense`` (K = 2,560, where a float sum of the
  int32 partial products would round) is bit-identical in fp32 to the
  unsharded port layer and within 1e-6 of JAX's ``Int8W8A8Dense``;
- ``generate`` with ``int8_lm + w8a8_prefill + int8_vision + int8_qformer``
  at tp 2 (a 4 x 16-token prefill: the W8A8 path) gives the tokens of JAX's
  ``generate`` over ``quantize_lm_params`` / ``quantize_vision_params`` /
  ``quantize_qformer_params`` of the same params, on both ranks;
- ``generate_narration_texts --model_parallel 2 --int8_lm`` writes the CSV of
  one process.
"""

import csv
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eilev_tpu import configs
from eilev_tpu.generation import GenerationConfig as JGenerationConfig
from eilev_tpu.generation import generate as jgenerate
from eilev_tpu.models.video_blip import VideoBlipForConditionalGeneration as JVB
from eilev_tpu.ops import quantization as jq
from eilev_tpu_torch import configs as tconfigs
from eilev_tpu_torch.cli import generate_narration_texts
from eilev_tpu_torch.ops.quantization import Int8W8A8Dense

from . import _torch_tp_worker as worker
from ._torch_port import random_params
from .test_torch_cli import _narration_argv, world  # noqa: F401  (the module-scoped world fixture)
from .test_torch_parallel_tp_generate import _inputs

VOCAB = 61
DENSE = (48, 2560, 8)  # out, in, rows


def _config(mod, quantized: bool):
    cfg = mod.tiny_config(hidden=32, heads=4, vocab_size=VOCAB)
    if not quantized:
        return cfg
    return dataclasses.replace(
        cfg, text_config=dataclasses.replace(cfg.text_config, quantize_matmuls=True, w8a8_prefill=True),
        vision_config=dataclasses.replace(cfg.vision_config, quantize_matmuls=True),
        qformer_config=dataclasses.replace(cfg.qformer_config, quantize_matmuls=True))


def _kernel(params, path: str) -> np.ndarray:
    """The flax (in, out) kernel of the port module ``path``."""
    node = params
    parts = path.split(".")
    for i, part in enumerate(parts):
        if part.isdigit():
            continue
        key = f"{part}_{parts[i + 1]}" if i + 1 < len(parts) and parts[i + 1].isdigit() else part
        node = node[key]
    return np.asarray(node["kernel"])


def _dense_inputs():
    out_f, in_f, rows = DENSE
    rng = np.random.default_rng(7)
    return (rng.normal(size=(out_f, in_f)).astype(np.float32), rng.normal(size=(out_f,)).astype(np.float32),
            rng.normal(size=(rows, in_f)).astype(np.float32))


@pytest.fixture(scope="module")
def ranks(world, tmp_path_factory):  # noqa: F811
    """Spawn the ranks, then compute JAX's quantized kernels, layer output
    and tokens and the one-process CLI's CSV; (rank results, references,
    CSV paths)."""
    out_dir = tmp_path_factory.mktemp("tp_int8")
    inputs = _inputs(_config(configs, False))
    params = random_params(JVB(_config(configs, False)), 0, input_ids=jnp.asarray(inputs["input_ids"]),
                           pixel_values=jnp.asarray(inputs["pixel_values"]),
                           video_input_mask=jnp.asarray(inputs["video_input_mask"]),
                           labels=jnp.asarray(inputs["input_ids"]))
    params = jax.tree.map(np.asarray, params)
    dense = _dense_inputs()
    paths = {"tp": str(out_dir / "tp.csv"), "one": str(out_dir / "one.csv")}
    ctx = worker.spawn(worker.int8_main, str(out_dir), (_config(tconfigs, False), params), inputs, dense,
                       _narration_argv(world, paths["tp"]) + ["--int8_lm"])

    refs = {"layers": {k: jq.quantize_int8(jnp.asarray(_kernel(params, path)))
                       for k, path in worker.ROW_LAYERS.items()}}
    quantized = dict(params)
    quantized["language_model"] = jq.quantize_lm_params(params["language_model"])
    quantized["vision_model"] = jq.quantize_vision_params(params["vision_model"])
    quantized["qformer"] = jq.quantize_qformer_params(params["qformer"])
    batch = {k: jnp.asarray(inputs[k]) for k in ("input_ids", "attention_mask", "pixel_values", "video_input_mask")}
    refs["tokens"] = np.asarray(jgenerate(JVB(_config(configs, True)), {"params": quantized},
                                          generation_config=JGenerationConfig(max_new_tokens=5, pad_token_id=1),
                                          **batch))

    weight, bias, x = dense
    w8, scale = jq.quantize_int8(jnp.asarray(weight.T))
    jlayer = jq.Int8W8A8Dense(features=DENSE[0])
    refs["dense_jax"] = np.asarray(jlayer.apply({"params": {"w8": w8, "scale": scale, "bias": jnp.asarray(bias)}},
                                                jnp.asarray(x)))
    refs["dense_w8"], refs["dense_scale"] = np.asarray(w8).T, np.asarray(scale)
    linear = torch.nn.Linear(DENSE[1], DENSE[0])
    with torch.no_grad():
        linear.weight.copy_(torch.from_numpy(weight))
        linear.bias.copy_(torch.from_numpy(bias))
        refs["dense_port"] = Int8W8A8Dense.from_linear(linear)(torch.from_numpy(x))
    generate_narration_texts.main(_narration_argv(world, paths["one"]) + ["--int8_lm", "--device", "cpu"])
    return worker.join(ctx, str(out_dir)), refs, paths


@pytest.mark.parametrize("name", list(worker.ROW_LAYERS))
def test_tp_row_parallel_int8_leaves_are_slices_of_the_whole_quantization(ranks, name):
    results, refs, _ = ranks
    w8, scale = (np.asarray(a) for a in refs["layers"][name])  # (in, out), (out,)
    per = w8.shape[0] // worker.RANKS
    for rank, out in enumerate(results):
        local_w8, local_scale, row_parallel = out["layers"][name]
        assert row_parallel, name
        np.testing.assert_array_equal(local_scale.numpy(), scale)
        np.testing.assert_array_equal(local_w8.numpy(), w8[rank * per:(rank + 1) * per].T)


def test_tp_row_parallel_w8a8_dense_is_the_unsharded_layer(ranks):
    results, refs, _ = ranks
    per = DENSE[1] // worker.RANKS
    for rank, out in enumerate(results):
        dense = out["dense"]
        assert torch.equal(dense["y"], refs["dense_port"])  # the int32 sum: bit for bit
        np.testing.assert_array_equal(dense["scale"].numpy(), refs["dense_scale"])
        np.testing.assert_array_equal(dense["w8"].numpy(), refs["dense_w8"][:, rank * per:(rank + 1) * per])
        np.testing.assert_allclose(dense["y"].numpy(), refs["dense_jax"], rtol=1e-6, atol=1e-6)


def test_tp_int8_generate_matches_jax(ranks):
    results, refs, _ = ranks
    for out in results:
        np.testing.assert_array_equal(out["tokens"].numpy(), refs["tokens"])
    assert len({tuple(r) for r in refs["tokens"]}) > 1


def test_tp_int8_narration_cli_writes_the_one_process_csv(ranks):
    _, _, paths = ranks
    with open(paths["tp"], newline="") as f_tp, open(paths["one"], newline="") as f_one:
        ours, theirs = list(csv.DictReader(f_tp)), list(csv.DictReader(f_one))
    assert ours == theirs and len(ours) == 3

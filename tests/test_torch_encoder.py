"""Port vs JAX: the metric encoders (eval/encoder.py) and the model-based
metrics (eval/metrics.py), in fp32 on the CPU.

- ``TextEncoder`` (BERT, RoBERTa, MPNet) and ``CrossEncoderModel`` at the
  geometry of ``tests/eval/test_encoder.py`` (2 layers, width 32), a padded
  row: the flax tree refilled from a numpy seed and carried across, every
  hidden state (and the cross-encoder's scores) within 1e-5 of flax's;
- ``convert_encoder`` on an HF-named state dict made from the same numpy
  arrays equals the flax tree carried across, tensor for tensor;
- ``SentenceEncoder`` on tiny checkpoint directories written here (the
  offline tokenizer of ``tests/util_tokenizer.py``): ``encode``,
  ``predict_pairs``, ``bertscore_native`` and ``bert_score_f1`` /
  ``sts_*`` / ``generation_metric_suite`` within 1e-5 of JAX's; a 24-layer
  RoBERTa takes bert_score's roberta-large layer 17 in both.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eilev_tpu.eval import encoder as jenc
from eilev_tpu.eval import metrics as jmetrics
from eilev_tpu_torch.eval import encoder as tenc
from eilev_tpu_torch.eval import metrics as tmetrics
from eilev_tpu_torch.models.convert import flax_to_state_dict, params_from_jax
from eilev_tpu_torch.models.safetensors_io import save_file

from ._torch_port import load_port, random_params, to_np
from .util_tokenizer import build_tiny_tokenizer

GEOM = dict(vocab_size=120, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, max_position_embeddings=64)
TOL = 1e-5


def _cfg(model_type: str, num_labels: int = 0, **geom) -> tuple:
    geom = {**GEOM, **geom}
    pad = 0 if model_type == "bert" else 1
    kw = dict(model_type=model_type, pad_token_id=pad, num_labels=num_labels, **geom)
    return jenc.EncoderConfig(**kw), tenc.EncoderConfig(**kw)


def _ids(cfg, b=2, s=10, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, cfg.vocab_size, size=(b, s))
    mask = np.ones((b, s), np.int64)
    mask[1, -3:] = 0
    ids[1, -3:] = cfg.pad_token_id
    return ids, mask


def _flax_params(jcfg, seed):
    ids, mask = _ids(jcfg)
    module = jenc.CrossEncoderModel(jcfg) if jcfg.num_labels else jenc.TextEncoder(jcfg)
    params = random_params(module, seed, jnp.asarray(ids), jnp.asarray(mask))
    return module, params


@pytest.mark.parametrize("model_type", ["bert", "roberta", "mpnet"])
def test_text_encoder_matches_flax(model_type):
    jcfg, tcfg = _cfg(model_type)
    module, params = _flax_params(jcfg, seed=11)
    ids, mask = _ids(jcfg, seed=1)
    ref = np.asarray(module.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask)))
    ours = load_port(tenc.TextEncoder(tcfg), params)
    with torch.no_grad():
        out = ours(torch.as_tensor(ids), torch.as_tensor(mask))
    assert out.shape == ref.shape == (GEOM["num_hidden_layers"] + 1, 2, 10, GEOM["hidden_size"])
    np.testing.assert_allclose(to_np(out), ref, atol=TOL, rtol=TOL)
    # params_from_jax takes the encoder's config too
    assert params_from_jax(params, tcfg).keys() == ours.state_dict().keys()


def test_cross_encoder_matches_flax():
    jcfg, tcfg = _cfg("roberta", num_labels=1)
    module, params = _flax_params(jcfg, seed=12)
    ids, mask = _ids(jcfg, seed=2)
    ref = np.asarray(module.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask)))
    ours = load_port(tenc.CrossEncoderModel(tcfg), params)
    with torch.no_grad():
        out = ours(torch.as_tensor(ids), torch.as_tensor(mask))
    assert out.shape == ref.shape == (2,)
    np.testing.assert_allclose(to_np(out), ref, atol=TOL, rtol=TOL)


def hf_state_dict(params, cfg) -> dict:
    """The HF names of a flax encoder tree (``convert_encoder``'s inverse),
    numpy arrays: Linear kernels transposed to (out, in)."""
    cross = cfg.num_labels > 0
    body = params["encoder"] if cross else params
    prefix = f"{cfg.model_type}." if cross else ""
    sd = {}

    def lin(key, leaf):
        sd[f"{key}.weight"] = np.asarray(leaf["kernel"]).T
        sd[f"{key}.bias"] = np.asarray(leaf["bias"])

    def ln(key, leaf):
        sd[f"{key}.weight"] = np.asarray(leaf["scale"])
        sd[f"{key}.bias"] = np.asarray(leaf["bias"])

    sd[f"{prefix}embeddings.word_embeddings.weight"] = np.asarray(body["word_embeddings"]["embedding"])
    sd[f"{prefix}embeddings.position_embeddings.weight"] = np.asarray(body["position_embeddings"]["embedding"])
    ln(f"{prefix}embeddings.LayerNorm", body["embeddings_layer_norm"])
    if cfg.model_type in ("bert", "roberta"):
        sd[f"{prefix}embeddings.token_type_embeddings.weight"] = np.asarray(
            body["token_type_embeddings"]["embedding"])
    if cfg.model_type == "mpnet":
        sd[f"{prefix}encoder.relative_attention_bias.weight"] = np.asarray(
            body["relative_attention_bias"]["embedding"])
    for i in range(cfg.num_hidden_layers):
        layer, base = body[f"layers_{i}"], f"{prefix}encoder.layer.{i}"
        att = layer["attention"]
        if cfg.model_type == "mpnet":
            for ours, theirs in (("query", "q"), ("key", "k"), ("value", "v"), ("dense", "o")):
                lin(f"{base}.attention.attn.{theirs}", att[ours])
            ln(f"{base}.attention.LayerNorm", layer["attention_layer_norm"])
        else:
            for name in ("query", "key", "value"):
                lin(f"{base}.attention.self.{name}", att[name])
            lin(f"{base}.attention.output.dense", att["dense"])
            ln(f"{base}.attention.output.LayerNorm", layer["attention_layer_norm"])
        lin(f"{base}.intermediate.dense", layer["intermediate"])
        lin(f"{base}.output.dense", layer["output"])
        ln(f"{base}.output.LayerNorm", layer["output_layer_norm"])
    if cross:
        lin("classifier.dense", params["classifier_dense"])
        lin("classifier.out_proj", params["classifier_out_proj"])
    return sd


@pytest.mark.parametrize("model_type,num_labels", [("bert", 0), ("roberta", 0), ("mpnet", 0), ("roberta", 1)])
def test_convert_encoder_matches_the_flax_tree(model_type, num_labels):
    jcfg, tcfg = _cfg(model_type, num_labels)
    _, params = _flax_params(jcfg, seed=13)
    sd = hf_state_dict(params, jcfg)
    # JAX's converter gives back the same tree; the port's the same tensors
    jtree = jenc.convert_encoder(sd, jcfg)
    for a, b in zip(*(sorted(flax_to_state_dict(t).items()) for t in (jtree, params))):
        assert a[0] == b[0] and torch.equal(a[1], b[1])
    ours = tenc.convert_encoder({k: torch.from_numpy(v.copy()) for k, v in sd.items()}, tcfg)
    want = flax_to_state_dict(params)
    assert ours.keys() == want.keys()
    assert all(torch.equal(ours[k], want[k]) for k in want)
    # and it loads strictly into the module
    cls = tenc.CrossEncoderModel if num_labels else tenc.TextEncoder
    cls(tcfg).load_state_dict(ours, strict=True)


VOCAB = 384
PREDICTIONS = ["The camera wearer cuts an onion.", "The camera wearer opens a drawer.",
               "The camera wearer picks up a knife.", "The camera wearer washes a plate in the sink.",
               "action one two three"]
REFERENCES = ["The camera wearer cuts an onion in the kitchen.", "The camera wearer does a thing.",
              "The camera wearer picks up a knife.", "The camera wearer washes a plate.",
              "four five six seven eight nine ten"]


def _write_checkpoint(path, model_type: str, seed: int, num_labels: int = 0, **geom) -> None:
    """An HF save_pretrained directory: config.json, model.safetensors (HF
    names, from a numpy-refilled flax tree) and the offline tokenizer."""
    geom = {**GEOM, "vocab_size": VOCAB, "max_position_embeddings": 128, **geom}
    jcfg, _ = _cfg(model_type, num_labels, **geom)
    _, params = _flax_params(jcfg, seed)
    os.makedirs(path, exist_ok=True)
    hf = {"model_type": model_type, "pad_token_id": jcfg.pad_token_id, "layer_norm_eps": 1e-12,
          "type_vocab_size": 2, **geom}
    if num_labels:
        hf["id2label"] = {str(i): f"LABEL_{i}" for i in range(num_labels)}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)
    save_file({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in hf_state_dict(params, jcfg).items()},
              os.path.join(path, "model.safetensors"))
    build_tiny_tokenizer(path, vocab_size=VOCAB)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("encoders")
    paths = {"mpnet": str(root / "mpnet"), "roberta24": str(root / "roberta24"), "cross": str(root / "cross")}
    _write_checkpoint(paths["mpnet"], "mpnet", seed=21)
    # roberta at 24 layers: BERTScore's roberta-large rule (layer 17) applies
    _write_checkpoint(paths["roberta24"], "roberta", seed=22, num_hidden_layers=24, hidden_size=16,
                      num_attention_heads=2, intermediate_size=32)
    _write_checkpoint(paths["cross"], "roberta", seed=23, num_labels=1)
    return paths


def test_sentence_encoder_matches_jax(checkpoints):
    ours = tenc.SentenceEncoder(checkpoints["mpnet"], device="cpu")
    ref = jenc.SentenceEncoder(checkpoints["mpnet"])
    assert ours.config == tenc.EncoderConfig(**ref.config.__dict__)
    np.testing.assert_allclose(ours.encode(PREDICTIONS, batch_size=2), ref.encode(PREDICTIONS, batch_size=2),
                               atol=TOL, rtol=TOL)
    (h, m), (jh, jm) = ours.hidden_states(PREDICTIONS), ref.hidden_states(PREDICTIONS)
    np.testing.assert_array_equal(m, jm)
    assert m.min() == 0  # a padded row
    np.testing.assert_allclose(h, jh, atol=TOL, rtol=TOL)
    f1 = tenc.bertscore_native(PREDICTIONS, REFERENCES, ours, num_layers=1, baseline=0.3, batch_size=2)
    jf1 = jenc.bertscore_native(PREDICTIONS, REFERENCES, ref, num_layers=1, baseline=0.3, batch_size=2)
    np.testing.assert_allclose(f1, jf1, atol=TOL, rtol=TOL)

    cross, jcross = (tenc.SentenceEncoder(checkpoints["cross"], cross_encoder=True, device="cpu"),
                     jenc.SentenceEncoder(checkpoints["cross"], cross_encoder=True))
    pairs = list(zip(PREDICTIONS, REFERENCES))
    scores = cross.predict_pairs(pairs, batch_size=3)
    assert scores.shape == (5,)
    np.testing.assert_allclose(scores, jcross.predict_pairs(pairs, batch_size=3), atol=TOL, rtol=TOL)


def test_model_based_metrics_match_jax(checkpoints, monkeypatch):
    layers_seen = []
    inner = tenc.bertscore_native

    def recording(*args, **kwargs):
        layers_seen.append(kwargs["num_layers"])
        return inner(*args, **kwargs)

    monkeypatch.setattr(tenc, "bertscore_native", recording)
    # the suite calls bert_score_f1, sts_biencoder_cosine and sts_crossencoder
    paths = dict(bert_score_model=checkpoints["roberta24"], sts_biencoder_model=checkpoints["mpnet"],
                 sts_crossencoder_model=checkpoints["cross"])
    ours = tmetrics.generation_metric_suite(PREDICTIONS, REFERENCES, device="cpu", **paths)
    ref = jmetrics.generation_metric_suite(PREDICTIONS, REFERENCES, **paths)
    assert layers_seen == [17]  # roberta at 24 layers: roberta-large's layer
    assert ours.keys() == ref.keys() == {"bleu", "rougeL", "bertscore_f1", "sts_biencoder", "sts_crossencoder"}
    for k in ref:
        assert ours[k] == pytest.approx(ref[k], abs=TOL), k


def test_metrics_refuse_without_a_local_checkpoint(tmp_path):
    for fn in (tmetrics.bert_score_f1, tmetrics.sts_biencoder_cosine, tmetrics.sts_crossencoder):
        with pytest.raises(RuntimeError, match="local pretrained checkpoint"):
            fn(["a"], ["a"], None)
        with pytest.raises(RuntimeError, match="local pretrained checkpoint"):
            fn(["a"], ["a"], str(tmp_path / "missing"))

"""Port vs JAX: HF checkpoint loading and export.

The checkpoint is written by the JAX package's own exporter
(``tests/_torch_hf.py``), fp32 at tiny widths. The port's safetensors reader
and writer and the ``safetensors`` package read each other's files;
``eilev_tpu_torch.models.auto.load_model`` gives exactly the state dict that
``params_from_jax`` makes of ``eilev_tpu.models.auto.load_model``'s params,
under every switch; ``config_from_hf_dict`` and ``hf_state_dict`` equal
JAX's; load -> export -> load is the identity; ``VideoBlipProcessor`` and the
loaded model's greedy tokens equal JAX's.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import load_file as pkg_load_file
from safetensors.torch import save_file as pkg_save_file

from eilev_tpu.generation import GenerationConfig as JGenerationConfig
from eilev_tpu.generation import generate as jgenerate
from eilev_tpu.models import auto as jauto
from eilev_tpu.models.processing import VideoBlipProcessor as JVideoBlipProcessor
from eilev_tpu.training.checkpoint import hf_state_dict as jhf_state_dict
from eilev_tpu_torch.generation import GenerationConfig, generate
from eilev_tpu_torch.models import auto, params_from_jax
from eilev_tpu_torch.models.convert import load_hf_checkpoint
from eilev_tpu_torch.models.processing import VideoBlipProcessor
from eilev_tpu_torch.models.safetensors_io import SafetensorsDirectory, load_file, save_file
from eilev_tpu_torch.training.checkpoint import export_hf_safetensors, hf_state_dict

from ._torch_hf import HF_CONFIG, T5_HF_CONFIG, hf_config, write_checkpoint
from .util_tokenizer import build_tiny_tokenizer

DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.int64, torch.int32, torch.int8]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("hf_ckpt"))
    write_checkpoint(path)
    return path


def _tensors(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    if dtype.is_floating_point:
        make = lambda *shape: torch.randn(shape, generator=g).to(dtype)  # noqa: E731
    else:
        make = lambda *shape: torch.randint(-100, 100, shape, generator=g).to(dtype)  # noqa: E731
    return {"a.weight": make(3, 5), "b": make(7), "c.scalar": make(), "empty": make(0, 4), "d": make(2, 3, 4)}


def _assert_same(ours, ref):
    assert set(ours) == set(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and ours[k].shape == ref[k].shape, k
        assert torch.equal(ours[k], ref[k]), k


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_reader_and_package_read_each_others_files(tmp_path, dtype):
    ts = _tensors(dtype)
    save_file(ts, str(tmp_path / "ours.safetensors"))
    _assert_same(pkg_load_file(str(tmp_path / "ours.safetensors")), ts)
    pkg_save_file(ts, str(tmp_path / "pkg.safetensors"))
    _assert_same(load_file(str(tmp_path / "pkg.safetensors")), ts)
    # cast on read, straight into the asked dtype
    with SafetensorsDirectory(str(tmp_path)) as d:
        if dtype.is_floating_point:
            view = d.view(dtype=torch.float64)
            assert torch.equal(view["d"], ts["d"].double())
        assert set(d.keys()) == set(ts)


def test_sharded_directory(tmp_path, ckpt):
    """A two-shard directory (the package writes the shards) reads as the
    single file does, and converts to the same state dict."""
    whole = pkg_load_file(os.path.join(ckpt, "model.safetensors"))
    names = sorted(whole)
    shard_dir = tmp_path / "sharded"
    shard_dir.mkdir()
    pkg_save_file({k: whole[k] for k in names[::2]}, str(shard_dir / "model-00001-of-00002.safetensors"))
    pkg_save_file({k: whole[k] for k in names[1::2]}, str(shard_dir / "model-00002-of-00002.safetensors"))
    with SafetensorsDirectory(str(shard_dir)) as d:
        assert len(d.files) == 2
        _assert_same({k: d.get_tensor(k) for k in d.keys()}, whole)
    cfg = auto.config_from_hf_dict(HF_CONFIG)
    _assert_same(load_hf_checkpoint(str(shard_dir), cfg), load_hf_checkpoint(ckpt, cfg))
    with pytest.raises(FileNotFoundError, match="no \\*.safetensors"):
        load_hf_checkpoint(str(tmp_path), cfg)


SWITCHES = {
    "plain": {},
    "int8_lm": {"int8_lm": True},
    "int8_kv": {"int8_kv": True},
    "int8_vision": {"int8_vision": True},
    "int8_qformer": {"int8_qformer": True},
    "w8a8_prefill": {"int8_lm": True, "w8a8_prefill": True},
    "remat": {"remat": True},
}


@pytest.mark.parametrize("switch", list(SWITCHES))
def test_load_model_matches_jax(ckpt, switch):
    """The port's loaded state dict equals params_from_jax of JAX's loaded
    params exactly: quantized int8 weights and their scales too (both round
    half to even, from the same fp32 quotient)."""
    kw = SWITCHES[switch]
    _, jvars, jcfg = jauto.load_model(ckpt, **kw)
    model, cfg = auto.load_model(ckpt, device="cpu", **kw)
    _assert_same(model.state_dict(), params_from_jax(jvars["params"], cfg))
    for sub in ("text_config", "vision_config", "qformer_config"):
        assert dataclasses.asdict(getattr(cfg, sub)) == dataclasses.asdict(getattr(jcfg, sub)), sub
    assert model.config is cfg and not model.training
    assert not any(p.requires_grad for p in model.parameters())


def test_load_model_with_projections(tmp_path):
    """word_embed_proj_dim != hidden_size: project_in/project_out load too."""
    hf = hf_config(word_embed_proj_dim=8)
    write_checkpoint(str(tmp_path), hf, seed=3)
    _, jvars, jcfg = jauto.load_model(str(tmp_path))
    model, cfg = auto.load_model(str(tmp_path), device="cpu")
    state = model.state_dict()
    assert "language_model.project_in.weight" in state
    _assert_same(state, params_from_jax(jvars["params"], cfg))


def test_load_model_param_dtype(ckpt):
    """param_dtype=bf16 stores every weight as the bf16 rounding of the
    file's; the default keeps the file's fp32 and computes in ``dtype``."""
    ref, _ = auto.load_model(ckpt, device="cpu")
    half, _ = auto.load_model(ckpt, dtype=torch.bfloat16, param_dtype=torch.bfloat16, device="cpu")
    mixed, _ = auto.load_model(ckpt, dtype=torch.bfloat16, device="cpu")
    for k, v in ref.state_dict().items():
        assert torch.equal(half.state_dict()[k], v.to(torch.bfloat16)), k
        assert torch.equal(mixed.state_dict()[k], v), k
    assert mixed.compute_dtype == torch.bfloat16
    ids = torch.tensor([[2, 5, 6, 7]])
    with torch.inference_mode():
        for model in (half, mixed):
            logits, _ = model.language_model(model.lm_embed(ids))
            assert logits.dtype == torch.bfloat16


def _t5_dict():
    d = json.loads(json.dumps(HF_CONFIG))
    d["text_config"] = {"model_type": "t5", "vocab_size": 96, "d_model": 16, "d_kv": 8, "d_ff": 32, "num_layers": 2,
                        "num_heads": 2, "feed_forward_proj": "gated-gelu", "tie_word_embeddings": False}
    return d


@pytest.mark.parametrize("text", ["opt", "t5"])
def test_config_from_hf_dict_matches_jax(text):
    hf = HF_CONFIG if text == "opt" else _t5_dict()
    ours, ref = auto.config_from_hf_dict(hf), jauto.config_from_hf_dict(hf)
    assert type(ours.text_config).__name__ == type(ref.text_config).__name__
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert dataclasses.asdict(auto.config_from_hf_dict({k: hf[k] for k in hf if k != "num_query_tokens"})) == \
        dataclasses.asdict(jauto.config_from_hf_dict({k: hf[k] for k in hf if k != "num_query_tokens"}))


def test_v1_and_t5_raise(ckpt, tmp_path):
    # the v1 model is ported: the same weights under the prepending v1 class
    from eilev_tpu_torch.models.video_blip_v1 import VideoBlipV1ForConditionalGeneration

    v1, _ = auto.load_model(ckpt, version="v1", device="cpu")
    v2, _ = auto.load_model(ckpt, device="cpu")
    assert type(v1) is VideoBlipV1ForConditionalGeneration
    assert all(torch.equal(a, b) for a, b in zip(v1.state_dict().values(), v2.state_dict().values()))
    # a T5 checkpoint loads (no longer raises): exactly the state dict that
    # params_from_jax makes of JAX's loaded params, the same forward logits
    t5_dir = str(tmp_path / "t5")
    write_checkpoint(t5_dir, T5_HF_CONFIG)
    jmodel, jvars, jcfg = jauto.load_model(t5_dir)
    t5, cfg = auto.load_model(t5_dir, device="cpu")
    _assert_same(t5.state_dict(), params_from_jax(jax.tree.map(np.asarray, jvars["params"]), cfg))
    ids, vim = np.array([[2, 1, 1, 1, 1, 7, 9]]), np.array([[0, 1, 1, 1, 1, 0, 0]])
    px, dec = np.random.default_rng(1).normal(size=(1, 3, 2, 16, 16)).astype(np.float32), np.array([[0, 5, 6]])
    ref = jmodel.apply(jvars, jnp.asarray(ids), pixel_values=jnp.asarray(px), video_input_mask=jnp.asarray(vim),
                       decoder_input_ids=jnp.asarray(dec))["logits"]
    with torch.no_grad():
        out = t5(torch.from_numpy(ids), pixel_values=torch.from_numpy(px), video_input_mask=torch.from_numpy(vim),
                 decoder_input_ids=torch.from_numpy(dec))["logits"]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="requires int8_lm"):
        auto.load_model(ckpt, w8a8_prefill=True, device="cpu")


def test_hf_state_dict_matches_jax_and_round_trips(ckpt, tmp_path):
    _, jvars, jcfg = jauto.load_model(ckpt)
    model, cfg = auto.load_model(ckpt, device="cpu")
    ours, ref = hf_state_dict(model, cfg), jhf_state_dict(jvars["params"], jcfg)
    assert set(ours) == set(ref)
    for k in ref:
        assert tuple(ours[k].shape) == ref[k].shape, k
        assert np.array_equal(ours[k].numpy(), np.asarray(ref[k])), k
    # the exported file holds exactly the JAX exporter's tensors
    out = str(tmp_path / "export")
    export_hf_safetensors(model, cfg, out)
    _assert_same(pkg_load_file(os.path.join(out, "model.safetensors")),
                 pkg_load_file(os.path.join(ckpt, "model.safetensors")))
    with open(os.path.join(out, "config.json"), "w") as f:
        json.dump(HF_CONFIG, f)
    again, _ = auto.load_model(out, device="cpu")
    _assert_same(again.state_dict(), model.state_dict())
    quantized, qcfg = auto.load_model(ckpt, int8_lm=True, device="cpu")
    with pytest.raises(ValueError, match="float weights"):
        hf_state_dict(quantized, qcfg)


def test_processor_matches_jax(tmp_path):
    tok = build_tiny_tokenizer(str(tmp_path), vocab_size=384)
    cfg = auto.config_from_hf_dict(HF_CONFIG)
    video = np.random.default_rng(4).integers(0, 256, size=(2, 3, 3, 20, 24), dtype=np.uint8)
    texts = ["The camera wearer cuts an onion", "Question: What is the camera wearer doing? Answer:"]
    ours = VideoBlipProcessor.from_config(tok, cfg, device="cpu")(video=video, text=texts)
    ref = JVideoBlipProcessor.from_config(tok, jauto.config_from_hf_dict(HF_CONFIG))(video=video, text=texts)
    np.testing.assert_allclose(ours["pixel_values"].numpy(), np.asarray(ref["pixel_values"]), atol=1e-5, rtol=0)
    assert np.array_equal(ours["input_ids"].numpy(), ref["input_ids"])
    assert np.array_equal(ours["attention_mask"].numpy(), ref["attention_mask"])
    one = VideoBlipProcessor(tok, image_size=16, device="cpu")(video=video[0], text=texts[0])
    assert one["pixel_values"].shape == (1, 3, 3, 16, 16) and one["input_ids"].shape[0] == 1


def test_loaded_model_greedy_matches_jax(ckpt):
    """uint8 frames -> greedy tokens of the loaded model, row 1 left-padded:
    identical to eilev_tpu.generate on JAX's loaded model."""
    jmodel, jvars, jcfg = jauto.load_model(ckpt)
    model, cfg = auto.load_model(ckpt, device="cpu")
    rng = np.random.default_rng(5)
    q, b, s = cfg.num_query_tokens, 2, 12
    frames = rng.integers(0, 256, size=(b, 3, 2, 16, 16), dtype=np.uint8)
    ids = rng.integers(4, 384, size=(b, s)).astype(np.int32)
    ids[:, 0] = 2
    mask = np.ones((b, s), np.int32)
    ids[1, :2], mask[1, :2] = 1, 0
    vim = np.zeros((b, s), np.int32)
    vim[:, 3 : 3 + q] = 1
    gen = dict(max_new_tokens=6, pad_token_id=1, eos_token_id=())
    proc = VideoBlipProcessor.from_config(None, cfg, device="cpu")
    jproc = JVideoBlipProcessor.from_config(None, jcfg)
    ours = generate(model, input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                    pixel_values=proc(video=frames)["pixel_values"], video_input_mask=torch.from_numpy(vim),
                    generation_config=GenerationConfig(**gen)).numpy()
    ref = np.asarray(jgenerate(jmodel, jvars, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                               pixel_values=jproc(video=frames)["pixel_values"], video_input_mask=jnp.asarray(vim),
                               generation_config=JGenerationConfig(**gen)))
    assert ours.shape == (b, 6)
    np.testing.assert_array_equal(ours, ref)


_NO_PACKAGE = """
import sys
sys.modules["safetensors"] = None  # any import of the package now fails
from eilev_tpu_torch.models.auto import load_model
from eilev_tpu_torch.training.checkpoint import export_hf_safetensors
model, cfg = load_model(sys.argv[1], device="cpu", int8_kv=True)
export_hf_safetensors(load_model(sys.argv[1], device="cpu")[0], cfg, sys.argv[2])
print("OK", sorted(m for m in sys.modules if m.split(".")[0] == "safetensors"))
"""


def test_load_and_export_need_no_safetensors_package(ckpt, tmp_path):
    """The card's host has no ``safetensors``: loading and exporting run
    with the package made unimportable."""
    import subprocess
    import sys

    proc = subprocess.run([sys.executable, "-c", _NO_PACKAGE, ckpt, str(tmp_path)], capture_output=True, text=True,
                          timeout=120, cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "OK ['safetensors']"
    _assert_same(pkg_load_file(str(tmp_path / "model.safetensors")),
                 pkg_load_file(os.path.join(ckpt, "model.safetensors")))


def test_cli_default_bf16_matches_jax(ckpt):
    """load_model(dtype=bf16): fp32 weights cast to bf16 at use, in both
    packages. The forward's logits come out in bf16 and agree within 2e-2
    of their scale (the repo's bf16 bar): the two differ in the order of
    their roundings only."""
    jmodel, jvars, _ = jauto.load_model(ckpt, dtype=jnp.bfloat16)
    model, _ = auto.load_model(ckpt, dtype=torch.bfloat16, device="cpu")
    rng = np.random.default_rng(0)
    ids = rng.integers(4, 384, size=(2, 12))
    ids[:, 0] = 2
    vim = np.zeros_like(ids)
    vim[:, 2:6] = 1
    px = rng.normal(size=(2, 3, 2, 16, 16)).astype(np.float32)
    ref = np.asarray(jmodel.apply(jvars, input_ids=jnp.asarray(ids), pixel_values=jnp.asarray(px, jnp.bfloat16),
                                  video_input_mask=jnp.asarray(vim))["logits"], np.float32)
    with torch.inference_mode():
        out = model(torch.from_numpy(ids), pixel_values=torch.from_numpy(px).bfloat16(),
                    video_input_mask=torch.from_numpy(vim))["logits"]
    assert out.dtype == torch.bfloat16
    assert np.abs(out.float().numpy() - ref).max() <= 2e-2 * np.abs(ref).max()


def test_compute_follows_a_converted_model(ckpt):
    """A model whose weights are its compute dtype follows a ``.double()``
    (the fp64 yardstick of the training checks); one loaded with fp32
    weights under a bf16 compute keeps computing in bf16."""
    ids = torch.tensor([[2, 1, 1, 1, 1, 5]])
    vim = torch.tensor([[0, 1, 1, 1, 1, 0]])  # the 4 query tokens of one video
    plain, _ = auto.load_model(ckpt, device="cpu")
    mixed, _ = auto.load_model(ckpt, dtype=torch.bfloat16, device="cpu")
    assert plain.compute_dtype == torch.float32 and mixed.compute_dtype == torch.bfloat16
    with torch.inference_mode():
        for model, want in ((plain.double(), torch.float64), (mixed, torch.bfloat16)):
            assert model.compute_dtype == want
            logits = model(ids, pixel_values=torch.zeros(1, 3, 2, 16, 16, dtype=want),
                           video_input_mask=vim)["logits"]
            assert logits.dtype == want

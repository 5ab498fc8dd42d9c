"""Port vs JAX: VideoBLIP-T5 training and conversion at tiny_config(text_model="t5"), fp32.

- The training forward (labels shifted right into the decoder, -100 -> pad,
  the unshifted cross entropy): loss and every trainable gradient against
  ``jax.value_and_grad`` at 1e-4, without dropout and with JAX's
  ``nn.Dropout`` calls fed the masks the port drew (``RecordingMasks``), one
  a site, in call order.
- ``train_batch_iterator``'s seq2seq batches equal JAX's, and two AdamW
  steps of ``make_train_step`` on them give JAX's loss, grad_norm and
  masters within 1e-5.
- Per-layer remat of the encoder and decoder trunks (``T5Config.remat``):
  loss and gradients bit-identical to the plain forward with dropout on, and
  the mask source left where the plain forward leaves it.
- ``params_from_jax``, ``convert_videoblip`` (``convert_t5``) and
  ``hf_state_dict`` equal JAX's tensor for tensor; export -> ``load_model``
  -> greedy gives JAX's tokens.
- The narration and ICL CLIs load a T5 checkpoint and write the JAX
  scripts' CSV and JSON; the v1 model over T5 gives JAX's loss and greedy
  tokens.
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
from eilev_tpu.models import VideoBlipForConditionalGeneration as JVB
from eilev_tpu.models import auto as jauto
from eilev_tpu.models.convert import convert_videoblip as jconvert_videoblip
from eilev_tpu.training.checkpoint import hf_state_dict as jhf_state_dict
from eilev_tpu_torch import configs as tconfigs
from eilev_tpu_torch.cli import generate_narration_texts, icl_eval
from eilev_tpu_torch.generation import GenerationConfig, generate
from eilev_tpu_torch.models import VideoBlipForConditionalGeneration, auto, params_from_jax
from eilev_tpu_torch.models.convert import convert_videoblip, flax_to_state_dict
from eilev_tpu_torch.ops.dropout import DropoutRng
from eilev_tpu_torch.training import freeze_towers, partition_params
from eilev_tpu_torch.training.checkpoint import export_hf_safetensors, hf_state_dict

from ._torch_hf import T5_HF_CONFIG, write_checkpoint
from ._torch_port import random_params
from .test_torch_cli import _icl_argv, _narration_argv, _run_jax_script, world  # noqa: F401  (the CLI world)
from .test_torch_train_step import RecordingMasks, _assert_grads_close, _jax_loss_and_grads, _port_loss_and_grads

SEQ, LABELS = 12, 5


def _batch(cfg, b=2, seed=0):
    """A seq2seq batch: one video a row at positions 1..1+Q of the encoder
    input (row 1 right-padded by 2), the decoder's labels apart, -100 on
    row 0's last two."""
    rng = np.random.default_rng(seed)
    img, q = cfg.vision_config.image_size, cfg.num_query_tokens
    ids = rng.integers(2, cfg.text_config.vocab_size, size=(b, SEQ))
    vim = np.zeros((b, SEQ), np.int64)
    vim[:, 1 : 1 + q] = 1
    mask = np.ones((b, SEQ), np.int64)
    mask[1, -2:] = 0
    labels = rng.integers(2, cfg.text_config.vocab_size, size=(b, LABELS))
    labels[0, -2:] = -100
    return {"input_ids": ids, "attention_mask": mask, "labels": labels, "video_input_mask": vim,
            "pixel_values": rng.normal(size=(b, 3, 2, img, img)).astype(np.float32)}


def _cfg(pkg, remat=False):
    cfg = pkg.tiny_config(text_model="t5")
    return pkg.replace(cfg, text_config=dataclasses.replace(cfg.text_config, remat=remat)) if remat else cfg


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg(configs)
    jmodel = JVB(cfg)
    b = _batch(cfg)
    params = random_params(jmodel, 31, input_ids=jnp.asarray(b["input_ids"]),
                           pixel_values=jnp.asarray(b["pixel_values"]),
                           video_input_mask=jnp.asarray(b["video_input_mask"]),
                           decoder_input_ids=jnp.zeros((2, LABELS), jnp.int32))
    return cfg, jmodel, jax.tree.map(np.asarray, params)


def _port_model(params, remat=False):
    cfg = _cfg(tconfigs, remat)
    model = VideoBlipForConditionalGeneration(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg), strict=True)
    freeze_towers(model)
    return model


def _to_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def test_t5_loss_and_grads_match_jax(setup):
    cfg, jmodel, params = setup
    batch = _batch(cfg, seed=1)
    jloss, jgrads, _ = _jax_loss_and_grads(cfg, jmodel, params, batch)
    model = _port_model(params)
    loss, grads = _port_loss_and_grads(model, batch)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    _assert_grads_close(grads, jgrads)
    # the decoder's logits, not the encoder's: (B, labels, vocab)
    out = model(**_to_torch(batch))
    assert out["logits"].shape == (2, LABELS, cfg.text_config.vocab_size)


def test_t5_dropout_masks_match_jax_at_every_site(setup):
    """Q-Former 1 + 2 x 5; encoder 1 + 2 x 3 + 1; decoder 1 + 2 x 4 + 1."""
    cfg, jmodel, params = setup
    batch = _batch(cfg, seed=2)
    masks = RecordingMasks(6)
    model = _port_model(params)
    loss, grads = _port_loss_and_grads(model, batch, masks)
    assert len(masks.masks) == 11 + 8 + 10
    jloss, jgrads, calls = _jax_loss_and_grads(cfg, jmodel, params, batch, masks.masks)
    assert calls == len(masks.masks)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    _assert_grads_close(grads, jgrads)
    model.eval()
    with torch.no_grad():
        assert abs(float(model(**_to_torch(batch))["loss"]) - loss) > 1e-4  # dropout is live


def _loss_and_grads(model, batch, seed):
    trainable, _ = partition_params(dict(model.named_parameters()))
    model.train()
    rng = DropoutRng.seeded(seed, "cpu")
    loss = model(**batch, dropout_rng=rng)["loss"]
    grads = torch.autograd.grad(loss, list(trainable.values()))
    return loss.detach(), dict(zip(trainable, grads)), rng.get_state()


@pytest.mark.parametrize("seed", [0, 5])
def test_t5_remat_bit_identical_with_dropout(setup, seed):
    cfg, _, params = setup
    batch = _to_torch(_batch(cfg, seed=3))
    loss0, g0, end0 = _loss_and_grads(_port_model(params), batch, seed)
    loss1, g1, end1 = _loss_and_grads(_port_model(params, remat=True), batch, seed)
    assert torch.equal(loss0, loss1) and torch.equal(end0, end1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    assert sum(float(g.square().sum()) for g in g0.values()) > 0
    with torch.no_grad():  # without a graph the remat config runs the plain forward
        a = _port_model(params).eval()(**batch)["logits"]
        b = _port_model(params, remat=True).eval()(**batch)["logits"]
    assert torch.equal(a, b)


def test_t5_train_step_on_seq2seq_batches_matches_jax(setup):
    """train_batch_iterator's seq2seq batches (decoder_only_lm=False: the
    labels apart, -100-padded to the bucket; no augmentation, whose draws
    differ) equal JAX's; two AdamW steps of
    make_train_step on them (accum 2) give JAX's loss, grad_norm and masters
    within 1e-5."""
    from eilev_tpu.training import OptimizerConfig as JOptimizerConfig
    from eilev_tpu.training import TrainState as JTrainState
    from eilev_tpu.training import make_optimizer as jmake_optimizer
    from eilev_tpu.training import make_train_step as jmake_train_step
    from eilev_tpu.training import partition_params as jpartition
    from eilev_tpu.training.data_module import train_batch_iterator as jax_iterator
    from eilev_tpu_torch.training import OptimizerConfig, TrainState, make_optimizer, make_train_step
    from eilev_tpu_torch.training.data_module import train_batch_iterator
    from tests.data.mock_tokenizer import MockTokenizer

    from .test_torch_data_module import _DS

    cfg, jmodel, params = setup
    kw = dict(num_query_tokens=cfg.num_query_tokens, decoder_only_lm=False, num_frames=2,
              image_size=cfg.vision_config.image_size, seed=0, epochs=1, accum_steps=2, micro_batch_size=1,
              max_length=48, augment=False)
    theirs = list(jax_iterator(_DS(4), MockTokenizer(), **kw))
    ours = list(train_batch_iterator(_DS(4), MockTokenizer(), device="cpu", **kw))
    assert len(ours) == len(theirs) == 2
    for a, b in zip(theirs, ours):
        for key in ("input_ids", "attention_mask", "labels", "video_input_mask"):
            np.testing.assert_array_equal(b[key].numpy(), np.asarray(a[key]), err_msg=key)
    ocfg = OptimizerConfig(learning_rate=1e-3, eps=1e-6, warmup_steps=0, total_steps=5)
    trainable, frozen = jpartition(params)
    jstate = JTrainState.create(jax.tree.map(jnp.asarray, trainable),
                                jmake_optimizer(JOptimizerConfig(**dataclasses.asdict(ocfg))))
    jstep = jax.jit(jmake_train_step(jmodel, accum_steps=2, dropout=False))
    model = _port_model(params)
    tr, _ = partition_params(dict(model.named_parameters()))
    state = TrainState.create(tr, make_optimizer(ocfg))
    step = make_train_step(model, accum_steps=2, dropout=False)
    for a, b in zip(theirs, ours):
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, frozen), jax.tree.map(jnp.asarray, a))
        state, m = step(state, b)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    ref = flax_to_state_dict(jax.tree.map(np.asarray, jstate.trainable))
    for name, p in state.trainable.items():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), atol=1e-5, rtol=0, err_msg=name)


def test_t5_conversions_match_jax(setup):
    """params_from_jax, hf_state_dict and convert_videoblip (convert_t5)
    against JAX's: the same tensors under the same names."""
    cfg, _, params = setup
    tcfg = tconfigs.tiny_config(text_model="t5")
    model = _port_model(params)
    ref_hf = jhf_state_dict(params, cfg)
    ours_hf = hf_state_dict(model, tcfg)
    assert set(ours_hf) == set(ref_hf)
    for k, v in ref_hf.items():
        assert np.array_equal(ours_hf[k].numpy(), np.asarray(v)), k
    hf = {k: torch.from_numpy(np.array(v)) for k, v in ref_hf.items()}
    ours = convert_videoblip(hf, tcfg)
    ref = flax_to_state_dict(jax.tree.map(np.asarray, jconvert_videoblip(ref_hf, cfg)))
    assert set(ours) == set(ref) == set(model.state_dict())
    for k in ref:
        assert torch.equal(ours[k], ref[k]), k


def test_t5_checkpoint_round_trip_greedy_matches_jax(tmp_path):
    """A T5 checkpoint written by the JAX exporter: load_model, export,
    load_model again (the same file), then greedy from frames equals
    eilev_tpu.generate on JAX's loaded model."""
    path = str(tmp_path / "ckpt")
    write_checkpoint(path, T5_HF_CONFIG)
    jmodel, jvars, _ = jauto.load_model(path)
    model, cfg = auto.load_model(path, device="cpu")
    out = str(tmp_path / "export")
    export_hf_safetensors(model, cfg, out)
    from safetensors.torch import load_file

    a, b = load_file(f"{path}/model.safetensors"), load_file(f"{out}/model.safetensors")
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    rng = np.random.default_rng(8)
    q, n, s = cfg.num_query_tokens, 2, 10
    ids = rng.integers(4, 300, size=(n, s)).astype(np.int32)
    vim = np.zeros((n, s), np.int32)
    vim[:, 1 : 1 + q] = 1
    px = rng.normal(size=(n, 3, 2, 16, 16)).astype(np.float32)
    gen = dict(max_new_tokens=5, pad_token_id=0, eos_token_id=())
    ref = np.asarray(jgenerate(jmodel, jvars, input_ids=jnp.asarray(ids), pixel_values=jnp.asarray(px),
                               video_input_mask=jnp.asarray(vim), generation_config=JGenerationConfig(**gen)))
    ours = generate(model, input_ids=torch.from_numpy(ids), pixel_values=torch.from_numpy(px),
                    video_input_mask=torch.from_numpy(vim), generation_config=GenerationConfig(**gen)).numpy()
    assert ours.shape == (n, 6)
    np.testing.assert_array_equal(ours, ref)


def test_narration_and_icl_clis_load_a_t5_checkpoint(world, tmp_path):
    """The narration and ICL CLIs load a T5 checkpoint (written by the JAX
    exporter, the tiny tokenizer beside it) through load_model: the CSV and
    the JSON equal the JAX scripts'."""
    ckpt = str(tmp_path / "t5_checkpoint")
    write_checkpoint(ckpt, T5_HF_CONFIG, seed=34, tokenizer=True)

    def swap(argv):
        return [ckpt if a == str(world / "checkpoint") else a for a in argv]

    ours_csv, ref_csv = str(tmp_path / "ours.csv"), str(tmp_path / "ref.csv")
    generate_narration_texts.main(swap(_narration_argv(world, ours_csv)) + ["--device", "cpu"])
    _run_jax_script("generate_narration_texts.py", swap(_narration_argv(world, ref_csv)))
    ours, ref = list(csv.DictReader(open(ours_csv))), list(csv.DictReader(open(ref_csv)))
    assert ours == ref and len(ours) == 3
    ours_json, ref_json = str(tmp_path / "ours.json"), str(tmp_path / "ref.json")
    icl_eval.main(swap(_icl_argv(world, ours_json)) + ["--device", "cpu"])
    _run_jax_script("icl_eval.py", swap(_icl_argv(world, ref_json)))
    assert json.load(open(ours_json)) == json.load(open(ref_json))


def test_v1_t5_forward_and_greedy_match_jax():
    """The v1 model over T5 (features prepended to the encoder's input, the
    mask extended with ones): the seq2seq loss and logits at 1e-4 and greedy
    tokens identical to JAX's."""
    from eilev_tpu.models.video_blip_v1 import VideoBlipV1ForConditionalGeneration as JV1
    from eilev_tpu_torch.models.video_blip_v1 import VideoBlipV1ForConditionalGeneration

    cfg = configs.tiny_config(text_model="t5")
    rng = np.random.default_rng(12)
    img = cfg.vision_config.image_size
    pixel = rng.normal(size=(2, 3, 2, img, img)).astype(np.float32)
    ids = rng.integers(2, cfg.text_config.vocab_size, size=(2, 7)).astype(np.int32)
    mask = np.ones((2, 7), np.int32)
    mask[1, -2:] = 0
    labels = rng.integers(2, cfg.text_config.vocab_size, size=(2, 4)).astype(np.int32)
    labels[0, -1] = -100
    jmodel = JV1(cfg)
    params = random_params(jmodel, 13, input_ids=jnp.asarray(ids), pixel_values=jnp.asarray(pixel),
                           decoder_input_ids=jnp.zeros((2, 4), jnp.int32))
    tcfg = tconfigs.tiny_config(text_model="t5")
    model = VideoBlipV1ForConditionalGeneration(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), tcfg), strict=True)
    model.eval()
    ref = jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(pixel),
                       labels=jnp.asarray(labels))
    with torch.no_grad():
        ours = model(torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(pixel),
                     labels=torch.from_numpy(labels))
    np.testing.assert_allclose(ours["logits"].numpy(), np.asarray(ref["logits"]), atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(ours["loss"]), float(ref["loss"]), rtol=1e-5)
    gen = dict(max_new_tokens=5, pad_token_id=0, eos_token_id=(-1,))
    jtok = jgenerate(jmodel, {"params": params}, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                     pixel_values=jnp.asarray(pixel), generation_config=JGenerationConfig(**gen))
    tok = generate(model, input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                   pixel_values=torch.from_numpy(pixel), generation_config=GenerationConfig(**gen))
    assert tok.shape == (2, 6)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))

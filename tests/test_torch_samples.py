"""Port vs JAX: the two samples (``eilev_tpu_torch/samples/``) on a tiny
checkpoint written by the port's own ``export_hf_safetensors`` (with a
``config.json`` and the offline tokenizer beside it), in fp32 on the CPU.

Each sample's ``main`` reads its y4m videos through the port's native
decoder and calls ``run``; the JAX sample (``samples/*.py``, run in process
on the same arguments) must print the same text:
- EILeV: two videos interleaved with text, beam 5, length_penalty -1, eos
  50118;
- VideoBLIP (the v1 model, features prepended): sampling at temperature
  0.7, top_p 0.9; the port's Gumbel noise is replaced by JAX's draws from
  ``PRNGKey(0)`` (``tests/test_torch_sampling.replay``), the key the JAX
  sample uses, so both make the same draws.
Both skip where the decoder cannot be built (no g++ or libav headers).
"""

import json
import os
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

from eilev_tpu_torch.generation import decoding
from eilev_tpu_torch.models import params_from_jax
from eilev_tpu_torch.models.auto import config_from_hf_dict
from eilev_tpu_torch.models.video_blip import VideoBlipForConditionalGeneration
from eilev_tpu_torch.native import decoder_available
from eilev_tpu_torch.samples import eilev_generate_action_narration as eilev_sample
from eilev_tpu_torch.samples import video_blip_generate_action_narration as vblip_sample
from eilev_tpu_torch.training.checkpoint import export_hf_safetensors

from ._torch_hf import hf_config, write_checkpoint
from .data.test_native_decoder import _write_y4m
from .test_torch_sampling import replay
from .util_tokenizer import build_tiny_tokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# room for the VideoBLIP sample's 128 new tokens after its prompt
HF = hf_config(max_position_embeddings=512)
pytestmark = pytest.mark.skipif(not decoder_available(), reason="native decoder unavailable")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The port's export of a tiny random model (weights drawn for the JAX
    model and carried over), and two short y4m videos."""
    root = tmp_path_factory.mktemp("samples")
    params = write_checkpoint(str(root / "source"), HF, seed=21)
    config = config_from_hf_dict(HF)
    model = VideoBlipForConditionalGeneration(config, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), config), strict=True)
    ckpt = root / "checkpoint"
    export_hf_safetensors(model, config, str(ckpt))
    (ckpt / "config.json").write_text(json.dumps(HF))
    build_tiny_tokenizer(str(ckpt), vocab_size=HF["text_config"]["vocab_size"])
    videos = []
    for i, n in enumerate((60, 90)):
        videos.append(str(root / f"video_{i}.y4m"))
        _write_y4m(videos[-1], nframes=n, w=32, h=16, fps=10)
    return str(ckpt), videos


def _jax_sample(name: str, argv: list, capsys) -> str:
    old = sys.argv
    sys.argv = [name, *argv]
    try:
        runpy.run_path(os.path.join(REPO, "samples", name), run_name="__main__")
    finally:
        sys.argv = old
    out = capsys.readouterr().out  # the text may hold newlines of its own
    assert "Generated_text: " in out and out.endswith("\n")
    return out[out.rindex("Generated_text: ") + len("Generated_text: "):-1]


def test_eilev_sample_matches_jax(world, capsys):
    ckpt, videos = world
    argv = [videos[0], "What is the camera wearer doing? He opens a drawer.", videos[1],
            "What is the camera wearer doing?", "--model", ckpt, "--dtype", "fp32"]
    ours = eilev_sample.main(argv + ["--device", "cpu"])
    assert _jax_sample("eilev_generate_action_narration.py", argv, capsys) == ours
    prompts, frames = eilev_sample.read_videos_and_texts(argv[:4])
    assert [n for _, n in prompts] == [1, 1] and frames[1].shape == (3, eilev_sample.NUM_FRAMES, 16, 32)


def test_video_blip_sample_matches_jax(world, capsys, monkeypatch):
    ckpt, videos = world
    monkeypatch.setattr(decoding, "_seeded_noise", lambda generator, device: replay(jax.random.PRNGKey(0)))
    argv = [videos[1], "What is the camera wearer doing?", "--model", ckpt, "--dtype", "fp32"]
    ours = vblip_sample.main(argv + ["--device", "cpu"])
    assert _jax_sample("video_blip_generate_action_narration.py", argv, capsys) == ours
    assert ours, "the sample generated no text"
    assert vblip_sample.read_video(videos[1]).shape == (3, 9, 16, 32)  # 9 s at ~1 frame a second

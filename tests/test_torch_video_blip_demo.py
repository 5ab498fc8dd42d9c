"""Port vs JAX: the VideoBLIP v1 chat demo (``eilev_tpu_torch/demo/video_blip_demo.py``)
against the JAX demo (``demo/video_blip_demo.py``, loaded as
``tests/integration/test_demo_and_std_sent.py`` loads it) on a tiny v1
checkpoint written by the JAX package's exporter, in fp32 on the CPU.

The video's frames are read by the JAX package's prebuilt decoder and handed
to the port through ``set_frames`` (and, where the port's own decoder builds,
read by it through ``set_video``: the same frames). Two turns of sampling
(temperature 0.7, top_p 0.9, 128 new tokens) over the running dialogue, with
the port's Gumbel noise replaced by JAX's draws from
``PRNGKey(<the turn generator's seed>)`` (``tests/test_torch_sampling.replay``):
the seed must be the dialogue's length, the key the JAX demo uses, and
the replies and the dialogue must be identical. With ``top_k`` 1 a turn
gives greedy ``generate``'s tokens. The LAVIS spec and its gating as
in the JAX test.
"""

import dataclasses
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from eilev_tpu.native import VideoDecoder as JVideoDecoder
from eilev_tpu_torch.demo import video_blip_demo
from eilev_tpu_torch.generation import decoding
from eilev_tpu_torch.native import decoder_available

from ._torch_hf import hf_config, write_checkpoint
from .data.test_native_decoder import _write_y4m
from .test_torch_sampling import replay

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_demo():
    spec = importlib.util.spec_from_file_location("video_blip_demo", os.path.join(REPO, "demo", "video_blip_demo.py"))
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    return demo


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("v1_chat")
    # room for two turns of 128 new tokens after the dialogue
    write_checkpoint(str(root / "checkpoint"), hf_config(max_position_embeddings=512), seed=23, tokenizer=True)
    video = str(root / "clip.y4m")
    _write_y4m(video, nframes=125, w=32, h=16, fps=10)
    return str(root / "checkpoint"), video


def test_v1_chat_matches_jax(world, monkeypatch):
    ckpt, video = world
    seeds = []

    def jax_noise(generator, device):
        seeds.append(generator.initial_seed())
        return replay(jax.random.PRNGKey(generator.initial_seed()))

    monkeypatch.setattr(decoding, "_seeded_noise", jax_noise)
    ref = _jax_demo().VideoBlipChat(ckpt, dtype_name="fp32")
    ref.set_video(video)
    chat = video_blip_demo.VideoBlipChat.load(ckpt, dtype_name="fp32", device="cpu")
    with JVideoDecoder(video) as dec:
        frames = dec.decode_clip(0.0, min(10.0, dec.duration), max(int(min(10.0, dec.duration)), 1))
    assert frames.shape == (3, 10, 16, 32)  # the first 10 s at one frame a second
    chat.set_frames(frames)
    np.testing.assert_allclose(chat.pixel.numpy(), np.asarray(ref.pixel), atol=1e-5)
    if decoder_available():
        assert chat.set_video(video) == f"[video loaded: {video}]"
        np.testing.assert_allclose(chat.pixel.numpy(), np.asarray(ref.pixel), atol=1e-5)

    for question in ("What is the camera wearer doing?", "And then?"):
        reply = chat.respond(question)
        assert reply == ref.respond(question)
        assert chat.dialogue == ref.dialogue
    assert seeds == [1, 3]  # len(dialogue) after each question, as JAX's PRNGKey(len(dialogue))
    assert chat.last_tokens.shape == (1, 128)
    assert len(chat.dialogue) == 4 and chat.dialogue[2] == "Question: And then? Answer:"


def test_v1_chat_top_k_1_is_greedy(world):
    """With top_k 1 a turn's sample is the greedy continuation."""
    from eilev_tpu_torch.generation import GenerationConfig, generate

    ckpt, video = world
    chat = video_blip_demo.VideoBlipChat.load(ckpt, dtype_name="fp32", device="cpu")
    chat.set_frames(np.random.default_rng(0).integers(0, 256, (3, 10, 16, 32), dtype=np.uint8))
    chat.generation_config = dataclasses.replace(chat.generation_config, top_k=1, max_new_tokens=16)
    chat.respond("What is the camera wearer doing?")
    ids = torch.as_tensor(chat.tokenizer(chat.dialogue[0])["input_ids"])[None]
    greedy = generate(chat.model, input_ids=ids, pixel_values=chat.pixel,
                      generation_config=GenerationConfig(max_new_tokens=16, pad_token_id=chat.tokenizer.pad_token_id))
    assert torch.equal(chat.last_tokens, greedy)


def test_video_blip_demo_lavis_spec_and_gating():
    """``tests/integration/test_demo_and_std_sent.py``'s LAVIS case on the port."""
    assert video_blip_demo.parse_lavis_spec("lavis:blip2_vicuna_instruct:vicuna7b") == (
        "blip2_vicuna_instruct", "vicuna7b",
    )
    for bad in ("lavis:name", "hf:name:type", "lavis::type", "lavis:name:"):
        with pytest.raises(ValueError, match="lavis:<name>:<model_type>"):
            video_blip_demo.parse_lavis_spec(bad)

    try:
        import lavis  # noqa: F401

        pytest.skip("lavis installed; gating path not exercised")
    except ImportError:
        pass
    with pytest.raises(SystemExit, match="salesforce-lavis"):
        video_blip_demo.LavisChat("lavis:blip2_vicuna_instruct:vicuna7b", "some-llm")
    with pytest.raises(SystemExit, match="requires --lavis_llm_model"):
        video_blip_demo.main(["--model", "lavis:blip2_vicuna_instruct:vicuna7b"])

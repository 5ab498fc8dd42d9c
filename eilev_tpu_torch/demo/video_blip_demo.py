"""Interactive VideoBLIP (v1) chat about one video (counterpart of
``demo/video_blip_demo.py``).

The video's first 10 seconds at about one frame a second (the native
decoder, ``native/``); each turn's prompt is the running dialogue
("Question: ... Answer:" and the replies), its reply sampled (temperature
0.7, top_p 0.9, 128 new tokens) by the v1 model, which prepends the video's
features, on ``--device`` (the card by default). Each turn draws from a
``torch.Generator`` seeded with the dialogue's length, where the JAX demo
uses ``PRNGKey(len(dialogue))``. A terminal chat:

    python -m eilev_tpu_torch.demo.video_blip_demo --model DIR [--video clip.mp4]

(``/video <path>`` loads a video, ``/quit`` ends). ``--model
lavis:<name>:<model_type>`` with ``--lavis_llm_model`` serves a LAVIS-format
checkpoint through the optional ``lavis`` package instead.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from ..samples.video_blip_generate_action_narration import DTYPES, read_video


class VideoBlipChat:
    """A dialogue about one video with a loaded v1 ``model`` and
    ``tokenizer``; :meth:`load` reads them from a checkpoint directory.
    ``generation_config`` is each turn's decoding (the JAX demo's sampling),
    ``last_tokens`` the last turn's tokens."""

    def __init__(self, model, tokenizer):
        from ..generation import GenerationConfig

        self.model = model
        self.config = model.config
        self.tokenizer = tokenizer
        self.device = next(model.parameters()).device
        self.generation_config = GenerationConfig(max_new_tokens=128, do_sample=True, temperature=0.7, top_p=0.9,
                                                  pad_token_id=tokenizer.pad_token_id)
        self.pixel = None
        self.dialogue: list[str] = []
        self.last_tokens = None

    @classmethod
    def load(cls, model_path: str, processor_path: Optional[str] = None, dtype_name: str = "bf16",
             device: str = "cuda") -> "VideoBlipChat":
        from ..models.auto import load_model, load_tokenizer

        model, _ = load_model(model_path, version="v1", dtype=DTYPES[dtype_name], device=device)
        return cls(model, load_tokenizer(processor_path or model_path))

    def set_video(self, path: str) -> str:
        self.set_frames(read_video(path))
        return f"[video loaded: {path}]"

    def set_frames(self, frames: np.ndarray) -> None:
        """Start a dialogue about one video's (C, T, H, W) uint8 ``frames``,
        preprocessed on the model's device."""
        from ..ops.preprocess import process_videos

        img = self.config.vision_config.image_size
        self.pixel = process_videos(torch.from_numpy(np.ascontiguousarray(frames[None])).to(self.device),
                                    height=img, width=img, dtype=self.model.compute_dtype)
        self.dialogue = []

    def respond(self, question: str) -> str:
        """Add the question to the dialogue and sample the reply to the whole
        dialogue from a generator seeded with the dialogue's length."""
        from ..generation import generate

        if self.pixel is None:
            raise RuntimeError("load a video first")
        self.dialogue.append(f"Question: {question} Answer:")
        ids = torch.as_tensor(self.tokenizer(" ".join(self.dialogue))["input_ids"], device=self.device)[None]
        generator = torch.Generator(device=self.device).manual_seed(len(self.dialogue))
        self.last_tokens = generate(self.model, input_ids=ids, pixel_values=self.pixel,
                                    generation_config=self.generation_config, generator=generator)
        reply = self.tokenizer.batch_decode(self.last_tokens.cpu().numpy(), skip_special_tokens=True)[0].strip()
        self.dialogue.append(reply)
        return reply


def parse_lavis_spec(model_arg: str) -> tuple[str, str]:
    """``lavis:<name>:<model_type>`` -> (name, model_type)."""
    parts = model_arg.split(":")
    if len(parts) != 3 or parts[0] != "lavis" or not parts[1] or not parts[2]:
        raise ValueError(f"bad LAVIS model spec {model_arg!r}; expected lavis:<name>:<model_type>")
    return parts[1], parts[2]


class LavisChat:
    """The LAVIS backend: a LAVIS registry model generating through its own
    API (4 beams, temperature 0.7) on ``device``. Needs the optional
    ``lavis`` (salesforce-lavis) and ``omegaconf`` packages."""

    def __init__(self, model_spec: str, llm_model: str, device: str = "cuda"):
        name, model_type = parse_lavis_spec(model_spec)
        try:
            from lavis.common.registry import registry
            from lavis.models import load_preprocess
            from omegaconf import OmegaConf
        except ImportError as e:
            raise SystemExit(
                "the LAVIS backend needs the optional 'lavis' (salesforce-lavis) "
                "and 'omegaconf' packages; install them or use an HF-format "
                f"--model instead ({e})"
            )
        model_cls = registry.get_model_class(name)
        cfg = OmegaConf.load(model_cls.default_config_path(model_type))
        model_cfg = cfg.model
        model_cfg.update(llm_model=llm_model)
        self.model = model_cls.from_config(model_cfg).eval()
        if device == "cpu":
            self.model = self.model.float()
        self.model = self.model.to(device)
        self.device = device
        vis_processors, _ = load_preprocess(cfg.preprocess)
        self.vis_processor = vis_processors["eval"]
        # the decoder yields arrays already: drop the ToTensor transform
        try:
            del self.vis_processor.transform.transforms[-2]
        except (AttributeError, IndexError):
            pass
        self.frames = None
        self.dialogue: list[str] = []

    def set_video(self, path: str) -> str:
        self.frames = torch.from_numpy(read_video(path)).float()
        self.dialogue = []
        return f"[video loaded: {path}]"

    def respond(self, question: str) -> str:
        if self.frames is None:
            raise RuntimeError("load a video first")
        self.dialogue.append(f"Question: {question} Answer:")
        prompt = " ".join(self.dialogue)
        frames = self.frames.unsqueeze(0)  # (1, C, T, H, W)
        batch, channel, time, _, _ = frames.size()
        flat = self.vis_processor(frames.permute(0, 2, 1, 3, 4).flatten(end_dim=1))
        _, _, height, width = flat.size()
        frames = flat.view(batch, time, channel, height, width).permute(0, 2, 1, 3, 4).to(self.device)
        with torch.no_grad():
            reply = self.model.generate({"image": frames, "prompt": prompt}, max_length=len(prompt) + 128,
                                        num_beams=4, temperature=0.7)[0]
        self.dialogue.append(reply)
        return reply


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", required=True,
                   help="HF save_pretrained dir, or lavis:<name>:<model_type> for a LAVIS-format checkpoint "
                        "(needs --lavis_llm_model)")
    p.add_argument("--processor", default=None)
    p.add_argument("--dtype", choices=list(DTYPES), default="bf16")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    p.add_argument("--video", default=None, help="preload a video")
    p.add_argument("--lavis_llm_model", default=None, help="LLM weights path for the LAVIS backend")
    return p.parse_args(argv)


def main(argv: Optional[list[str]] = None) -> None:
    args = parse_args(argv)
    if args.model.startswith("lavis:"):
        if args.lavis_llm_model is None:
            raise SystemExit("--model lavis:... requires --lavis_llm_model")
        chat = LavisChat(args.model, args.lavis_llm_model, device=args.device)
    else:
        chat = VideoBlipChat.load(args.model, args.processor, args.dtype, device=args.device)
    if args.video:
        print(chat.set_video(args.video))
    print("VideoBLIP chat. Commands: /video <path>, /quit")
    while True:
        try:
            line = input("> ").strip()
        except EOFError:
            break
        if not line:
            continue
        if line == "/quit":
            break
        if line.startswith("/video "):
            print(chat.set_video(line[len("/video "):].strip()))
            continue
        print(chat.respond(line))


if __name__ == "__main__":
    main()

"""Generate an action narration with VideoBLIP v1: one video and a text
prompt (counterpart of ``samples/video_blip_generate_action_narration.py``).

The video's first 10 seconds are read at about one frame a second by the
native decoder (``eilev_tpu_torch/native``); decoding is the original
sample's sampling (temperature 0.7, top_p 0.9, 128 new tokens) from a
generator on the card seeded with 0.

    python -m eilev_tpu_torch.samples.video_blip_generate_action_narration \\
        video.mp4 "What is the camera wearer doing?" --model /path/to/video-blip-opt-2.7b-ego4d
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
SECONDS = 10.0


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("video")
    p.add_argument("prompt")
    p.add_argument("--model", required=True, help="HF save_pretrained dir (v1 checkpoint)")
    p.add_argument("--processor", default=None)
    p.add_argument("--dtype", choices=list(DTYPES), default="bf16")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    return p.parse_args(argv)


def read_video(path: str) -> np.ndarray:
    """The first 10 seconds at about one frame a second: (C, T, H, W) uint8."""
    from ..native import VideoDecoder

    with VideoDecoder(path) as dec:
        end = min(SECONDS, dec.duration)
        return dec.decode_clip(0.0, end, max(int(end), 1))


def run(model, tokenizer, frames: np.ndarray, prompt: str, dtype: torch.dtype = torch.bfloat16,
        generator: Optional[torch.Generator] = None) -> str:
    """Narrate one video's (C, T, H, W) uint8 ``frames`` after ``prompt`` on the
    model's device (a v1 model prepends the video's features); the sampling
    draws come from ``generator`` (default: one on the model's device seeded
    with 0)."""
    from ..generation import GenerationConfig, generate
    from ..ops.preprocess import process_videos

    device = next(model.parameters()).device
    img = model.config.vision_config.image_size
    pixel = process_videos(torch.from_numpy(frames[None]).to(device), height=img, width=img, dtype=dtype)
    ids = torch.as_tensor(tokenizer(prompt.strip())["input_ids"], device=device)[None]
    tokens = generate(
        model,
        input_ids=ids,
        pixel_values=pixel,
        generation_config=GenerationConfig(max_new_tokens=128, do_sample=True, temperature=0.7, top_p=0.9,
                                           pad_token_id=tokenizer.pad_token_id),
        generator=generator,
    )
    return tokenizer.batch_decode(tokens.cpu().numpy(), skip_special_tokens=True)[0].strip()


def main(argv: Optional[list[str]] = None) -> str:
    args = parse_args(argv)
    from ..models.auto import load_model, load_tokenizer

    dtype = DTYPES[args.dtype]
    model, _ = load_model(args.model, version="v1", dtype=dtype, device=args.device)
    tokenizer = load_tokenizer(args.processor or args.model)
    text = run(model, tokenizer, read_video(args.video), args.prompt, dtype=dtype)
    print(f"Generated_text: {text}")
    return text


if __name__ == "__main__":
    main()

"""Generate an action narration from interleaved videos and texts with EILeV
(counterpart of ``samples/eilev_generate_action_narration.py``).

Alternating video-file and text arguments build the interleaved prompt; each
video's first 8 seconds are read as 8 uniform frames by the native decoder
(``eilev_tpu_torch/native``). Decoding is the original sample's: beam 5, 32
new tokens, length_penalty -1 and, for OPT, the newline (50118) as eos
(LAVIS's BLIP-2 convention).

    python -m eilev_tpu_torch.samples.eilev_generate_action_narration \\
        video_1.mp4 "What is the camera wearer doing? He's fixing a bicycle." \\
        video_2.mp4 "What is the camera wearer doing?" \\
        --model /path/to/eilev-blip2-opt-2.7b
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
CLIP_SECONDS = 8
NUM_FRAMES = 8
NEWLINE = 50118  # OPT's "\n"


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("videos_and_texts", nargs="+",
                   help="space-separated videos and texts; file paths are videos, the rest text")
    p.add_argument("--model", required=True, help="HF save_pretrained dir")
    p.add_argument("--processor", default=None)
    p.add_argument("--dtype", choices=list(DTYPES), default="bf16")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    return p.parse_args(argv)


def read_videos_and_texts(videos_and_texts: list[str]) -> tuple[list[tuple[str, int]], list[np.ndarray]]:
    """The interleaved prompt blocks ``[(text, num_videos), ...]`` and each
    video's (C, T, H, W) uint8 frames: a video starts a new block when the
    block before it has text."""
    from ..native import VideoDecoder

    prompts: list[tuple[str, int]] = [("", 0)]
    frames: list[np.ndarray] = []
    for arg in videos_and_texts:
        stripped = arg.strip()
        if os.path.isfile(stripped):
            if prompts[-1][0] != "":
                prompts.append(("", 0))
            with VideoDecoder(stripped) as dec:
                frames.append(dec.decode_clip(0.0, min(CLIP_SECONDS, dec.duration), NUM_FRAMES))
            text, n = prompts[-1]
            prompts[-1] = (text, n + 1)
        else:
            text, n = prompts[-1]
            prompts[-1] = ((text + " " + stripped).strip(), n)
    return prompts, frames


def run(model, tokenizer, prompts: list[tuple[str, int]], frames: list[np.ndarray],
        dtype: torch.dtype = torch.bfloat16) -> str:
    """Narrate: ``prompts`` as from :func:`read_videos_and_texts`, ``frames``
    one (C, T, H, W) uint8 array a video, on the model's device."""
    from ..configs import OPTConfig
    from ..data.prompts import generate_input_ids_and_labels_from_interleaved
    from ..generation import GenerationConfig, generate
    from ..ops.preprocess import process_videos

    config = model.config
    device = next(model.parameters()).device
    inputs = generate_input_ids_and_labels_from_interleaved(
        tokenizer, prompts, None, config.num_query_tokens, config.use_decoder_only_language_model)
    img = config.vision_config.image_size
    pixel = process_videos(torch.from_numpy(np.stack(frames)).to(device), height=img, width=img, dtype=dtype)
    gen_cfg = GenerationConfig(max_new_tokens=32, num_beams=5, do_sample=False, length_penalty=-1.0,
                               pad_token_id=tokenizer.pad_token_id)
    if isinstance(config.text_config, OPTConfig):
        gen_cfg = gen_cfg.with_eos(NEWLINE)
    tokens = generate(
        model,
        input_ids=torch.as_tensor(np.asarray(inputs["input_ids"]), device=device)[None],
        pixel_values=pixel,
        video_input_mask=torch.as_tensor(np.asarray(inputs["video_input_mask"]), device=device)[None],
        generation_config=gen_cfg,
    )
    return tokenizer.batch_decode(tokens.cpu().numpy(), skip_special_tokens=True)[0].strip()


def main(argv: Optional[list[str]] = None) -> str:
    args = parse_args(argv)
    from ..models.auto import load_model, load_tokenizer

    dtype = DTYPES[args.dtype]
    model, _ = load_model(args.model, dtype=dtype, device=args.device)
    tokenizer = load_tokenizer(args.processor or args.model)
    prompts, frames = read_videos_and_texts(args.videos_and_texts)
    text = run(model, tokenizer, prompts, frames, dtype=dtype)
    print(f"Generated_text: {text}")
    return text


if __name__ == "__main__":
    main()

"""Save mean-pooled vision-tower embeddings per clip, for t-SNE analysis
(counterpart of ``scripts/get_vision_model_embs.py``).

Runs the video vision tower (``VideoBlipForConditionalGeneration.vision_forward``,
whose ViT runs K1) on ``--device`` (the card by default), mean-pools the
per-frame pooler outputs over time, and writes ``<output_prefix>_embs.npy``
(clips x hidden, fp32) and ``<output_prefix>_index.json`` (the clips'
frame_paths).

    python -m eilev_tpu_torch.cli.get_vision_model_embs --model DIR --frames_dir FRAMES \\
        --output_prefix embs/val
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np
import torch

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", required=True)
    p.add_argument("--dtype", choices=list(DTYPES), default="bf16")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    p.add_argument("--frames_dir", required=True)
    p.add_argument("--annotation_file", default=None)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_subsample_frames", type=int, default=8)
    p.add_argument("--output_prefix", required=True)
    return p.parse_args(argv)


def run(args: argparse.Namespace, model, dataset) -> np.ndarray:
    """Embed every clip of ``dataset`` (a sequence of datapoints with a uint8
    ``video`` and a ``frame_path``) in batches of ``--batch_size``; write the
    two files. Returns the (clips, hidden) embeddings."""
    from ..data.text import generate_chunks
    from ..ops.preprocess import process_videos

    dtype, device = DTYPES[args.dtype], torch.device(args.device)
    img = model.config.vision_config.image_size
    embs, paths = [], []
    for chunk in generate_chunks(list(range(len(dataset))), args.batch_size):
        items = [dataset[i] for i in chunk]
        videos = torch.from_numpy(np.stack([it["video"] for it in items])).to(device)
        pixel = process_videos(videos, num_frames=args.num_subsample_frames, height=img, width=img, dtype=dtype)
        with torch.no_grad():
            _, pooled = model.vision_forward(pixel)
        embs.append(pooled.mean(dim=1).float().cpu().numpy())  # (V, T, D) -> (V, D): mean over time
        paths.extend(it["frame_path"] for it in items)
        print(f"embedded {len(paths)}/{len(dataset)}", flush=True)

    out = np.concatenate(embs)
    np.save(args.output_prefix + "_embs.npy", out)
    with open(args.output_prefix + "_index.json", "w") as f:
        json.dump(paths, f)
    print(f"wrote {len(paths)} embeddings to {args.output_prefix}_embs.npy")
    return out


def main(argv: Optional[list[str]] = None) -> np.ndarray:
    args = parse_args(argv)
    from ..data.frame import FrameDataset
    from ..models.auto import load_model

    model, _ = load_model(args.model, dtype=DTYPES[args.dtype], device=args.device)
    return run(args, model, FrameDataset(args.frames_dir, annotation_file=args.annotation_file))


if __name__ == "__main__":
    main()

"""Fine-tune a VideoMAE verb or noun classifier on extracted frames
(counterpart of ``scripts/baselines/videomae_train.py``).

The original's baselines/videomae/videomae_train.py: FrameDataset filtered
to labeled actions, label set = sorted union of train+val classes, train
transform = subsample -> rescale/normalize (ImageNet statistics) ->
RandomShortSideScale (256-320) -> RandomCrop -> HFlip, eval transform a
deterministic resize; macro F1. A full fine-tune (every parameter
trainable) with AdamW (optax's ``adamw`` over a warmup + linear-decay
schedule, weight decay 0.05, no gradient clipping, as in JAX), on
``--device`` (the card by default). The augmentation draws come from a
CPU ``torch.Generator`` seeded with ``--seed``; the clips of a batch are
drawn by ``random.Random(--seed)``, as in JAX.

It writes ``params.pkl`` (a numpy tree in flax names, the JAX script's
format: a classifier trained by either package loads in the other) and
``labels.json``.

    python -m eilev_tpu_torch.cli.baselines.videomae_train --verb \\
        --train_frames_dir TRAIN --val_frames_dir VAL --output_dir videomae-verb
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import random
import time
from typing import Any, Optional

import numpy as np
import torch

IMAGENET_MEAN, IMAGENET_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_name_or_path", default=None,
                   help="local HF VideoMAE dir to initialize from (random init if omitted)")
    p.add_argument("--verb", action="store_true", help="train the verb classifier (else noun)")
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--train_frames_dir", required=True)
    p.add_argument("--val_frames_dir", required=True)
    p.add_argument("--train_annotation_file", default=None)
    p.add_argument("--val_annotation_file", default=None)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--num_train_steps", type=int, default=2000)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--learning_rate", type=float, default=5e-5)
    p.add_argument("--warmup_steps", type=int, default=100)
    p.add_argument("--eval_steps", type=int, default=200)
    p.add_argument("--logging_steps", type=int, default=20)
    p.add_argument("--seed", type=int, default=42)
    # tiny-config knobs for smoke tests
    p.add_argument("--hidden_size", type=int, default=768)
    p.add_argument("--num_hidden_layers", type=int, default=12)
    p.add_argument("--num_attention_heads", type=int, default=12)
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    return p.parse_args(argv)


def labeled(item) -> bool:
    return item["structured_verb"] not in {"", "[other]"} and item["structured_noun"] != ""


def load_datasets(args: argparse.Namespace) -> dict[str, Any]:
    from ...data.frame import FrameDataset

    return {"train": FrameDataset(args.train_frames_dir, annotation_file=args.train_annotation_file,
                                  data_filter=labeled),
            "val": FrameDataset(args.val_frames_dir, annotation_file=args.val_annotation_file,
                                data_filter=labeled)}


def train_item(generator: torch.Generator, video: torch.Tensor, num_frames: int, image_size: int) -> torch.Tensor:
    """The train transform of one uint8 (C, T, H, W) clip, on its device."""
    from ...ops import preprocess as pp

    x = pp.uniform_temporal_subsample(video, num_frames)
    x = pp.normalize(pp.rescale(x), IMAGENET_MEAN, IMAGENET_STD)
    x = pp.random_short_side_scale(generator, x, 256, 320)
    x = pp.random_crop(generator, x, image_size, image_size)
    return pp.random_horizontal_flip(generator, x)


def eval_item(video: torch.Tensor, num_frames: int, image_size: int) -> torch.Tensor:
    """The deterministic eval transform of one uint8 (C, T, H, W) clip."""
    from ...ops import preprocess as pp

    x = pp.uniform_temporal_subsample(video, num_frames)
    x = pp.normalize(pp.rescale(x), IMAGENET_MEAN, IMAGENET_STD)
    return pp.resize_video(x, image_size, image_size)


def build_model(args: argparse.Namespace, num_labels: int, init_params=None):
    """The classifier on ``--device``: the flax initializers from ``--seed``,
    the backbone from ``--model_name_or_path`` when given (the classifier
    head stays fresh, HF's ``ignore_mismatched_sizes``), or ``init_params``
    (a numpy tree in flax names, as ``params.pkl`` holds)."""
    from ...models.convert import flax_to_state_dict
    from ...models.safetensors_io import SafetensorsDirectory
    from ...models.videomae import VideoMAEConfig, VideoMAEForVideoClassification, convert_videomae

    cfg = VideoMAEConfig(
        image_size=args.image_size,
        num_frames=args.num_frames,
        hidden_size=args.hidden_size,
        num_hidden_layers=args.num_hidden_layers,
        num_attention_heads=args.num_attention_heads,
        intermediate_size=args.hidden_size * 4,
        num_labels=num_labels,
    )
    model = VideoMAEForVideoClassification(cfg, device="cpu").init_weights_(
        torch.Generator().manual_seed(args.seed))
    if init_params is not None:
        model.load_state_dict(flax_to_state_dict(init_params), strict=True)
    elif args.model_name_or_path:
        with SafetensorsDirectory(args.model_name_or_path) as src:
            loaded = convert_videomae({k: src.get_tensor(k) for k in src.keys()}, cfg)
        head = {k: v for k, v in model.state_dict().items() if k.startswith("classifier.")}
        model.load_state_dict({**loaded, **head}, strict=True)
    return model.to(args.device)


def run(args: argparse.Namespace, datasets: dict[str, Any], init_params=None) -> dict[str, Any]:
    """Train on ``datasets["train"]``, evaluating macro F1 on
    ``datasets["val"]`` every ``--eval_steps`` (sequences of datapoints with a
    uint8 ``video`` clip and the label columns; a ``FrameDataset``'s ``.data``
    gives the label set without reading frames). Writes ``params.pkl`` and
    ``labels.json`` under ``--output_dir``. Returns the model, the labels and
    every step's loss and seconds."""
    from ...eval.metrics import MulticlassF1
    from ...models.convert import state_dict_to_flax
    from ...training.train_state import OptimizerConfig, make_optimizer

    train_data, val_data = datasets["train"], datasets["val"]
    device = torch.device(args.device)
    label_key = "structured_verb" if args.verb else "structured_noun"
    labels = sorted({d[label_key] for d in getattr(train_data, "data", train_data)}
                    | {d[label_key] for d in getattr(val_data, "data", val_data)})
    label2id = {l: i for i, l in enumerate(labels)}
    print(f"{len(labels)} classes for {label_key}")

    model = build_model(args, len(labels), init_params)
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    tx = make_optimizer(OptimizerConfig(
        learning_rate=args.learning_rate, warmup_steps=args.warmup_steps, total_steps=args.num_train_steps,
        weight_decay=0.05, max_grad_norm=None))
    opt_state = tx.init({k: p.detach() for k, p in params.items()})

    def clip(item) -> torch.Tensor:
        return torch.from_numpy(np.asarray(item["video"])).to(device)

    py_rng = random.Random(args.seed)
    generator = torch.Generator().manual_seed(args.seed)
    losses: list[float] = []
    step_seconds: list[float] = []  # host clock a step, its loss read included
    step = 0
    model.train()
    while step < args.num_train_steps:
        t0 = time.perf_counter()
        idx = [py_rng.randrange(len(train_data)) for _ in range(args.batch_size)]
        items = [train_data[i] for i in idx]
        pixel = torch.stack([train_item(generator, clip(it), args.num_frames, args.image_size) for it in items])
        label = torch.tensor([label2id[it[label_key]] for it in items], device=device)
        loss = model(pixel, labels=label)["loss"]
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        with torch.no_grad():
            updates, opt_state = tx.update(grads, opt_state, {k: p.detach() for k, p in params.items()})
            for k, p in params.items():
                p.add_(updates[k])
        step += 1
        losses.append(float(loss.detach()))
        step_seconds.append(time.perf_counter() - t0)
        if step % args.logging_steps == 0:
            print(f"step {step}: loss {losses[-1]:.4f}", flush=True)
        if args.eval_steps and step % args.eval_steps == 0:
            f1 = MulticlassF1(len(labels))
            with torch.no_grad():
                for i in range(0, len(val_data), args.batch_size):
                    batch = [val_data[j] for j in range(i, min(i + args.batch_size, len(val_data)))]
                    pixel = torch.stack([eval_item(clip(it), args.num_frames, args.image_size) for it in batch])
                    preds = model(pixel)["logits"].argmax(-1).cpu().numpy()
                    f1.update(preds, [label2id[it[label_key]] for it in batch])
            print(f"step {step}: val macro F1 {f1.compute():.4f}", flush=True)

    model.eval().requires_grad_(False)
    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "params.pkl"), "wb") as f:
        pickle.dump(state_dict_to_flax(model), f)
    with open(os.path.join(args.output_dir, "labels.json"), "w") as f:
        json.dump({"labels": labels, "label_key": label_key, "config": model.config.__dict__}, f)
    print(f"saved classifier to {args.output_dir}")
    return {"model": model, "labels": labels, "losses": losses, "step_seconds": step_seconds}


def main(argv: Optional[list[str]] = None) -> dict[str, Any]:
    args = parse_args(argv)
    return run(args, load_datasets(args))


if __name__ == "__main__":
    main()

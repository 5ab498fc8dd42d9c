"""VideoBLIP (v1) training: single-video narration fine-tuning with a fixed
instruction prompt (counterpart of ``scripts/train_v1.py``), on the card by
default (``--device``).

The original's scripts/general/train_v1.py: the prompt 'Question: What is
the camera wearer doing? Answer:', FrameDataset with a subsample-only
transform, frozen towers; its README: batch 32 x accum 4 on one
accelerator. The model is ``models/video_blip_v1.py`` (video features
prepended), trained by ``training/trainer.Trainer``.

Data parallelism, one process a replica, as in train_v2 (``torchrun
--nproc_per_node N -m eilev_tpu_torch.cli.train_v1 ...``): each process
loads its stride of the data, ``--per_device_train_batch_size`` rows of
each micro-batch. The JAX v1 CLI has no ZeRO or pipeline flags, nor has
this one.

    python -m eilev_tpu_torch.cli.train_v1 --model_name_or_path DIR \\
        --train_frames_dir TRAIN --val_frames_dir VAL --output_dir checkpoints/v1
"""

from __future__ import annotations

import argparse
from typing import Any, Optional

import torch

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_name_or_path", required=True)
    p.add_argument("--num_subsample_frames", type=int, default=8)
    p.add_argument("--dtype", choices=list(DTYPES), default="bf16")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    p.add_argument("--train_frames_dir", required=True)
    p.add_argument("--val_frames_dir", required=True)
    p.add_argument("--train_annotation_file", default=None)
    p.add_argument("--val_annotation_file", default=None)
    p.add_argument("--max_length", type=int, default=64)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--num_train_steps", type=int, default=5000)
    p.add_argument("--remat", action="store_true",
                   help="per-layer remat of the frozen LM trunk (see train_v2)")
    p.add_argument("--per_device_train_batch_size", type=int, default=32)
    p.add_argument("--gradient_accumulation_steps", type=int, default=4)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--warmup_steps", type=int, default=1000)
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--eval_steps", type=int, default=200)
    p.add_argument("--save_steps", type=int, default=200)
    p.add_argument("--save_total_limit", type=int, default=3)
    p.add_argument("--logging_steps", type=int, default=10)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--resume_from_checkpoint", action="store_true")
    p.add_argument("--wandb_project", default=None)
    p.add_argument("--data_parallel", type=int, default=None,
                   help="data-parallel processes (default: as many as torchrun started; must equal them)")
    return p.parse_args(argv)


def data_mesh(args: argparse.Namespace):
    """Join the process group torchrun started (a no-op for one process) and
    return this process's data mesh."""
    from ..parallel.distributed import initialize
    from ..parallel.mesh import make_mesh

    initialize(args.device)
    return make_mesh(data=args.data_parallel, device=args.device)


def load_datasets(args: argparse.Namespace) -> dict[str, Any]:
    """The train and val FrameDatasets (one clip a datapoint)."""
    from ..data.frame import FrameDataset

    return {"train": FrameDataset(args.train_frames_dir, annotation_file=args.train_annotation_file),
            "val": FrameDataset(args.val_frames_dir, annotation_file=args.val_annotation_file)}


def run(args: argparse.Namespace, model, tokenizer, datasets: dict[str, Any]):
    """Train the v1 ``model`` on ``datasets["train"]`` (evaluating on
    ``datasets["val"]``; sequences of datapoints with a uint8 ``video`` clip
    and a ``narration_text``) and save checkpoints under ``--output_dir``.
    Returns the Trainer."""
    from ..training import OptimizerConfig
    from ..training.data_module import train_batch_iterator
    from ..training.trainer import Trainer, TrainerConfig
    from ..utils import WandbLogger

    mesh = data_mesh(args)
    config = model.config
    dtype = DTYPES[args.dtype]
    micro = args.per_device_train_batch_size

    def batches(dataset, seed, epochs=None, accum=None, shard=True):
        return train_batch_iterator(
            dataset,
            tokenizer,
            num_query_tokens=config.num_query_tokens,
            decoder_only_lm=config.use_decoder_only_language_model,
            accum_steps=accum if accum is not None else args.gradient_accumulation_steps,
            # training: this process's stride; eval: the whole global micro-batch on every process
            micro_batch_size=micro if shard else micro * mesh.data_size,
            process_index=mesh.data_rank if shard else 0,
            process_count=mesh.data_size if shard else 1,
            max_length=args.max_length,
            num_frames=args.num_subsample_frames,
            image_size=config.vision_config.image_size,
            augment=False,  # v1: the subsample-only transform
            seed=seed,
            epochs=epochs,
            dtype=dtype,
            interleaved=False,
            device=mesh.device,
        )

    def eval_batches():
        for batch in batches(datasets["val"], 0, epochs=1, accum=1, shard=False):
            yield {k: v[0] for k, v in batch.items()}  # drop the accum axis

    trainer = Trainer(
        model,
        TrainerConfig(
            output_dir=args.output_dir,
            num_train_steps=args.num_train_steps,
            gradient_accumulation_steps=args.gradient_accumulation_steps,
            optimizer=OptimizerConfig(
                learning_rate=args.learning_rate,
                warmup_steps=args.warmup_steps,
                total_steps=args.num_train_steps,
                weight_decay=args.weight_decay,
            ),
            eval_steps=args.eval_steps,
            save_steps=args.save_steps,
            save_total_limit=args.save_total_limit,
            log_steps=args.logging_steps,
            seed=args.seed,
            resume_from_checkpoint=args.resume_from_checkpoint,
        ),
        train_batches=lambda seed: batches(datasets["train"], seed),
        eval_batches=eval_batches,
        logger=WandbLogger(project=args.wandb_project, enabled=args.wandb_project is not None),
        mesh=mesh,
    )
    trainer.train()
    return trainer


def main(argv: Optional[list[str]] = None):
    args = parse_args(argv)
    from ..models.auto import load_model, load_tokenizer

    model, _ = load_model(args.model_name_or_path, version="v1", dtype=DTYPES[args.dtype], remat=args.remat,
                          device=data_mesh(args).device)
    tokenizer = load_tokenizer(args.model_name_or_path)
    return run(args, model, tokenizer, load_datasets(args))


if __name__ == "__main__":
    main()

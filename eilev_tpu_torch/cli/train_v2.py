"""EILeV (v2) training: interleaved in-context fine-tuning of the Q-Former,
language projection and query tokens on frozen towers (counterpart of
``scripts/train_v2.py``), on one device (``--device``, the card by default).

    python -m eilev_tpu_torch.cli.train_v2 --model_name_or_path DIR \\
        --train_frames_dir TRAIN --val_frames_dir VAL --num_subsample_frames 8 \\
        --train_num_in_context_examples_per_sample 16 \\
        --val_num_in_context_examples_per_sample 16 --verb_noun_ratio 0.5 \\
        --output_dir checkpoints/eilev-opt --export_hf

With ``--export_hf`` the trained model is written to ``<output_dir>/hf`` as
an HF ``save_pretrained`` directory (``model.safetensors`` in fp32 and the
source checkpoint's ``config.json``), which both packages' ``load_model``
read.
"""

from __future__ import annotations

import argparse
import os
import random
import shutil
from typing import Any, Optional

import torch

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    # model
    p.add_argument("--model_name_or_path", required=True, help="HF save_pretrained dir")
    p.add_argument("--num_subsample_frames", type=int, default=8)
    p.add_argument("--dtype", choices=list(DTYPES), default="bf16")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    # data
    p.add_argument("--train_frames_dir", required=True)
    p.add_argument("--val_frames_dir", required=True)
    p.add_argument("--train_annotation_file", default=None)
    p.add_argument("--val_annotation_file", default=None)
    p.add_argument("--train_num_in_context_examples_per_sample", type=int, default=16)
    p.add_argument("--val_num_in_context_examples_per_sample", type=int, default=16)
    p.add_argument("--verb_noun_ratio", type=float, default=0.5)
    p.add_argument("--random_in_context_examples", action="store_true")
    p.add_argument("--train_target_dataset_len", type=int, default=None)
    p.add_argument("--max_length", type=int, default=1024, help="static token bucket")
    p.add_argument("--num_workers", type=int, default=0,
                   help="thread-pool workers overlapping frame IO + tokenization (batches identical to serial)")
    # training
    p.add_argument("--output_dir", required=True)
    p.add_argument("--num_train_steps", type=int, default=None,
                   help="step cap; default derives from --num_train_epochs")
    p.add_argument("--num_train_epochs", type=int, default=5)
    p.add_argument("--zero_shard_opt_state", action="store_true", help="ZeRO-2; not ported (one device)")
    p.add_argument("--async_save", action="store_true", help="overlap checkpoint writes with training compute")
    p.add_argument("--remat", action="store_true",
                   help="per-layer rematerialization of the frozen LM trunk (layer-boundary activations only)")
    p.add_argument("--per_device_train_batch_size", type=int, default=1)
    p.add_argument("--gradient_accumulation_steps", type=int, default=16)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--warmup_steps", type=int, default=1000)
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="> 0: keep an EMA of the trainable params in the optimizer state")
    p.add_argument("--eval_steps", type=int, default=200)
    p.add_argument("--save_steps", type=int, default=200)
    p.add_argument("--save_total_limit", type=int, default=3)
    p.add_argument("--logging_steps", type=int, default=10)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--resume_from_checkpoint", action="store_true")
    p.add_argument("--wandb_project", default=None)
    p.add_argument("--data_parallel", type=int, default=None, help="data-parallel devices; the port runs on one")
    p.add_argument("--multihost", action="store_true", help="multi-process training; not ported")
    p.add_argument("--model_parallel", type=int, default=1, help="tensor-parallel devices; not ported")
    p.add_argument("--pipeline_parallel", type=int, default=0, help="> 1: pipeline stages; not ported")
    p.add_argument("--pipeline_microbatches", type=int, default=4, help="pipeline microbatches; not ported")
    p.add_argument("--export_hf", action="store_true", help="export the final model as HF safetensors")
    return p.parse_args(argv)


def check_args(args: argparse.Namespace) -> None:
    """Refuse the parallel modes, which wait for the port's ``parallel/``."""
    unported = {
        "--multihost": args.multihost,
        "--pipeline_parallel > 1": args.pipeline_parallel > 1,
        "--model_parallel > 1": args.model_parallel > 1,
        "--data_parallel > 1": (args.data_parallel or 1) > 1,
        "--zero_shard_opt_state": args.zero_shard_opt_state,
    }
    for flag, requested in unported.items():
        if requested:
            raise NotImplementedError(
                f"{flag} is not ported: the port trains on one device (it waits for parallel/)")


def load_datasets(args: argparse.Namespace) -> dict[str, Any]:
    """The interleaved train and val datasets (the val shots come from the
    train frames), seeded as in JAX."""
    from ..data.frame import FrameInterleavedDataset

    common = dict(verb_noun_ratio=args.verb_noun_ratio, random_in_context_examples=args.random_in_context_examples)
    train = FrameInterleavedDataset(
        args.train_frames_dir,
        annotation_file=args.train_annotation_file,
        num_in_context_examples_per_sample=args.train_num_in_context_examples_per_sample,
        target_dataset_len=args.train_target_dataset_len,
        rng=random.Random(args.seed),
        **common,
    )
    val = FrameInterleavedDataset(
        args.val_frames_dir,
        annotation_file=args.val_annotation_file,
        in_context_example_frames_dir=args.train_frames_dir,
        in_context_example_annotation_file=args.train_annotation_file,
        num_in_context_examples_per_sample=args.val_num_in_context_examples_per_sample,
        rng=random.Random(args.seed + 1),
        **common,
    )
    return {"train": train, "val": val}


def run(args: argparse.Namespace, model, tokenizer, datasets: dict[str, Any]):
    """Train ``model`` on ``datasets["train"]`` (evaluating on
    ``datasets["val"]``; sequences of ``{"items": [...]}`` datapoints with
    uint8 ``video`` clips), save checkpoints under ``--output_dir``, and with
    ``--export_hf`` write ``<output_dir>/hf``. Returns the Trainer."""
    from ..training import OptimizerConfig
    from ..training.checkpoint import export_hf_safetensors
    from ..training.data_module import train_batch_iterator
    from ..training.trainer import Trainer, TrainerConfig
    from ..utils import WandbLogger

    check_args(args)
    config = model.config
    dtype = DTYPES[args.dtype]
    train_data, val_data = datasets["train"], datasets["val"]
    micro = args.per_device_train_batch_size
    global_batch = micro * args.gradient_accumulation_steps
    steps_per_epoch = max(len(train_data) // global_batch, 1)
    total_steps = args.num_train_steps if args.num_train_steps is not None else steps_per_epoch * args.num_train_epochs
    batch_kw = dict(
        num_query_tokens=config.num_query_tokens,
        decoder_only_lm=config.use_decoder_only_language_model,
        max_length=args.max_length,
        num_frames=args.num_subsample_frames,
        image_size=config.vision_config.image_size,
        dtype=dtype,
        device=args.device,
    )

    def train_batches(seed):
        return train_batch_iterator(
            train_data, tokenizer, accum_steps=args.gradient_accumulation_steps, micro_batch_size=micro,
            augment=True, seed=seed, epochs=args.num_train_epochs if args.num_train_steps is None else None,
            num_workers=args.num_workers, **batch_kw,
        )

    def eval_batches():
        # the deterministic val transform, one pass
        it = train_batch_iterator(val_data, tokenizer, accum_steps=1, micro_batch_size=micro, augment=False,
                                  seed=0, epochs=1, **batch_kw)
        for batch in it:
            yield {k: v[0] for k, v in batch.items()}  # drop the accum axis

    trainer = Trainer(
        model,
        TrainerConfig(
            output_dir=args.output_dir,
            num_train_steps=total_steps,
            gradient_accumulation_steps=args.gradient_accumulation_steps,
            async_save=args.async_save,
            optimizer=OptimizerConfig(
                learning_rate=args.learning_rate,
                warmup_steps=args.warmup_steps,
                total_steps=total_steps,
                weight_decay=args.weight_decay,
                ema_decay=args.ema_decay,
            ),
            eval_steps=args.eval_steps,
            save_steps=args.save_steps,
            save_total_limit=args.save_total_limit,
            log_steps=args.logging_steps,
            seed=args.seed,
            resume_from_checkpoint=args.resume_from_checkpoint,
        ),
        train_batches=train_batches,
        eval_batches=eval_batches,
        logger=WandbLogger(project=args.wandb_project, enabled=args.wandb_project is not None),
    )
    trainer.train()

    if args.export_hf:
        out = os.path.join(args.output_dir, "hf")
        export_hf_safetensors(trainer.model, config, out)
        source_config = os.path.join(args.model_name_or_path, "config.json")
        if os.path.exists(source_config):
            shutil.copy(source_config, os.path.join(out, "config.json"))
        print(f"exported HF safetensors to {out}")
    return trainer


def main(argv: Optional[list[str]] = None):
    args = parse_args(argv)
    check_args(args)
    from ..models.auto import load_model, load_tokenizer

    model, _ = load_model(args.model_name_or_path, dtype=DTYPES[args.dtype], remat=args.remat, device=args.device)
    tokenizer = load_tokenizer(args.model_name_or_path)
    return run(args, model, tokenizer, load_datasets(args))


if __name__ == "__main__":
    main()

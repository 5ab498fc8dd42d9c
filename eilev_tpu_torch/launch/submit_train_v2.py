"""Write and run or submit an EILeV v2 training job (counterpart of
``launch/submit_train_v2.py``): ``cli.train_v2`` data-parallel over
``--num_gpus`` cards of one host (``torchrun --nproc_per_node N``), with the
gradient accumulation worked out from the global batch as the reference's
recipe does: global batch 128 = accumulation 16 x 8 GPUs x per-device 1.

    python -m eilev_tpu_torch.launch.submit_train_v2 --num_gpus 8 --train_batch_size 128 \\
        -- --model_name_or_path DIR --train_frames_dir ... --output_dir OUT
"""

from __future__ import annotations

import argparse
from typing import Optional

from .launch_lib import add_common_args, finish, forwarded

MODULE = "eilev_tpu_torch.cli.train_v2"


def main(argv: Optional[list[str]] = None) -> str:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter,
                                allow_abbrev=False)
    add_common_args(p)
    p.add_argument("--num_gpus", type=int, required=True, help="data-parallel cards")
    p.add_argument("--train_batch_size", type=int, required=True, help="global batch")
    p.add_argument("--per_device_train_batch_size", type=int, default=1)
    p.add_argument("train_args", nargs=argparse.REMAINDER, help="args for cli.train_v2")
    args = p.parse_args(argv)

    per_step = args.num_gpus * args.per_device_train_batch_size
    accum = args.train_batch_size // per_step
    if accum < 1 or accum * per_step != args.train_batch_size:
        p.error(f"--train_batch_size {args.train_batch_size} is not a multiple of --num_gpus x "
                f"--per_device_train_batch_size = {per_step}")
    module_args = [
        "--data_parallel", str(args.num_gpus),
        "--per_device_train_batch_size", str(args.per_device_train_batch_size),
        "--gradient_accumulation_steps", str(accum),
    ] + forwarded(args.train_args)
    return finish(args, "eilev-train-v2", MODULE, module_args, nproc=args.num_gpus)


if __name__ == "__main__":
    main()

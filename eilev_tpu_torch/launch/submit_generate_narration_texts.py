"""Write and run or submit a batched narration job (counterpart of
``launch/submit_generate_narration_texts.py``): ``cli.generate_narration_texts``
on one card, or tensor-parallel over ``--model_parallel N`` cards of one host
(``torchrun --nproc_per_node N``, the CLI's ``--model_parallel N``).

    python -m eilev_tpu_torch.launch.submit_generate_narration_texts [--model_parallel 2] \\
        -- --model DIR --eval_frames_dir EVAL ... --output_csv out.csv
"""

from __future__ import annotations

import argparse
from typing import Optional

from .launch_lib import add_common_args, finish, forwarded

MODULE = "eilev_tpu_torch.cli.generate_narration_texts"


def add_model_parallel(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model_parallel", type=int, default=1,
                   help="cards the model is sharded over (one process each)")


def model_parallel_args(args: argparse.Namespace) -> list[str]:
    """The CLI's ``--model_parallel N`` for a sharded job, nothing for one card."""
    return ["--model_parallel", str(args.model_parallel)] if args.model_parallel > 1 else []


def main(argv: Optional[list[str]] = None) -> str:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter,
                                allow_abbrev=False)
    add_common_args(p)
    add_model_parallel(p)
    p.add_argument("gen_args", nargs=argparse.REMAINDER, help="args for cli.generate_narration_texts")
    args = p.parse_args(argv)
    return finish(args, "eilev-generate-narrations", MODULE, forwarded(args.gen_args) + model_parallel_args(args),
                  nproc=args.model_parallel)


if __name__ == "__main__":
    main()

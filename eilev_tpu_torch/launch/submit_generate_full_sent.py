"""Write and run or submit a baseline sentence-ifier job (counterpart of
``launch/submit_generate_full_sent.py``): ``cli.baselines.<mode>_generate_full_sent``
(``TextLM`` over a local LLaMA- or OPT-family checkpoint) on one card.

    python -m eilev_tpu_torch.launch.submit_generate_full_sent --mode videomae \\
        -- --model LLAMA_DIR --predictions_csv pred.csv --output_csv sent.csv
"""

from __future__ import annotations

import argparse
from typing import Optional

from .launch_lib import add_common_args, finish, forwarded

MODULES = {
    "videomae": "eilev_tpu_torch.cli.baselines.videomae_generate_full_sent",
    "majority": "eilev_tpu_torch.cli.baselines.majority_generate_full_sent",
}


def main(argv: Optional[list[str]] = None) -> str:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter,
                                allow_abbrev=False)
    add_common_args(p)
    p.add_argument("--mode", choices=sorted(MODULES), required=True)
    p.add_argument("gen_args", nargs=argparse.REMAINDER, help="args for the *_generate_full_sent CLI")
    args = p.parse_args(argv)
    return finish(args, f"{args.mode}-generate-full-sent", MODULES[args.mode], forwarded(args.gen_args),
                  forward_wandb=False)


if __name__ == "__main__":
    main()

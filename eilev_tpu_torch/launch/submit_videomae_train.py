"""Write and run or submit a VideoMAE verb/noun classifier training job
(counterpart of ``launch/submit_videomae_train.py``):
``cli.baselines.videomae_train`` on one card.

    python -m eilev_tpu_torch.launch.submit_videomae_train --verb --train_batch_size 8 -- --train_frames_dir ...
"""

from __future__ import annotations

import argparse
from typing import Optional

from .launch_lib import add_common_args, finish, forwarded

MODULE = "eilev_tpu_torch.cli.baselines.videomae_train"


def main(argv: Optional[list[str]] = None) -> str:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter,
                                allow_abbrev=False)
    add_common_args(p)
    p.add_argument("--verb", action="store_true", help="train the verb classifier (else noun)")
    p.add_argument("--train_batch_size", type=int, default=None, help="global batch forwarded as --batch_size")
    p.add_argument("train_args", nargs=argparse.REMAINDER, help="args for cli.baselines.videomae_train")
    args = p.parse_args(argv)

    module_args = ["--verb"] if args.verb else []
    if args.train_batch_size is not None:
        module_args += ["--batch_size", str(args.train_batch_size)]
    name = "videomae-train-" + ("verb" if args.verb else "noun")
    return finish(args, name, MODULE, module_args + forwarded(args.train_args), forward_wandb=False)


if __name__ == "__main__":
    main()

"""Write and run or submit a frame-extraction job (counterpart of
``launch/submit_extract_frames.py``): ``cli.ego4d.extract_frames`` or
``cli.epic_kitchens.epic_kitchens_extract_frames`` in one process on one
card (the decode runs on the host's cores, the resize on the card).

    python -m eilev_tpu_torch.launch.submit_extract_frames --dataset ego4d [--backend slurm ...] \\
        -- --fho_main_path ... --frames_dir FRAMES --num_subsample_frames 8
"""

from __future__ import annotations

import argparse
from typing import Optional

from .launch_lib import add_common_args, finish, forwarded

MODULES = {
    "ego4d": "eilev_tpu_torch.cli.ego4d.extract_frames",
    "epic_kitchens": "eilev_tpu_torch.cli.epic_kitchens.epic_kitchens_extract_frames",
}


def main(argv: Optional[list[str]] = None) -> str:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter,
                                allow_abbrev=False)
    add_common_args(p)
    p.add_argument("--dataset", choices=sorted(MODULES), default="ego4d")
    p.add_argument("extract_args", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    return finish(args, f"extract-frames-{args.dataset}", MODULES[args.dataset], forwarded(args.extract_args),
                  forward_wandb=False)


if __name__ == "__main__":
    main()

"""Write and run or submit a verb/noun ICL classification job (counterpart of
``launch/submit_icl_eval.py``): ``cli.icl_eval`` on one card, or
tensor-parallel over ``--model_parallel N`` cards of one host.

    python -m eilev_tpu_torch.launch.submit_icl_eval [--model_parallel 2] -- --model DIR ... --output_json f1.json
"""

from __future__ import annotations

import argparse
from typing import Optional

from .launch_lib import add_common_args, finish, forwarded
from .submit_generate_narration_texts import add_model_parallel, model_parallel_args

MODULE = "eilev_tpu_torch.cli.icl_eval"


def main(argv: Optional[list[str]] = None) -> str:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter,
                                allow_abbrev=False)
    add_common_args(p)
    add_model_parallel(p)
    p.add_argument("eval_args", nargs=argparse.REMAINDER, help="args for cli.icl_eval")
    args = p.parse_args(argv)
    return finish(args, "eilev-icl-eval", MODULE, forwarded(args.eval_args) + model_parallel_args(args),
                  nproc=args.model_parallel)


if __name__ == "__main__":
    main()

"""What the job generators share: the command, the local or SLURM script
around it, and writing, running or submitting it.

A job is one of the port's CLIs on one host with ``nproc`` cards: ``python
-m eilev_tpu_torch.cli.<name>`` for one process, ``torchrun
--nproc_per_node N -m eilev_tpu_torch.cli.<name>`` for N (each process
joins the process group from torchrun's environment,
``parallel/distributed.py``). The SLURM script asks for the cards with
``#SBATCH --gres=gpu:N``.
"""

from __future__ import annotations

import argparse
import os
import shlex
import subprocess


def build_command(module: str, module_args: list[str], env: dict[str, str], nproc: int = 1) -> str:
    """The job's shell lines: the exports, then ``module`` run from the
    repository's checkout (``$EILEV_TPU_REPO``) in ``nproc`` processes."""
    exports = "".join(f"export {k}={shlex.quote(v)}\n" for k, v in env.items())
    args = " ".join(shlex.quote(a) for a in module_args)
    launcher = f"torchrun --nproc_per_node {nproc}" if nproc > 1 else "python"
    return f"{exports}cd $EILEV_TPU_REPO && {launcher} -m {module} {args}\n"


def local_script(name: str, command: str) -> str:
    """A bash script that runs the job on this host."""
    return f"""#!/bin/bash
# run {name} on this host
set -euo pipefail
{command}"""


def slurm_script(name: str, command: str, *, account: str, partition: str, time: str, gpus: int,
                 mem: str = "64G", email: str | None = None) -> str:
    """An sbatch script: one node, ``gpus`` cards."""
    email_lines = f"#SBATCH --mail-user={email}\n#SBATCH --mail-type=BEGIN,END\n" if email else ""
    return f"""#!/bin/bash
#SBATCH --job-name={name}
#SBATCH --account={account}
#SBATCH --partition={partition}
#SBATCH --time={time}
#SBATCH --mem={mem}
#SBATCH --nodes=1
#SBATCH --gres=gpu:{gpus}
#SBATCH --output=%x-%j.log
{email_lines}
{command}"""


def emit_or_submit(script_text: str, name: str, *, backend: str, dry_run: bool) -> str:
    """Write ``<name>.sh`` in the working directory, then print it
    (``dry_run``), submit it with sbatch (``slurm``) or run it with bash
    (``local``). Returns the script's path."""
    fname = f"{name}.sh"
    with open(fname, "w") as f:
        f.write(script_text)
    os.chmod(fname, 0o755)
    print(f"wrote {fname}")
    if dry_run:
        print(script_text)
    elif backend == "slurm":
        subprocess.run(["sbatch", fname], check=True)
    else:
        subprocess.run(["bash", fname], check=True)
    return fname


def add_common_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--backend", choices=["local", "slurm"], default="local")
    # slurm backend
    parser.add_argument("--account", default="")
    parser.add_argument("--partition", default="")
    parser.add_argument("--time", default="2-00:00:00")
    parser.add_argument("--mem", default="64G")
    parser.add_argument("--email", default=None)
    parser.add_argument("--repo_path", default="~/eilev-tpu", help="repo checkout on the job's host")
    parser.add_argument("--wandb_project", default=None)
    parser.add_argument("--dry_run", action="store_true")


def forwarded(args: list[str]) -> list[str]:
    """The trailing arguments meant for the CLI, without a ``--`` separator."""
    return [a for a in args if a != "--"]


def finish(args: argparse.Namespace, name: str, module: str, module_args: list[str], *, nproc: int = 1,
           forward_wandb: bool = True) -> str:
    """Build the job for ``module`` in ``nproc`` processes and emit, run or
    submit it. ``--wandb_project`` is exported, and passed to the CLI when
    ``forward_wandb`` (the baselines take no such flag)."""
    env = {"EILEV_TPU_REPO": args.repo_path}
    if args.wandb_project:
        env["WANDB_PROJECT"] = args.wandb_project
        if forward_wandb:
            module_args = module_args + ["--wandb_project", args.wandb_project]
    command = build_command(module, module_args, env, nproc)
    if args.backend == "slurm":
        text = slurm_script(name, command, account=args.account, partition=args.partition, time=args.time,
                            gpus=nproc, mem=args.mem, email=args.email)
    else:
        text = local_script(name, command)
    return emit_or_submit(text, name, backend=args.backend, dry_run=args.dry_run)

"""The port's job generators (``eilev_tpu_torch/launch/``): the dry-run
scripts' text, written in a temporary working directory: the ``python -m`` or
``torchrun --nproc_per_node N -m`` line of the port's CLI, the arguments
forwarded to it (the JAX generators' arithmetic: global batch 128 =
accumulation 16 x 8 GPUs x per-device 1, held against
``launch/submit_train_v2.py``'s own dry run), the ``#SBATCH`` lines with the
cards asked for, and a local job that runs."""

import os
import runpy
import subprocess
import sys

import pytest

from eilev_tpu_torch.launch import (
    launch_lib,
    submit_extract_frames,
    submit_generate_full_sent,
    submit_generate_narration_texts,
    submit_icl_eval,
    submit_train_v2,
    submit_videomae_train,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _command(text: str) -> str:
    """The job's CLI line."""
    (line,) = [ln for ln in text.splitlines() if ln.startswith("cd $EILEV_TPU_REPO && ")]
    return line[len("cd $EILEV_TPU_REPO && "):]


def _jax_dry_run(name: str, argv: list, script: str, capsys) -> str:
    old = sys.argv
    sys.argv = [name, *argv, "--dry_run"]
    try:
        runpy.run_path(os.path.join(REPO, "launch", name), run_name="__main__")
    finally:
        sys.argv = old
    capsys.readouterr()
    return open(script).read()


def test_train_v2_slurm_script(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    path = submit_train_v2.main(["--backend", "slurm", "--account", "acct", "--partition", "gpu", "--time",
                                 "1-00:00:00", "--email", "me@example.com", "--wandb_project", "eilev",
                                 "--num_gpus", "8", "--train_batch_size", "128", "--dry_run", "--",
                                 "--model_name_or_path", "/models/blip2", "--output_dir", "out dir"])
    assert path == "eilev-train-v2.sh" and os.access(path, os.X_OK)
    text = open(path).read()
    assert text in capsys.readouterr().out  # --dry_run prints it and submits nothing
    sbatch = [ln for ln in text.splitlines() if ln.startswith("#SBATCH")]
    assert sbatch == ["#SBATCH --job-name=eilev-train-v2", "#SBATCH --account=acct", "#SBATCH --partition=gpu",
                      "#SBATCH --time=1-00:00:00", "#SBATCH --mem=64G", "#SBATCH --nodes=1",
                      "#SBATCH --gres=gpu:8", "#SBATCH --output=%x-%j.log", "#SBATCH --mail-user=me@example.com",
                      "#SBATCH --mail-type=BEGIN,END"]
    assert "export EILEV_TPU_REPO='~/eilev-tpu'\nexport WANDB_PROJECT=eilev\n" in text
    assert _command(text) == (
        "torchrun --nproc_per_node 8 -m eilev_tpu_torch.cli.train_v2 --data_parallel 8 "
        "--per_device_train_batch_size 1 --gradient_accumulation_steps 16 --model_name_or_path /models/blip2 "
        "--output_dir 'out dir' --wandb_project eilev")


@pytest.mark.parametrize("num_gpus,per_device,accum", [(8, 1, 16), (4, 2, 16), (1, 1, 128)])
def test_train_v2_accumulation_matches_jax(tmp_path, monkeypatch, capsys, num_gpus, per_device, accum):
    monkeypatch.chdir(tmp_path)
    common = ["--train_batch_size", "128", "--per_device_train_batch_size", str(per_device)]
    ours = open(submit_train_v2.main(common + ["--num_gpus", str(num_gpus), "--dry_run"])).read()
    ref = _jax_dry_run("submit_train_v2.py", common + ["--num_chips", str(num_gpus)], "eilev-train-v2.sh", capsys)
    args = _command(ours).split(" -m eilev_tpu_torch.cli.train_v2 ")[1]
    assert args == _command(ref).split("python scripts/train_v2.py ")[1]
    assert f"--gradient_accumulation_steps {accum}" in args
    launcher = f"torchrun --nproc_per_node {num_gpus}" if num_gpus > 1 else "python"
    assert _command(ours).startswith(f"{launcher} -m eilev_tpu_torch.cli.train_v2 ")
    assert ours.startswith("#!/bin/bash\n# run eilev-train-v2 on this host\nset -euo pipefail\n")


def test_train_v2_refuses_a_batch_it_cannot_split(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit):
        submit_train_v2.main(["--num_gpus", "3", "--train_batch_size", "128", "--dry_run"])
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("module,argv,name,command", [
    (submit_extract_frames, ["--dataset", "epic_kitchens", "--", "--frames_dir", "F"], "extract-frames-epic_kitchens",
     "python -m eilev_tpu_torch.cli.epic_kitchens.epic_kitchens_extract_frames --frames_dir F"),
    (submit_extract_frames, ["--", "--frames_dir", "F"], "extract-frames-ego4d",
     "python -m eilev_tpu_torch.cli.ego4d.extract_frames --frames_dir F"),
    (submit_generate_full_sent, ["--mode", "majority", "--", "--model", "M"], "majority-generate-full-sent",
     "python -m eilev_tpu_torch.cli.baselines.majority_generate_full_sent --model M"),
    (submit_generate_narration_texts, ["--model_parallel", "2", "--", "--model", "M"], "eilev-generate-narrations",
     "torchrun --nproc_per_node 2 -m eilev_tpu_torch.cli.generate_narration_texts --model M --model_parallel 2"),
    (submit_generate_narration_texts, ["--", "--model", "M"], "eilev-generate-narrations",
     "python -m eilev_tpu_torch.cli.generate_narration_texts --model M"),
    (submit_icl_eval, ["--model_parallel", "4", "--", "--model", "M"], "eilev-icl-eval",
     "torchrun --nproc_per_node 4 -m eilev_tpu_torch.cli.icl_eval --model M --model_parallel 4"),
    (submit_videomae_train, ["--verb", "--train_batch_size", "8", "--", "--lr", "1e-4"], "videomae-train-verb",
     "python -m eilev_tpu_torch.cli.baselines.videomae_train --verb --batch_size 8 --lr 1e-4"),
])
def test_job_commands(tmp_path, monkeypatch, module, argv, name, command):
    monkeypatch.chdir(tmp_path)
    text = open(module.main(["--backend", "slurm", "--wandb_project", "w", "--dry_run", *argv])).read()
    assert os.listdir(tmp_path) == [f"{name}.sh"]
    assert f"#SBATCH --job-name={name}\n" in text
    gpus = command.split("--nproc_per_node ")[1].split()[0] if command.startswith("torchrun") else "1"
    assert f"#SBATCH --gres=gpu:{gpus}\n" in text
    # the baselines and the extractors take no --wandb_project; the others get it
    forwards = module in (submit_generate_narration_texts, submit_icl_eval)
    assert _command(text) == command + (" --wandb_project w" if forwards else "")


def test_local_job_runs(tmp_path, monkeypatch, capsys):
    """--backend local writes the job and runs it with bash: here the
    extractor's --help, from the repository's checkout."""
    monkeypatch.chdir(tmp_path)
    launch_lib.finish(launch_lib.argparse.Namespace(repo_path=REPO, wandb_project=None, backend="local",
                                                     dry_run=False), "help", "eilev_tpu_torch.cli.ego4d.extract_frames",
                      ["--help"])
    proc = subprocess.run(["bash", "help.sh"], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "--num_subsample_frames" in proc.stdout, proc.stderr

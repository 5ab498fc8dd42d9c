"""train_v2's parallel flags on the CPU, in one process, on the world of
tests/test_torch_cli.py (the tiny checkpoint written by the JAX package's
exporter): ``--zero_shard_opt_state`` over a data group of one exports the
plain run's model bit for bit (ZeRO is the replicated step); ``--multihost
--data_parallel 1 --pipeline_parallel 2`` (two stages on the CPU) trains,
and its export loads with finite trained weights and the frozen towers as
they came in. (The pipeline runs its frozen LM without dropout, which the
plain run has on, so its weights are its own.)"""

import os

import pytest
import torch

from eilev_tpu_torch.cli import train_v2
from eilev_tpu_torch.models import auto
from eilev_tpu_torch.training import partition_params

from .test_torch_cli import world  # noqa: F401  (the module-scoped world fixture)


def _train(world, out, *flags):  # noqa: F811
    train_v2.main([
        "--model_name_or_path", str(world / "checkpoint"), "--dtype", "fp32", "--device", "cpu",
        "--train_frames_dir", str(world / "train_frames"), "--val_frames_dir", str(world / "train_frames"),
        "--train_num_in_context_examples_per_sample", "1", "--val_num_in_context_examples_per_sample", "1",
        "--num_subsample_frames", "2", "--max_length", "64", "--output_dir", out,
        "--num_train_steps", "2", "--per_device_train_batch_size", "1", "--gradient_accumulation_steps", "2",
        "--learning_rate", "1e-3", "--warmup_steps", "0", "--eval_steps", "2", "--save_steps", "2",
        "--logging_steps", "1", "--export_hf", *flags,
    ])
    model, _ = auto.load_model(os.path.join(out, "hf"), device="cpu")
    return model.state_dict()


@pytest.mark.parametrize("flags", [["--zero_shard_opt_state"],
                                   ["--multihost", "--data_parallel", "1", "--pipeline_parallel", "2",
                                    "--pipeline_microbatches", "1"]], ids=["zero", "pipeline"])
def test_train_v2_parallel_flags_run(world, tmp_path, flags):  # noqa: F811
    ours = _train(world, str(tmp_path / "ours"), *flags)
    source, _ = auto.load_model(str(world / "checkpoint"), device="cpu")
    trained, frozen = partition_params(source.state_dict())
    assert all(torch.equal(ours[k], v) for k, v in frozen.items())
    assert not all(torch.equal(ours[k], v) for k, v in trained.items())
    assert all(bool(torch.isfinite(ours[k]).all()) for k in trained)
    if "--zero_shard_opt_state" in flags:
        plain = _train(world, str(tmp_path / "plain"))
        assert all(torch.equal(ours[k], plain[k]) for k in trained)

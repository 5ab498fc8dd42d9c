"""The rank side of tests/test_torch_parallel_dp.py: one process of a 2-rank
gloo group on the CPU. It imports torch and the port only (no jax), so that a
spawned rank starts in seconds; the parent passes numpy params and batches
and reads what each rank saved."""

import dataclasses
import datetime
import os

import torch


def port_model(params):
    from eilev_tpu_torch import configs
    from eilev_tpu_torch.models import VideoBlipForConditionalGeneration, params_from_jax
    from eilev_tpu_torch.training import freeze_towers

    cfg = configs.tiny_config(text_model="opt")
    model = VideoBlipForConditionalGeneration(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg), strict=True)
    freeze_towers(model)
    return model


def run_steps(params, batch, ocfg, steps, *, dropout, mesh=None, zero=False):
    """``steps`` train steps of the port; (state, [metrics as floats])."""
    from eilev_tpu_torch.training import TrainState, freeze_towers, make_optimizer, make_train_step
    from eilev_tpu_torch.training.train_state import zero_sharded_opt_state

    model = port_model(params)
    state = TrainState.create(freeze_towers(model)[0], make_optimizer(ocfg))
    if zero:
        state = dataclasses.replace(state, opt_state=zero_sharded_opt_state(state, mesh))
    step = make_train_step(model, accum_steps=batch["labels"].shape[0], dropout=dropout, mesh=mesh,
                           zero_shard_opt_state=zero)
    metrics = []
    for _ in range(steps):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return model, state, metrics


def _snapshot(state) -> dict:
    from eilev_tpu_torch.training.checkpoint import _to

    return {"trainable": _to(state.trainable, "cpu"), "opt_state": _to(state.opt_state, "cpu")}


def rank_main(rank, init_file, out_dir, params, batch, ocfg, steps):
    """Every case on this rank; saves ``rank{rank}.pt``."""
    torch.set_num_threads(1)
    from eilev_tpu_torch.parallel import distributed, make_mesh, shard_batch
    from eilev_tpu_torch.training import eval_step
    from eilev_tpu_torch.training.checkpoint import save_checkpoint
    from eilev_tpu_torch.training.train_state import full_opt_state

    distributed.initialize("cpu", init_method=f"file://{init_file}", world_size=2, rank=rank,
                           timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh(data=2, device="cpu")
        local = shard_batch({k: torch.from_numpy(v) for k, v in batch.items()}, mesh, axis=1)
        out = {"counts": [int((local["labels"][i][:, 1:] != -100).sum()) for i in range(local["labels"].shape[0])]}
        for dropout in (False, True):
            _, state, metrics = run_steps(params, local, ocfg, steps, dropout=dropout, mesh=mesh)
            out[f"dp_dropout_{dropout}"] = {"metrics": metrics, **_snapshot(state)}
        model, state, metrics = run_steps(params, local, ocfg, steps, dropout=False, mesh=mesh, zero=True)
        out["zero"] = {"metrics": metrics, **_snapshot(state)}
        full = dataclasses.replace(state, opt_state=full_opt_state(state, mesh))
        out["zero_full_opt_state"] = _snapshot(full)["opt_state"]
        if rank == 0:
            save_checkpoint(os.path.join(out_dir, "zero_ckpt"), full)
        out["eval"] = float(eval_step(model, {k: v[0] for k, v in local.items()}, mesh))
        out["gathered"] = distributed.gather_to_host(torch.full((2, 3), float(rank)))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


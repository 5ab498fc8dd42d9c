"""Native training checkpoints (counterpart of ``eilev_tpu/training/checkpoint.py``,
its orbax part).

A checkpoint is the directory ``<ckpt_dir>/<step>/`` holding one
``checkpoint.pt``: ``{step, trainable, opt_state}`` and, when there is one,
the best-eval snapshot (``best_loss``, ``best_trainable``) that
``load_best_model_at_end`` needs after a preemption. The frozen towers never
change, so only the trainable subtree is written. It is written with
``torch.save`` into a temporary directory that is then renamed, so a
directory named by a step is always whole, and read with
``torch.load(weights_only=True)``: the payload is tensors, dicts and numbers
only.

The HF safetensors export of the JAX module (``hf_state_dict``,
``export_hf_safetensors``) is not ported yet.
"""

from __future__ import annotations

import os
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Optional

import torch

from .train_state import TrainState

CHECKPOINT_FILE = "checkpoint.pt"


def _to(tree: Any, device) -> Any:
    """Every tensor of a nested dict/list copied to ``device`` (a fresh copy
    even where it is already there: a snapshot)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device, copy=True)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


def _payload(state: TrainState, best: Optional[tuple]) -> dict:
    """The host snapshot of what a checkpoint holds."""
    payload = {
        "step": int(state.step),
        "trainable": _to(state.trainable, "cpu"),
        "opt_state": _to(state.opt_state, "cpu"),
    }
    if best is not None:
        best_loss, best_trainable = best
        payload["best_loss"] = float(best_loss)
        payload["best_trainable"] = _to(best_trainable, "cpu")
    return payload


def _write(ckpt_dir: str, payload: dict) -> str:
    path = os.path.join(os.path.abspath(ckpt_dir), str(payload["step"]))
    tmp = os.path.join(os.path.abspath(ckpt_dir), f".{payload['step']}.tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, CHECKPOINT_FILE))
    shutil.rmtree(path, ignore_errors=True)  # a save of the same step replaces it
    os.replace(tmp, path)
    return path


def save_checkpoint(
    ckpt_dir: str, state: TrainState, *, keep: int = 3, best: Optional[tuple] = None
) -> str:
    """Save {step, trainable, opt_state} under ckpt_dir/<step>; prune to the
    ``keep`` newest (reference recipe: save_total_limit 3).

    ``best`` = (best_eval_loss, best_trainable) persists the
    load_best_model_at_end snapshot so it survives preemption."""
    path = _write(ckpt_dir, _payload(state, best))
    _prune(ckpt_dir, keep)
    return path


class AsyncCheckpointWriter:
    """Checkpoint saves that overlap training compute: ``save`` snapshots the
    state to the host (a copy, so the next step may update the parameters in
    place) and writes it on a background thread. One save is in flight at a
    time: the next ``save`` (or ``wait``) waits for the last, and raises what
    it raised. ``close`` waits and stops the thread."""

    def __init__(self) -> None:
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None

    def save(
        self, ckpt_dir: str, state: TrainState, *, keep: int = 3, best: Optional[tuple] = None
    ) -> str:
        self.wait()
        payload = _payload(state, best)
        path = os.path.join(os.path.abspath(ckpt_dir), str(payload["step"]))

        def write() -> None:
            _write(ckpt_dir, payload)
            _prune(ckpt_dir, keep)

        self._pending = self._pool.submit(write)
        return path

    def wait(self) -> None:
        """Block until the in-flight save (if any) is written and pruned."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self) -> "AsyncCheckpointWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d) for d in os.listdir(ckpt_dir) if d.isdigit()]
    if not steps:
        return None
    return os.path.join(os.path.abspath(ckpt_dir), str(max(steps)))


def restore_checkpoint(path: str, state: TrainState, *, with_best: bool = False):
    """Restore into ``state``: the trainable parameters are overwritten in
    place (they are the model's), the optimizer state is moved to their
    device. Returns the new state; with ``with_best`` ``(state, best)``,
    where best is (best_eval_loss, best_trainable) if the checkpoint carries
    one, else None."""
    payload = torch.load(os.path.join(path, CHECKPOINT_FILE), map_location="cpu", weights_only=True)
    saved = payload["trainable"]
    if set(saved) != set(state.trainable):
        raise ValueError(
            f"checkpoint {path} holds other trainable parameters: "
            f"{sorted(set(saved) ^ set(state.trainable))[:5]} ..."
        )
    device = next(iter(state.trainable.values())).device
    with torch.no_grad():
        for k, p in state.trainable.items():
            p.copy_(saved[k])
    new_state = TrainState(
        step=int(payload["step"]), trainable=state.trainable,
        opt_state=_to(payload["opt_state"], device), tx=state.tx,
    )
    if not with_best:
        return new_state
    best = None
    if "best_trainable" in payload:
        best = (float(payload["best_loss"]), _to(payload["best_trainable"], device))
    return new_state, best


def _prune(ckpt_dir: str, keep: int) -> None:
    steps = sorted(int(d) for d in os.listdir(ckpt_dir) if d.isdigit())
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, str(s)), ignore_errors=True)

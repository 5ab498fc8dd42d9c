"""Training loop: the HF-Trainer role (counterpart of ``eilev_tpu/training/trainer.py``).

The train_v1/train_v2 recipe (reference train_v2.py:104-219): frozen towers,
grad accumulation to a global batch, periodic eval and checkpointing
(save_steps / save_total_limit / load_best_model_at_end),
resume-from-checkpoint, and the step-time and videos/s meters the reference
lacks. A background thread keeps a queue of batches on the model's device,
so data loading and the on-card augmentation overlap the steps.

One device: the JAX trainer's parallel modes (``zero_shard_opt_state``,
``pipeline_parallel`` > 1, a mesh) raise ``NotImplementedError``; they wait
with the port's ``parallel/``.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch
from torch import nn

from .checkpoint import AsyncCheckpointWriter, latest_checkpoint, restore_checkpoint, save_checkpoint
from .train_state import (
    OptimizerConfig,
    TrainState,
    eval_step,
    freeze_towers,
    make_optimizer,
    make_train_step,
)


@dataclasses.dataclass
class TrainerConfig:
    """HF TrainingArguments subset used by the reference recipe
    (slurm-scripts/train/submit_train_v2.py:22-37). The micro-batch size is
    that of the batches ``train_batches`` yields, so the JAX config's
    ``per_device_batch_size`` (read there only by a mesh check) and
    ``pipeline_microbatches`` (pipeline mode only) have no field here."""

    output_dir: str = "checkpoints"
    num_train_steps: Optional[int] = 1000  # None = train until the data iterator ends
    gradient_accumulation_steps: int = 16
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    eval_steps: int = 200
    save_steps: int = 200
    save_total_limit: int = 3
    log_steps: int = 10
    load_best_model_at_end: bool = True
    dropout: bool = True  # reference trains the Q-Former with its 0.1 dropouts
    seed: int = 42
    resume_from_checkpoint: bool = False
    prefetch: int = 2
    # ZeRO-2: not ported (one device); True raises NotImplementedError
    zero_shard_opt_state: bool = False
    # overlap checkpoint writes with training; the final save always commits
    # before train() returns
    async_save: bool = False
    # pipeline parallelism: not ported (one device); > 1 raises NotImplementedError
    pipeline_parallel: int = 0
    # (start, stop) step interval to capture a torch.profiler trace for,
    # written to <output_dir>/trace as a Chrome trace
    profile_steps: Optional[tuple] = None


class _Prefetcher:
    """Background thread pulling batches and parking them on the device.
    ``close`` stops it (the consumer may stop early: at num_train_steps)."""

    def __init__(self, it: Iterable, put_fn: Callable[[Any], Any], depth: int):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._put = put_fn
        self._it = iter(it)
        self._done = object()
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _offer(self, item) -> bool:
        """Put ``item`` unless stopped; False once stopped."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        try:
            for item in self._it:
                if not self._offer(self._put(item)):
                    return
        except BaseException as e:  # re-raised in the consumer
            self._error = e
        finally:
            self._offer(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    def close(self, timeout: float = 60.0) -> None:
        self._stop.set()
        while True:  # unblock a producer waiting on a full queue
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout)


class Trainer:
    def __init__(
        self,
        model: nn.Module,
        config: TrainerConfig,
        train_batches: Callable[[int], Iterable[dict]],
        eval_batches: Optional[Callable[[], Iterable[dict]]] = None,
        logger: Optional[Callable[[int, dict], None]] = None,
    ):
        """
        :param model: a port ``VideoBlipForConditionalGeneration``; its vision
            tower and LM are frozen here (``requires_grad_(False)``) and its
            trainable parameters are updated in place.
        :param train_batches: fn(seed) -> iterable of batches shaped (accum,
            micro_batch, ...) per tensor (see make_train_step); numpy arrays
            or tensors, moved to the model's device.
        :param eval_batches: fn() -> iterable of eval batches (micro shape).
        :param logger: fn(step, metrics).
        """
        if config.zero_shard_opt_state:
            raise NotImplementedError("zero_shard_opt_state (ZeRO-2) is not ported: the port trains on one device")
        if config.pipeline_parallel > 1:
            raise NotImplementedError("pipeline_parallel is not ported: the port trains on one device")
        self.model = model
        self.config = config
        self.train_batches = train_batches
        self.eval_batches = eval_batches
        self.logger = logger
        trainable, _ = freeze_towers(model)
        self.device = next(iter(trainable.values())).device
        self.state = TrainState.create(trainable, make_optimizer(config.optimizer))
        self._step_fn = make_train_step(
            model, accum_steps=config.gradient_accumulation_steps, dropout=config.dropout
        )
        self.best_eval_loss = float("inf")
        self.best_trainable: Optional[dict] = None
        self._ckpt_writer: Optional[AsyncCheckpointWriter] = None
        if config.resume_from_checkpoint:
            path = latest_checkpoint(config.output_dir)
            if path is not None:
                self.state, best = restore_checkpoint(path, self.state, with_best=True)
                if best is not None:
                    self.best_eval_loss, self.best_trainable = best

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True) for k, v in batch.items()}

    def evaluate(self) -> float:
        if self.eval_batches is None:
            raise ValueError("evaluate needs the Trainer's eval_batches")
        losses = [float(eval_step(self.model, self._to_device(b))) for b in self.eval_batches()]
        return float(np.mean(losses)) if losses else float("nan")

    def train(self) -> TrainState:
        cfg = self.config
        it = _Prefetcher(self.train_batches(cfg.seed + self.state.step), self._to_device, cfg.prefetch)
        profiler = None
        try:
            t_last = time.perf_counter()
            videos_since = 0
            for batch in it:
                if cfg.num_train_steps is not None and self.state.step >= cfg.num_train_steps:
                    break
                if cfg.profile_steps is not None:
                    profiler = self._profile(profiler, self.state.step)
                self.state, metrics = self._step_fn(self.state, batch)
                step = self.state.step
                if "pixel_values" in batch:
                    videos_since += int(np.prod(batch["pixel_values"].shape[:2]))

                if step % cfg.log_steps == 0:
                    loss, grad_norm = float(metrics["loss"]), float(metrics["grad_norm"])  # waits for the step
                    now = time.perf_counter()
                    dt = now - t_last
                    logd = {
                        "loss": loss,
                        "grad_norm": grad_norm,
                        "step_time_sec": dt / cfg.log_steps,
                        "videos_per_sec": videos_since / dt if dt > 0 else 0.0,
                    }
                    t_last, videos_since = now, 0
                    if self.logger:
                        self.logger(step, logd)
                    else:
                        print(f"step {step}: {logd}")

                if cfg.eval_steps and self.eval_batches is not None and step % cfg.eval_steps == 0:
                    eval_loss = self.evaluate()
                    if self.logger:
                        self.logger(step, {"eval_loss": eval_loss})
                    if eval_loss < self.best_eval_loss:
                        self.best_eval_loss = eval_loss
                        self.best_trainable = {k: p.detach().clone() for k, p in self.state.trainable.items()}

                if cfg.save_steps and step % cfg.save_steps == 0:
                    self._save(cfg)
        finally:
            it.close()
            if profiler is not None:
                self._stop_profile(profiler)

        if cfg.load_best_model_at_end and self.best_trainable is not None:
            with torch.no_grad():
                for k, p in self.state.trainable.items():
                    p.copy_(self.best_trainable[k])
        self._save(cfg, final=True)
        return self.state

    def _profile(self, profiler, step: int):
        """Start the trace at the interval's first step, stop it at its end."""
        lo, hi = self.config.profile_steps
        if profiler is None and step == lo:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=activities)
            profiler.start()
        elif profiler is not None and step >= hi:
            self._stop_profile(profiler)
            profiler = None
        return profiler

    def _stop_profile(self, profiler) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        lo, hi = self.config.profile_steps
        trace_dir = os.path.join(self.config.output_dir, "trace")
        os.makedirs(trace_dir, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(trace_dir, f"steps_{lo}_{hi}.json"))

    def _save(self, cfg: TrainerConfig, final: bool = False) -> None:
        """Periodic saves overlap compute when cfg.async_save; the final save
        always commits before returning."""
        best = None if self.best_trainable is None else (self.best_eval_loss, self.best_trainable)
        if cfg.async_save:
            if self._ckpt_writer is None:
                self._ckpt_writer = AsyncCheckpointWriter()
            self._ckpt_writer.save(cfg.output_dir, self.state, keep=cfg.save_total_limit, best=best)
            if final:
                self._ckpt_writer.close()
                self._ckpt_writer = None
        else:
            save_checkpoint(cfg.output_dir, self.state, keep=cfg.save_total_limit, best=best)

"""Step-time meters and a profiler capture helper (counterpart of
``eilev_tpu/utils/meters.py``).

:class:`StepTimer` keeps wall-clock times per step with percentile
summaries, as the JAX meter does; :func:`profile_trace` captures a
``torch.profiler`` trace (host and, on the card, CUDA activity) where the
JAX helper captures a ``jax.profiler`` one.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import numpy as np
import torch


class StepTimer:
    """Tracks wall-clock per step with percentile summaries."""

    def __init__(self) -> None:
        self.times: list[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        assert self._t0 is not None
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        self._t0 = None
        return dt

    @contextlib.contextmanager
    def measure(self) -> Iterator[None]:
        self.start()
        try:
            yield
        finally:
            self.stop()

    def p50(self) -> float:
        return float(np.median(self.times)) if self.times else float("nan")

    def p90(self) -> float:
        return float(np.percentile(self.times, 90)) if self.times else float("nan")

    def mean(self) -> float:
        return float(np.mean(self.times)) if self.times else float("nan")

    def summary(self) -> dict:
        return {"p50_sec": self.p50(), "p90_sec": self.p90(), "mean_sec": self.mean(), "n": len(self.times)}


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Capture a ``torch.profiler`` trace of the block, written on exit as
    ``<log_dir>/trace.json`` (a Chrome trace: chrome://tracing or Perfetto).
    CUDA activity is recorded when a card is present; the card is
    synchronized before the trace stops, so its queued work is in it."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

"""Profiling and throughput telemetry (counterpart of saspa_tpu/utils/profiling.py).

Usage:
    with trace("logs/profile"):            # torch.profiler trace -> TensorBoard
        run_some_steps()

    meter = ThroughputMeter("images")
    for batch in ...:
        ...
        meter.tick(batch_size)
    meter.summary()  # {"images_per_sec": ..., "images_per_sec_per_chip": ...}
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Optional


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler over the block (the CPU, and CUDA when a card is
    present), written into `logdir` by tensorboard_trace_handler, as
    jax.profiler.start_trace writes its trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
    logging.info("profiler trace written to %s", logdir)


class ThroughputMeter:
    def __init__(self, unit: str = "items", warmup_ticks: int = 1):
        self.unit = unit
        self.warmup_ticks = warmup_ticks
        self.reset()

    def reset(self):
        self._count = 0
        self._ticks = 0
        self._t0: Optional[float] = None

    def tick(self, n: int = 1):
        self._ticks += 1
        if self._ticks <= self.warmup_ticks:
            self._t0 = time.perf_counter()  # restart clock after warmup/compile
            return
        self._count += n

    def summary(self) -> dict:
        from saspa_tpu_torch.parallel.mesh import local_device_count

        dt = max(time.perf_counter() - (self._t0 or time.perf_counter()), 1e-9)
        per_sec = self._count / dt
        n_chips = max(local_device_count(), 1)
        return {
            f"{self.unit}_per_sec": per_sec,
            f"{self.unit}_per_sec_per_chip": per_sec / n_chips,
            "seconds": dt,
            "count": self._count,
        }

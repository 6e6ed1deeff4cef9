"""Profiling helpers: step timing + torch.profiler trace capture (port of
``clover_tpu/utils/profiling.py``).

``trace(log_dir)`` records the CPU and, where there is a card, the CUDA
activity of its block with ``torch.profiler`` and writes a Chrome trace
(``trace.json``, viewable in Perfetto) and the operator table by device
time (``ops.txt``) into ``log_dir``; ``StepTimer`` gives p50/p90 step stats.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Capture a torch.profiler trace into ``log_dir`` (no-op if None)."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    sort = "cuda_time_total" if torch.cuda.is_available() else "cpu_time_total"
    with open(os.path.join(log_dir, "ops.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort, row_limit=60))


class StepTimer:
    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._seen = 0
        self._t_last: Optional[float] = None
        self.durations: List[float] = []

    def tick(self) -> Optional[float]:
        now = time.time()
        dt = None
        if self._t_last is not None:
            self._seen += 1
            if self._seen > self.warmup:
                dt = now - self._t_last
                self.durations.append(dt)
        self._t_last = now
        return dt

    def summary(self) -> Dict[str, float]:
        if not self.durations:
            return {}
        arr = np.asarray(self.durations)
        return {
            "steps": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p90_s": float(np.percentile(arr, 90)),
            "steps_per_sec": float(1.0 / arr.mean()),
        }

"""Profiling and tracing hooks (counterpart of
``tce_rvos_tpu/utils/profiling.py``).

The reference's observability is print-based iteration timing + max CUDA
memory (util/misc.py:224-276). Here:

  * ``trace(logdir)``: a context manager around ``torch.profiler`` (CPU and,
    where there is one, CUDA activity) that writes a Chrome trace
    (``trace.json``, readable in Perfetto or chrome://tracing) under
    ``logdir``, and yields the profiler;
  * ``annotate(name)``: ``torch.profiler.record_function``, so that a phase
    of the program shows up as a span of the trace;
  * ``device_memory_stats()``: bytes in use per CUDA device
    (``torch.cuda.memory_stats``), empty without one;
  * ``StepTimer``: host-side step and data timing, as the JAX package's.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def annotate(name: str):
    return torch.profiler.record_function(name)


def device_memory_stats() -> Dict[str, int]:
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": int(torch.cuda.memory_stats(i).get("allocated_bytes.all.current", 0))
            for i in range(torch.cuda.device_count())}


class StepTimer:
    def __init__(self):
        self.t_start: Optional[float] = None
        self.data_time = 0.0
        self.step_time = 0.0

    def data_loaded(self):
        now = time.perf_counter()
        if self.t_start is not None:
            self.data_time = now - self.t_start
        self.t_start = now

    def step_done(self):
        now = time.perf_counter()
        if self.t_start is not None:
            self.step_time = now - self.t_start
        self.t_start = now

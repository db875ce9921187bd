"""Spans and the profiler's trace, in the traced run only.

``Spans`` times calls into the port's public methods with CUDA events (a
pair around each call; read once the window has closed) and marks them in
the profiler's trace by name. ``Trace`` reduces a ``torch.profiler``
capture of a sub-window to what the per-layer readers need: the device's
busy time (the union of the intervals in which some device operation ran),
each kernel's device time by name, and the breakdown printed with the
traced run (the device operations that took most time, and the longest
idle gaps named by the host operation that was running).
"""

from __future__ import annotations

import collections
import re
import time
from typing import Dict, List, Tuple

import numpy as np
import torch


class Spans:
    """CUDA-event spans by name, each with a count of units (frames,
    expression-frames, steps) for the readers' ratios."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.open: Dict[str, List] = collections.defaultdict(list)

    def wrap(self, name: str, fn, units):
        """``fn`` timed under ``name``; ``units(*args)`` counts its work. On
        the CPU (the tests) the host's clock stands in for the events."""
        def call(*args, **kwargs):
            with torch.profiler.record_function(f"bench.{name}"):
                a = self._mark()
                out = fn(*args, **kwargs)
                self.open[name].append((a, self._mark(), units(*args, **kwargs)))
                return out
        return call

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def read(self) -> Dict[str, List[Tuple[float, float]]]:
        """{name: [(ms, units), ...]} once the device is done."""
        if not self.cuda:
            return {k: [(1e3 * (b - a), u) for a, b, u in v] for k, v in self.open.items()}
        torch.cuda.synchronize()
        return {k: [(a.elapsed_time(b), u) for a, b, u in v] for k, v in self.open.items()}


def _is_device(evt) -> bool:
    return str(evt.device_type).endswith("CUDA") and not getattr(evt, "is_user_annotation", False)


class Trace:
    """A profiled sub-window: ``window_s`` by the host's clock (the device
    synchronised at both ends), the device events' intervals and names,
    and the host's."""

    def __init__(self, prof, window_s: float):
        self.window_s = window_s
        dev, host = [], []
        for e in prof.events():
            rng = (e.time_range.start, e.time_range.end)
            if _is_device(e):
                dev.append((e.name, *rng))
            elif str(e.device_type).endswith("CPU"):
                host.append((e.name, *rng))
        self.dev_names = [d[0] for d in dev]
        self.dev = np.asarray([d[1:] for d in dev], np.float64).reshape(-1, 2) * 1e-6
        self.host_names = [h[0] for h in host]
        self.host = np.asarray([h[1:] for h in host], np.float64).reshape(-1, 2) * 1e-6
        self._union = self._merge(self.dev)

    @staticmethod
    def _merge(iv: np.ndarray) -> np.ndarray:
        if len(iv) == 0:
            return iv
        iv = iv[np.argsort(iv[:, 0])]
        out = [list(iv[0])]
        for s, e in iv[1:]:
            if s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return np.asarray(out)

    @property
    def busy_s(self) -> float:
        """Seconds in which some device operation ran."""
        u = self._union
        return float((u[:, 1] - u[:, 0]).sum()) if len(u) else 0.0

    def kernel_seconds(self, pattern: str) -> Tuple[float, int]:
        """(device seconds, launches) of the device operations whose name
        matches ``pattern``."""
        rx = re.compile(pattern)
        hit = np.asarray([bool(rx.search(n)) for n in self.dev_names], bool)
        if not hit.any():
            return 0.0, 0
        d = self.dev[hit]
        return float((d[:, 1] - d[:, 0]).sum()), int(hit.sum())

    def device_ops(self, top: int = 10) -> List[List]:
        tot: Dict[str, float] = collections.defaultdict(float)
        for n, (s, e) in zip(self.dev_names, self.dev):
            tot[n[:120]] += e - s
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """The ``top`` longest gaps between device operations, each named by
        the innermost host operation running at its middle."""
        u = self._union
        if len(u) < 2:
            return []
        gaps = np.stack([u[:-1, 1], u[1:, 0]], 1)
        order = np.argsort(gaps[:, 0] - gaps[:, 1])[:top]
        out = []
        for s, e in gaps[order]:
            mid = 0.5 * (s + e)
            cover = np.nonzero((self.host[:, 0] <= mid) & (self.host[:, 1] >= mid))[0]
            if len(cover):
                k = cover[np.argmin(self.host[cover, 1] - self.host[cover, 0])]
                name = self.host_names[k][:120]
            else:
                name = "(no host operation)"
            out.append([name, float(e - s)])
        return out


def profiler(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()

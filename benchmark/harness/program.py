"""The program's own spans and counters (``tce_rvos_tpu_torch/utils/
profiling.py``) as the per-layer readers see them in a traced run.

The program traces itself while a torch profiler records, so its records
cover the traced run's profiled sub-window (serving: the requests of its
first ``profile_seconds``; training: its first ``profile_steps`` steps):

* ``records(ctx)``: the program's ``collect()`` (spans with their units,
  host and CUDA-event milliseconds; counters), kept on the context as
  ``program``; None for a program without that module or with no record.
* ``span_ms(rec, names, field, inside)``: the milliseconds and the units
  of the spans named ``names`` (those with an ancestor named ``inside``).
* ``idle_under(trace, name)``: the seconds of the profiled sub-window in
  which no device operation ran while a host range named ``name`` was open
  in the trace. The program's spans nest on one thread, so these are the
  instants whose innermost ``tce.*`` range is ``name`` or one of its
  descendants; the ranges are the trace's own host events, on the device
  operations' clock. None when the trace holds no such range.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np


def records(ctx) -> Optional[Dict]:
    if "program" not in ctx.__dict__:
        ctx.program = None
        try:
            from tce_rvos_tpu_torch.utils import profiling
        except ImportError:
            return None
        collect = getattr(profiling, "collect", None)
        if collect is not None:
            got = collect()
            if got["spans"] or got["counters"]:
                ctx.program = got
    return ctx.program


def span_ms(rec: Dict, names: Sequence[str], field: str = "host_ms",
            inside: Optional[str] = None) -> Tuple[float, float]:
    """(milliseconds, units) summed over the spans named ``names``; the
    CUDA-event ``device_ms`` falls back to the host's where the run had no
    CUDA (the CPU tests)."""
    by_id = {s["id"]: s for s in rec["spans"]}

    def within(s) -> bool:
        while s["parent"] is not None:
            s = by_id.get(s["parent"])
            if s is None:
                return False
            if s["name"] == inside:
                return True
        return False

    ms = units = 0.0
    for s in rec["spans"]:
        if s["name"] in names and (inside is None or within(s)):
            value = s[field]
            ms += value if value is not None else s["host_ms"]
            units += s["units"] or 0
    return ms, units


def _overlap(a: np.ndarray, b: np.ndarray) -> float:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i, 0], b[j, 0]), min(a[i, 1], b[j, 1])
        if hi > lo:
            total += hi - lo
        if a[i, 1] < b[j, 1]:
            i += 1
        else:
            j += 1
    return total


def idle_under(trace, name: str) -> Optional[float]:
    if trace is None:
        return None
    hit = np.asarray([n == name for n in trace.host_names], bool)
    if not hit.any():
        return None
    ranges = trace._merge(trace.host[hit])
    return float((ranges[:, 1] - ranges[:, 0]).sum()) - _overlap(ranges, trace._union)


def idle_pct(ctx, kind: str, name: str) -> Optional[float]:
    """100 x ``idle_under`` over the profiled sub-window, in a ``kind`` run."""
    if ctx.kind != kind or ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    idle = idle_under(ctx.trace, name)
    return None if idle is None else 100.0 * idle / ctx.trace.window_s


def per_unit(ctx, kind: str, name: str, field: str = "host_ms") -> Optional[float]:
    """The milliseconds of the spans named ``name`` over their units, in a
    ``kind`` run."""
    rec = records(ctx) if ctx.kind == kind else None
    if rec is None:
        return None
    ms, units = span_ms(rec, [name], field)
    return ms / units if units else None

"""Tracing of the port: spans and counters inside the program, on the
profiler's clock, and the exporter (counterpart of
``tce_rvos_tpu/utils/profiling.py``).

  * ``span(name, units=None)``: a context manager around one stage of the
    program. Off (the default) it returns one shared no-op object and
    records nothing. On, it records its name, an id, its parent's id (the
    innermost span open on this thread), its root's id (the outermost
    span open on this thread: the request or the train step the stage
    belongs to), the host's start and end (``time.perf_counter_ns``), on
    a machine with CUDA a pair of timing events on the current stream
    (read by ``collect``), and the units it did (frames,
    expression-frames, steps). While a torch profiler records it also
    opens ``torch.profiler.record_function(name)``, so the profiler's
    trace holds the span as a host range on the kernels' clock.
  * ``count(name, n=1, site=None)``: adds ``n`` to a counter while tracing
    is on, and to the same counter under ``site``, by default the name of
    the innermost span open on this thread (``site()``).
  * Tracing is on inside ``tracing()``, which first clears the records,
    and while a torch profiler records on this thread (``trace``, or a
    caller's own ``torch.profiler.profile``): ``enabled()``.
  * ``collect()``: the records, which stay in memory until then:
    ``{"spans": [...], "counters": {name: n}, "counters_by_span": {span
    name: {name: n}}, "clock_offset_ns": ...}``. Each span has ``name``,
    ``id``, ``parent``, ``root``, ``units``, ``host_start_ns``,
    ``host_end_ns``, ``host_ms`` and ``device_ms`` (the CUDA events'
    milliseconds, None without CUDA). ``clock_offset_ns`` added to a
    ``host_*_ns`` gives the Unix time in nanoseconds, the clock of an
    exported Chrome trace (its ``baseTimeNanoseconds`` plus ``ts``).
    ``counters()``: the counters' totals alone, without waiting for the
    device.
  * ``recording(begin, end)``: while a CUDA graph is captured, the spans
    and counters of the captured code, whether tracing is on or not, as a
    list of steps: each span's entry and exit end the segment being
    captured (``end()`` returns it) and begin the next (``begin()``), so a
    segment holds the work of one stretch between span boundaries; the
    counts are kept in their place. ``replay(steps, run)`` runs the
    segments in order (``run(segment)``), each under the spans that were
    open around it, and adds the counts again: spans and counters as an
    eager run gives them while tracing is on, nothing while it is off.
  * ``trace(logdir)``: the exporter: the block under ``torch.profiler``
    (CPU and, where there is one, CUDA activity) and ``tracing()``; it
    writes the Chrome trace ``trace.json`` (Perfetto, chrome://tracing)
    and ``spans.json`` (``collect()``) under ``logdir``, and yields the
    profiler.

A span's host clock is read right after its ``record_function`` range
opens and right after it closes, so its host duration and the range's in
the profiler's trace agree to some tens of microseconds (the first
``record_function`` of a process pays a start-up of about a millisecond
inside the range).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional

import torch

TRACE_FILE = "trace.json"
SPANS_FILE = "spans.json"

_ON = False  # inside tracing()
_profiler_on = torch._C._autograd._profiler_enabled
_lock = threading.Lock()
_local = threading.local()  # .stack: the spans open on this thread
_ids = itertools.count(1)
_spans: List["_Span"] = []
_counters: Dict[str, int] = collections.Counter()
_by_span: Dict[str, Dict[str, int]] = collections.defaultdict(collections.Counter)
_cuda: Optional[bool] = None  # torch.cuda.is_available(), read at the first span


def enabled() -> bool:
    return _ON or _profiler_on()


def _stack() -> List["_Span"]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOOP = _NoSpan()


class _Span:
    __slots__ = ("name", "units", "id", "parent", "root", "t0", "t1", "events", "rf")

    def __init__(self, name: str, units):
        self.name, self.units = name, units
        self.id = next(_ids)

    def __enter__(self):
        global _cuda
        stack = _stack()
        up = stack[-1] if stack else None
        self.parent = up.id if up is not None else None
        self.root = up.root if up is not None else self.id
        stack.append(self)
        if _cuda is None:
            _cuda = torch.cuda.is_available()
        self.events = None
        if _cuda:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.rf = None
        if _profiler_on():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        _stack().pop()
        with _lock:
            _spans.append(self)
        return False

    def record(self) -> Dict:
        device_ms = None
        if self.events is not None:
            self.events[1].synchronize()
            device_ms = self.events[0].elapsed_time(self.events[1])
        return {"name": self.name, "id": self.id, "parent": self.parent, "root": self.root,
                "units": self.units, "host_start_ns": self.t0, "host_end_ns": self.t1,
                "host_ms": (self.t1 - self.t0) * 1e-6, "device_ms": device_ms}


class _Boundary:
    """A span met while a capture is recorded (``recording``)."""

    __slots__ = ("rec", "name", "units")

    def __init__(self, rec: "_Recording", name: str, units):
        self.rec, self.name, self.units = rec, name, units

    def __enter__(self):
        self.rec.cut()
        self.rec.steps.append(("open", self.name, self.units))
        self.rec.names.append(self.name)
        return self

    def __exit__(self, *exc) -> bool:
        self.rec.cut()
        self.rec.steps.append(("close",))
        self.rec.names.pop()
        return False


class _Recording:
    __slots__ = ("begin", "end", "steps", "names")

    def __init__(self, begin, end):
        self.begin, self.end = begin, end
        self.steps: List[tuple] = []
        self.names: List[str] = []  # the recorded spans open

    def cut(self) -> None:
        self.steps.append(("segment", self.end()))
        self.begin()


def span(name: str, units=None):
    """A span of the stage ``name`` that did ``units`` of work; the shared
    no-op while tracing is off (a boundary of the segments while a
    capture is recorded on this thread)."""
    rec = getattr(_local, "recording", None)
    if rec is not None:
        return _Boundary(rec, name, units)
    if not (_ON or _profiler_on()):
        return _NOOP
    return _Span(name, units)


def site() -> Optional[str]:
    """The name of the innermost span open on this thread, or None."""
    rec = getattr(_local, "recording", None)
    if rec is not None and rec.names:
        return rec.names[-1]
    stack = getattr(_local, "stack", None)
    return stack[-1].name if stack else None


def count(name: str, n: int = 1, site: Optional[str] = None) -> None:
    """Adds ``n`` to the counter ``name`` while tracing is on, and to its
    count under ``site`` (the innermost open span's name by default)."""
    rec = getattr(_local, "recording", None)
    if rec is not None:  # the replay's innermost span stands for a site of None
        rec.steps.append(("count", name, n, site))
        return
    if not (_ON or _profiler_on()):
        return
    if site is None:
        stack = getattr(_local, "stack", None)
        site = stack[-1].name if stack else None
    with _lock:
        _counters[name] += n
        if site is not None:
            _by_span[site][name] += n


def _clear() -> None:
    with _lock:
        _spans.clear()
        _counters.clear()
        _by_span.clear()


@contextlib.contextmanager
def recording(begin, end):
    """Records the spans and counters of the block on this thread as steps
    for ``replay`` (the module's docstring), cutting the segments with
    ``begin()`` and ``end()``: ``begin()`` on entry, each span's entry and
    exit, and ``end()`` on exit, also when the block raises. Yields the
    list of steps, complete once the block has ended."""
    if getattr(_local, "recording", None) is not None:
        raise RuntimeError("a recording is already open on this thread")
    rec = _local.recording = _Recording(begin, end)
    begin()
    try:
        yield rec.steps
    finally:
        _local.recording = None
        rec.steps.append(("segment", end()))


def replay(steps: List[tuple], run) -> None:
    """Runs a recording's segments in order (``run(segment)``) under its
    spans, and adds its counts, as tracing is on or off."""
    opened = []
    try:
        for step in steps:
            kind = step[0]
            if kind == "segment":
                run(step[1])
            elif kind == "open":
                opened.append(span(step[1], step[2]))
                opened[-1].__enter__()
            elif kind == "close":
                opened.pop().__exit__(None, None, None)
            else:
                count(*step[1:])
    finally:
        while opened:  # a segment raised: the spans it left open close
            opened.pop().__exit__(None, None, None)


@contextlib.contextmanager
def tracing():
    """Spans and counters on inside the block, the earlier records cleared."""
    global _ON
    was = _ON
    _clear()
    _ON = True
    try:
        yield
    finally:
        _ON = was


def counters() -> Dict[str, int]:
    """The counters' totals so far, without waiting for the device."""
    with _lock:
        return dict(_counters)


def collect() -> Dict:
    """The records of the spans closed and the counters added since the
    last ``tracing()`` began (waits for each span's end event)."""
    with _lock:
        spans = list(_spans)
        counters = dict(_counters)
        by_span = {k: dict(v) for k, v in _by_span.items()}
    return {"spans": [s.record() for s in spans], "counters": counters,
            "counters_by_span": by_span,
            "clock_offset_ns": time.time_ns() - time.perf_counter_ns()}


@contextlib.contextmanager
def trace(logdir: str):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with tracing():
        with profile(activities=activities) as prof:
            yield prof
        prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))
        with open(os.path.join(logdir, SPANS_FILE), "w") as fh:
            json.dump(collect(), fh)

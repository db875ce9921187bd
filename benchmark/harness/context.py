"""What a traced run hands to the per-layer readers (``benchmark/metrics``)."""

from __future__ import annotations

from typing import Any, Dict, Optional

from . import counts


class Context:
    """Attributes: ``cell`` (its ``config`` and ``mix``), ``kind`` ("serve"
    or "train"), ``window_s``, ``spans`` ({name: [(ms, units)]}, CUDA
    events over the whole window), ``trace`` (a ``trace.Trace`` of the
    profiled sub-window, or None), ``counts`` (the benchmark's arithmetic),
    and by kind: serving ``done`` [(request, seconds)] of the window,
    ``profiled`` (the requests of the profiled sub-window), ``hw`` (the
    padded model size), ``traffic``; training ``steps`` of the window,
    ``profiled_steps``, ``params`` (trained parameter elements),
    ``tokens`` (each batch's real caption tokens)."""

    counts = counts

    def __init__(self, **kw: Any):
        self.trace = None
        self.__dict__.update(kw)

    @property
    def cfg(self) -> Dict:
        return self.cell.config

    @property
    def mix(self) -> Dict:
        return self.cell.mix

    def get(self, name: str, default: Optional[Any] = None) -> Any:
        return self.__dict__.get(name, default)



"""A serving cell: one client in a closed loop calls the port's
``InferenceEngine.run_video_batch`` with the mix's requests, the next when
the last returns (its outputs on the host as numpy)."""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from . import check, counts
from .context import Context
from .traffic import ServeTraffic, rng
from .trace import Spans, Trace, profiler, sync


def _program_config(cfg: Dict):
    import dataclasses

    from tce_rvos_tpu_torch.config import ModelConfig

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in cfg.items() if k in names})


def _call(engine, traffic: ServeTraffic, req):
    mix = traffic.mix
    return engine.run_video_batch(traffic.frames_of(req), req.captions,
                                  f_extra=int(mix["f_extra"]), whole_video=bool(mix["whole_video"]),
                                  exp_batch=int(mix["exp_batch"]))


def sample(traffic: ServeTraffic, seed: int) -> Dict[int, List[int]]:
    """{request index: expressions} compared with the reference: requests of
    the first cycle drawn from the seed, the longest (most frames, then most
    expressions) always among them, and some of each one's expressions."""
    chk = traffic.mix["check"]
    r = rng(seed, 5)
    first = [traffic.request(i) for i in range(traffic.cycle)]
    longest = max(first, key=lambda q: (q.frames, q.expressions, -q.index)).index
    others = [q.index for q in first if q.index != longest]
    picks = [longest] + list(r.choice(others, size=int(chk["requests"]) - 1, replace=False))
    out = {}
    for i in picks:
        e = traffic.request(int(i)).expressions
        k = min(e, int(chk["expressions"]))
        out[int(i)] = sorted(int(x) for x in r.choice(e, size=k, replace=False))
    return out


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        control: bool = False) -> Dict:
    from tce_rvos_tpu_torch.infer import InferenceEngine

    from . import weights

    cfg, mix = cell.config, cell.mix
    phases = {"imports": time.perf_counter() - t_start}
    traffic = ServeTraffic(mix, seed, device)
    phases["inputs"] = time.perf_counter() - t_start
    sd, _ = weights.state_dict(cfg, seed, device)
    phases["weights"] = time.perf_counter() - t_start
    eng = mix["engine"]
    with torch.device(device):
        engine = InferenceEngine(_program_config(cfg), sd, device=device, size=int(eng["size"]),
                                 max_size=int(eng["max_size"]), pad_mult=int(eng["pad_mult"]),
                                 window=int(mix["window"]), t_bucket=int(mix["t_bucket"]))
    phases["engine"] = time.perf_counter() - t_start
    # warm-up: every (frames, expressions) shape of the multiset once
    warm_rng = rng(seed, 6)
    for t, e in sorted(set(traffic.shapes)):
        req = traffic.request(0)
        req = type(req)(-1, t, e, int(warm_rng.integers(0, len(traffic.pool))),
                        [req.captions[0]] * e)
        _call(engine, traffic, req)
    sync(device)
    setup_s = time.perf_counter() - t_start

    picks = sample(traffic, seed)
    spans = Spans(device) if trace else None
    if trace:
        engine.preprocess = spans.wrap("preprocess", engine.preprocess, lambda frames: len(frames))
        engine.backbone = spans.wrap("backbone", engine.backbone, lambda video, mask: video.shape[1])
        engine.trunk = spans.wrap("trunk", engine.trunk, lambda *a, **k: 0)
    prof = profiler(device) if trace else None
    active, prof_window, profiled = False, None, 0
    done, kept = [], {}
    if prof is not None:  # its start-up stays out of the window
        prof.__enter__()
        sync(device)
        active = True
    t0 = time.perf_counter()
    i = 0
    while i == 0 or time.perf_counter() - t0 < seconds:
        req = traffic.request(i)
        ts = time.perf_counter()
        outs = _call(engine, traffic, req)
        te = time.perf_counter()
        done.append((req, te - ts))
        for e in picks.get(i, ()):
            kept[(i, e)] = {k: outs[e][k] for k in check.OUTPUT_KEYS}
        i += 1
        if active and te - t0 >= float(mix["profile_seconds"]):
            sync(device)
            prof_window, profiled, active = time.perf_counter() - t0, i, False
            prof.__exit__(None, None, None)
    sync(device)
    window_s = time.perf_counter() - t0
    if active:  # the window ended first
        prof_window, profiled = window_s, i
        prof.__exit__(None, None, None)
    span_ms = spans.read() if trace else None
    missing = [k for k in ((r, e) for r, es in picks.items() for e in es) if k not in kept]
    while missing:  # a sampled request the window did not reach: wait for it
        r = missing[0][0]
        outs = _call(engine, traffic, traffic.request(r))
        for e in picks[r]:
            kept[(r, e)] = {k: outs[e][k] for k in check.OUTPUT_KEYS}
        missing = [k for k in missing if k not in kept]
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0

    exp_frames = sum(q.frames * q.expressions for q, _ in done)
    lat = np.asarray([s for _, s in done]) * 1e3
    e2e = {"serve_exp_frames_per_s": exp_frames / window_s,
           "serve_p95_ms": float(np.percentile(lat, 95)),
           "setup_s": setup_s}
    out = {"e2e": e2e, "attempted": len(done), "failed": 0, "peak": peak, "window_s": window_s,
           "context": None}
    if trace:
        hw = counts.padded_hw(mix["frame_hw"], int(eng["size"]), int(eng["max_size"]),
                              int(eng["pad_mult"]))
        out["context"] = Context(cell=cell, kind="serve", done=done, window_s=window_s,
                                 spans=span_ms, trace=Trace(prof, prof_window),
                                 profiled=done[:profiled], hw=hw, traffic=traffic)
    del engine
    check.release(device)
    def answers(model):
        return check.reference_answers(picks, lambda r, es: model.answers(
            traffic.frames_of(traffic.request(r)), [traffic.request(r).captions[e] for e in es],
            mix))

    want = answers(check.ServeReference(cfg, sd, device))
    out["numbers"] = check.serve_numbers(kept, want)
    out["notes"] = {"sample": {str(k): v for k, v in picks.items()}, "setup_phases_s": phases}
    if control:  # the reference one precision below, in the port's place
        check.release(device)
        out["control"] = check.serve_numbers(
            answers(check.ServeReference(cfg, sd, device, control=True)), want)
    return out

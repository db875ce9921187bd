"""The port's tracing (``tce_rvos_tpu_torch/utils/profiling.py``) on the
CPU, without JAX:

* off, ``span`` is one shared no-op and nothing is recorded;
* on, spans nest (parent and root ids, units), counts go to the counter
  and to the innermost open span's name (or a given site), ``collect``
  returns the records, and a running ``torch.profiler`` turns tracing on;
* a span's host duration matches its ``record_function`` range in the
  Chrome trace that ``trace(logdir)`` writes, and ``clock_offset_ns``
  puts its start on that trace's clock;
* ``InferenceEngine.run_video_batch`` on a tiny CPU model gives the
  engine's and the model's spans once a window and a chunk, and the trunk's
  padding counters (a whole video of T = 12 at ``t_bucket`` 8 computes 16
  frames, E = 3 is padded to 4);
* the train step's ``tce.train.*`` spans, once a step and in order;
* a tiny image Swin's and Video-Swin's stage spans, in frames, and the
  window attention's padded and real token counters under each.
"""

import json
import time

import numpy as np
import pytest
import torch

from tce_rvos_tpu_torch.config import ModelConfig, TrainConfig
from tce_rvos_tpu_torch.engine import train_one_epoch
from tce_rvos_tpu_torch.infer import InferenceEngine
from tce_rvos_tpu_torch.models.build import build_model
from tce_rvos_tpu_torch.models.criterion import criterion_from_configs
from tce_rvos_tpu_torch.models.swin import SwinBackbone
from tce_rvos_tpu_torch.models.video_swin import VideoSwinBackbone
from tce_rvos_tpu_torch.parallel.train_step import create_train_state, make_train_step
from tce_rvos_tpu_torch.utils import profiling

TINY = ModelConfig(enc_layers=2, dec_layers=2, dim_feedforward=64, text_encoder_layers=1,
                   text_encoder_hidden=32, text_encoder_heads=2, text_encoder_intermediate=64,
                   f_token=2, qtrans=True, with_box_refine=True, binary=True)
MODEL_SPANS = ("tce.model.text", "tce.model.fusion", "tce.model.encoder", "tce.model.decoder",
               "tce.model.pixel_decoder", "tce.model.heads")


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """At most 2 torch threads while this module runs, as
    ``torch_parity_helpers.torch_threads`` gives the modules that import
    JAX (this one does not import that module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _names(records):
    return [s["name"] for s in records["spans"]]


def test_off_records_nothing():
    with profiling.tracing():
        pass  # clears the records
    assert not profiling.enabled()
    a, b = profiling.span("tce.a", 3), profiling.span("tce.b")
    assert a is b
    with a:
        with b:
            profiling.count("c", 5)
            assert profiling.site() is None
    assert profiling.collect()["spans"] == []
    assert profiling.collect()["counters"] == {} == profiling.collect()["counters_by_span"]


def test_nesting_ids_units_and_counts():
    with profiling.tracing():
        assert profiling.enabled()
        for _ in range(2):
            with profiling.span("tce.req", 6) as req:
                with profiling.span("tce.stage", 2) as stage:
                    with profiling.span("tce.inner", 1):
                        profiling.count("launches", 2)
                        assert profiling.site() == "tce.inner"
                    profiling.count("launches")
                profiling.count("launches", site="tce.elsewhere")
                profiling.count("work", 4)
        profiling.count("outside")
    assert not profiling.enabled()
    got = profiling.collect()
    spans = got["spans"]
    assert [s["name"] for s in spans] == ["tce.inner", "tce.stage", "tce.req"] * 2
    by = {(s["name"], s["root"]): s for s in spans}
    roots = sorted({s["root"] for s in spans})
    assert len(roots) == 2 and stage.root == req.id == roots[1]
    for root in roots:
        inner, mid, top = (by[(n, root)] for n in ("tce.inner", "tce.stage", "tce.req"))
        assert top["id"] == root and top["parent"] is None
        assert mid["parent"] == top["id"] and inner["parent"] == mid["id"]
        assert (top["units"], mid["units"], inner["units"]) == (6, 2, 1)
        assert top["host_start_ns"] <= mid["host_start_ns"] <= inner["host_start_ns"]
        assert inner["host_end_ns"] <= mid["host_end_ns"] <= top["host_end_ns"]
        assert top["host_ms"] >= mid["host_ms"] >= inner["host_ms"] >= 0
        assert top["device_ms"] is None  # no CUDA here
    assert got["counters"] == {"launches": 8, "work": 8, "outside": 1}
    assert got["counters_by_span"] == {"tce.inner": {"launches": 4},
                                       "tce.stage": {"launches": 2},
                                       "tce.elsewhere": {"launches": 2},
                                       "tce.req": {"work": 8}}
    with profiling.tracing():  # a new block clears the records
        pass
    assert profiling.collect()["spans"] == [] and profiling.collect()["counters"] == {}


def test_a_running_profiler_turns_tracing_on():
    with profiling.tracing():
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling.enabled()
        with profiling.span("tce.profiled", 1):
            profiling.count("n")
    assert not profiling.enabled()
    got = profiling.collect()
    assert _names(got) == ["tce.profiled"] and got["counters"] == {"n": 1}


def test_span_host_duration_matches_the_chrome_trace(tmp_path):
    """Each span's host duration against its ``record_function`` range in
    ``trace.json`` (the median of the gaps within 0.1 ms: a preemption
    between the two clocks' readings can move one), and its start with
    ``clock_offset_ns`` against the range's start on the trace's clock."""
    x = torch.randn(96, 96)
    with profiling.trace(str(tmp_path)):
        with profiling.span("tce.warmup"):  # the first record_function starts up
            x @ x
        for i in range(7):
            with profiling.span(f"tce.s{i}", 1):
                for _ in range(3 + i):
                    x = torch.tanh(x @ x)
                time.sleep(0.002)
    with open(tmp_path / profiling.TRACE_FILE) as fh:
        trace = json.load(fh)
    with open(tmp_path / profiling.SPANS_FILE) as fh:
        records = json.load(fh)
    ranges = {e["name"]: e for e in trace["traceEvents"] if e.get("name", "").startswith("tce.s")}
    spans = [s for s in records["spans"] if s["name"].startswith("tce.s")]
    assert len(spans) == 7 and sorted(ranges) == sorted(s["name"] for s in spans)
    base_us = trace.get("baseTimeNanoseconds", 0) / 1e3
    gaps, starts = [], []
    for s in spans:
        e = ranges[s["name"]]
        gaps.append(abs(s["host_ms"] - e["dur"] / 1e3))
        starts.append(abs((s["host_start_ns"] + records["clock_offset_ns"]) / 1e3
                          - (base_us + e["ts"])) / 1e3)
    assert float(np.median(gaps)) < 0.1, gaps
    assert float(np.median(starts)) < 1.0, starts
    assert any(e.get("name") == "aten::mm" for e in trace["traceEvents"])


def _frames(n, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.rand(48, 72, 3).astype(np.float32) for _ in range(n)]


def _children(records, parent_name):
    spans = records["spans"]
    ids = {s["id"] for s in spans if s["name"] == parent_name}
    return sorted(s["name"] for s in spans if s["parent"] in ids)


def test_engine_spans_and_padding_counters():
    engine = InferenceEngine(TINY, build_model(TINY, device="cpu", seed=1).state_dict(),
                             device="cpu", size=64, max_size=96, window=2, t_bucket=8)
    caps = ["a red car", "the dog on the left", "a man"]
    # a whole video: T = 12 -> 16 frames, E = 3 -> 4 in one dispatch
    with profiling.tracing():
        outs = engine.run_video_batch(_frames(12), caps, whole_video=True)
    got = profiling.collect()
    assert [o["pred_logits"].shape[0] for o in outs] == [12] * 3
    assert got["counters"]["engine.trunk_dispatches"] == 1
    assert got["counters"]["engine.trunk_graph_eager"] == 1  # never a graph on the CPU
    assert got["counters"]["engine.trunk_expframes"] == 4 * 16
    assert got["counters"]["engine.trunk_expframes_real"] == 3 * 12
    units = {s["name"]: s["units"] for s in got["spans"]}
    assert units["tce.engine.request"] == 36 and units["tce.engine.outputs"] == 36
    assert units["tce.engine.preprocess"] == units["tce.engine.preprocess.h2d"] == 16
    assert units["tce.engine.backbone"] == 16 and units["tce.engine.trunk"] == 64
    assert _children(got, "tce.engine.request") == sorted([
        "tce.engine.preprocess", "tce.engine.backbone", "tce.engine.trunk",
        "tce.engine.outputs"])
    assert _children(got, "tce.engine.preprocess") == [
        "tce.engine.preprocess.h2d", "tce.engine.preprocess.resize",
        "tce.engine.preprocess.stack"]
    assert _children(got, "tce.engine.backbone") == ["tce.model.backbone"]
    assert _children(got, "tce.engine.trunk") == sorted(MODEL_SPANS)
    assert _children(got, "tce.model.encoder") == ["tce.model.ftf"] * TINY.enc_layers
    assert {s["root"] for s in got["spans"]} == {
        s["id"] for s in got["spans"] if s["name"] == "tce.engine.request"}
    # the engine counts under its request, the gates' choices under the
    # backbone and the trunk, the input stage (unpinned on the CPU) under
    # its stack; no MSDA kernel launches on the CPU
    stage = {"engine.pinned_frames": 16, "engine.pinned_allocs": 1}
    gates = ("engine.backbone_graph_eager", "engine.trunk_graph_eager")
    request = {k: v for k, v in got["counters"].items() if k not in gates and k not in stage}
    assert got["counters_by_span"] == {"tce.engine.request": request,
                                       "tce.engine.preprocess.stack": stage,
                                       "tce.engine.backbone": {gates[0]: 1},
                                       "tce.engine.trunk": {gates[1]: 1}}

    # windows of 2 frames over T = 5 (3 windows), E = 3 in chunks of 2 and 1:
    # 6 dispatches, the last window's padded frame and the lone chunk's
    # padding computed but not returned (1 -> 1: a chunk of one is not padded)
    with profiling.tracing():
        engine.run_video_batch(_frames(5, seed=2), caps, exp_batch=2)
    got = profiling.collect()
    names = _names(got)
    # the stage's buffer, sized by the whole video, is reused: no allocation
    assert got["counters"] == {"engine.trunk_dispatches": 6, "engine.trunk_graph_eager": 6,
                               "engine.backbone_graph_eager": 3,
                               "engine.trunk_expframes": 3 * (2 * 2 + 1 * 2),
                               "engine.trunk_expframes_real": 5 * 3,
                               "engine.pinned_frames": 3 * 2}
    assert names.count("tce.engine.request") == 1
    for name in ("tce.engine.preprocess", "tce.engine.preprocess.stack",
                 "tce.engine.backbone", "tce.model.backbone"):
        assert names.count(name) == 3, name
    for name in ("tce.engine.trunk", "tce.engine.outputs") + MODEL_SPANS:
        assert names.count(name) == 6, name
    assert names.count("tce.model.ftf") == 6 * TINY.enc_layers


def _train_batch(seed):
    rng = np.random.RandomState(seed)
    b, t, h, w = 1, 2, 64, 96
    return {"video": rng.randn(b, t, h, w, 3).astype(np.float32),
            "video_mask": np.zeros((b, t, h, w), bool),
            "text_ids": rng.randint(3, 50000, (b, 6)).astype(np.int64),
            "text_attn_mask": np.ones((b, 6), np.int64),
            "sizes": np.asarray([[h, w]], np.int64),
            "targets": {"labels": np.zeros((b, t), np.int64),
                        "boxes": np.asarray([[[0.5, 0.5, 0.3, 0.4]] * t], np.float32),
                        "masks": (rng.rand(b, t, h, w) > 0.5).astype(np.float32),
                        "valid": np.ones((b, t), np.int64)}}


def test_train_step_spans_once_a_step_in_order():
    cfg = ModelConfig(**{**TINY.__dict__, "masks": True, "compute_dtype": "bfloat16"})
    tcfg = TrainConfig()
    model = build_model(cfg, device="cpu", seed=0)
    state = create_train_state(model, tcfg)
    step = make_train_step(criterion_from_configs(cfg, tcfg), cfg.compute_dtype)
    with profiling.tracing():
        state, _ = train_one_epoch(state, step, [_train_batch(0), _train_batch(1)], 0,
                                   print_freq=10**9)
    got = profiling.collect()
    top = [s for s in got["spans"] if s["parent"] is None]
    assert [s["name"] for s in top] == ["tce.train.step", "tce.train.read_metrics"] * 2
    for s in top:
        assert s["units"] == 1
    by_id = {s["id"]: s for s in got["spans"]}
    for step_span in top[::2]:
        phases = sorted((s for s in got["spans"] if s["parent"] == step_span["id"]),
                        key=lambda s: s["host_start_ns"])
        assert [s["name"] for s in phases] == ["tce.train.to_device", "tce.train.forward",
                                               "tce.train.backward", "tce.train.update"]
        assert all(s["root"] == step_span["id"] for s in phases)
        fwd = phases[1]
        inside = sorted((s for s in got["spans"] if s["parent"] == fwd["id"]),
                        key=lambda s: s["host_start_ns"])
        assert [s["name"] for s in inside] == ["tce.train.cast", "tce.model.backbone",
                                               *MODEL_SPANS, "tce.train.criterion"]
        assert {s["units"] for s in inside if s["name"].startswith("tce.model.")} == {2}
        assert all(by_id[s["parent"]]["name"] == "tce.train.forward" for s in inside)


TINY_SWIN = dict(embed_dim=16, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8), drop_path_rate=0.0,
                 channels=[16, 32, 64, 128])
# two 64x96 frames: stage maps 16x24, 8x12, 4x6, 2x3; two blocks a stage.
# Image Swin pads each to whole 7x7 windows: 21x28, 14x14, 7x7, 7x7.
# Video-Swin's windows shrink to an axis no longer than the window (T = 2:
# 2x7x7, 2x7x7, 2x4x6, 2x2x3), so its last two stages have no padding.
SWIN_TOKENS = {
    "swin": ([2 * 2 * 21 * 28, 2 * 2 * 14 * 14, 2 * 2 * 7 * 7, 2 * 2 * 7 * 7],
             [2 * 2 * 16 * 24, 2 * 2 * 8 * 12, 2 * 2 * 4 * 6, 2 * 2 * 2 * 3]),
    "video_swin": ([2 * 2 * 21 * 28, 2 * 2 * 14 * 14, 2 * 2 * 4 * 6, 2 * 2 * 2 * 3],
                   [2 * 2 * 16 * 24, 2 * 2 * 8 * 12, 2 * 2 * 4 * 6, 2 * 2 * 2 * 3]),
}


@pytest.mark.parametrize("kind", sorted(SWIN_TOKENS))
def test_swin_stage_spans_and_window_token_counters(kind):
    torch.manual_seed(0)
    x = torch.randn(2, 3, 64, 96)
    if kind == "swin":
        body = SwinBackbone(dict(TINY_SWIN, window_size=7)).eval()
    else:
        body = VideoSwinBackbone(dict(TINY_SWIN, window_size=(8, 7, 7))).eval()
        x = x.permute(1, 0, 2, 3)[None]  # one clip of two frames [1, 3, 2, H, W]
    stages = [f"tce.model.backbone.stage{i}" for i in range(4)]
    with profiling.tracing():
        pass  # clears the records
    with torch.no_grad():
        body(x)
    off = profiling.collect()
    assert off["spans"] == [] and off["counters"] == {} == off["counters_by_span"]

    with profiling.tracing(), torch.no_grad():
        maps = body(x)
    got = profiling.collect()
    assert [tuple(m.shape) for m in maps] == [(2, 16, 16, 24), (2, 32, 8, 12), (2, 64, 4, 6),
                                              (2, 128, 2, 3)]
    assert [(s["name"], s["units"], s["parent"]) for s in got["spans"]] == [
        (name, 2, None) for name in stages]
    padded, real = SWIN_TOKENS[kind]
    assert got["counters_by_span"] == {
        name: {"swin.window_tokens": p, "swin.window_tokens_real": r}
        for name, p, r in zip(stages, padded, real)}
    assert got["counters"] == {"swin.window_tokens": sum(padded),
                               "swin.window_tokens_real": sum(real)}

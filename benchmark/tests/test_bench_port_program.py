"""The readers of the program's own spans and counters
(``harness/program.py`` and the metrics that use it) on a synthetic traced
run with known spans, counters, host ranges and device operations; their
silence where the program records nothing (a program without its tracing
module); and, through the serve and train runners on the CPU, that a
``--trace 0`` run records nothing (tracing stays off) while a ``--trace 1``
run reads every new metric."""

import math
import time
import types

import pytest
import torch

import bench_helpers as bh
from harness import core, program
from harness.context import Context
from harness.trace import Trace
from tce_rvos_tpu_torch.utils import profiling

NEW = {"serve": ["serve.host_stack_ms_per_frame", "serve.h2d_ms_per_frame",
                 "serve.transformer_ms_per_expframe", "serve.pixel_decoder_ms_per_expframe",
                 "serve.outputs_ms_per_expframe", "serve.idle_in_preprocess_pct",
                 "serve.idle_in_trunk_pct", "serve.padded_work_pct"],
       "train": ["train.idle_in_forward_pct", "train.idle_in_backward_pct",
                 "train.sync_wait_ms_per_step"]}
IDLE = {"serve": ["serve.idle_in_preprocess_pct", "serve.idle_in_trunk_pct"],
        "train": ["train.idle_in_forward_pct", "train.idle_in_backward_pct"]}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _event(name, start_ms, end_ms, device):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start_ms * 1e3, end=end_ms * 1e3),
        device_type=f"DeviceType.{device}", is_user_annotation=False)


def _trace(host, dev, window_s=0.1):
    """A ``Trace`` of host ranges and device operations given in ms."""
    prof = types.SimpleNamespace(events=lambda: (
        [_event(n, a, b, "CPU") for n, a, b in host]
        + [_event(n, a, b, "CUDA") for n, a, b in dev]))
    return Trace(prof, window_s)


def _span(i, name, parent, host_ms, units, device_ms=None):
    return {"name": name, "id": i, "parent": parent, "root": 1, "units": units,
            "host_start_ns": 0, "host_end_ns": int(host_ms * 1e6), "host_ms": host_ms,
            "device_ms": device_ms}


# the device busy over [0, 10], [20, 30] and [50, 60] ms of a 100 ms window
# (70% idle); the input stage over [5, 25] (10 ms idle, the stack's 5 ms in
# it), the trunk over [30, 55] (20 ms idle); a device op under the stack
SERVE_TRACE = dict(
    host=[("tce.engine.request", 1, 90), ("tce.engine.preprocess", 5, 25),
          ("tce.engine.preprocess.stack", 6, 15), ("aten::copy_", 16, 19),
          ("tce.engine.trunk", 30, 55), ("tce.model.encoder", 31, 40)],
    dev=[("k0", 0, 4), ("k1", 3, 10), ("Memcpy HtoD", 20, 30), ("k2", 50, 60)])
SERVE_RECORDS = {
    "spans": [_span(1, "tce.engine.request", None, 80.0, 20),
              _span(2, "tce.engine.preprocess", 1, 20.0, 10),
              _span(3, "tce.engine.preprocess.stack", 2, 4.0, 5),
              _span(4, "tce.engine.preprocess.stack", 2, 6.0, 5),
              _span(5, "tce.engine.preprocess.h2d", 2, 3.0, 10),
              _span(6, "tce.engine.trunk", 1, 25.0, 16),
              _span(7, "tce.model.encoder", 6, 9.0, 16, device_ms=3.0),
              _span(8, "tce.model.ftf", 7, 2.0, 16, device_ms=1.5),
              _span(9, "tce.model.decoder", 6, 3.0, 16, device_ms=2.0),
              _span(10, "tce.model.pixel_decoder", 6, 5.0, 16, device_ms=4.0),
              _span(11, "tce.model.encoder", None, 7.0, 4, device_ms=7.0),  # not a trunk's
              _span(12, "tce.engine.outputs", 1, 1.0, 10)],
    "counters": {"engine.trunk_dispatches": 1, "engine.trunk_expframes": 16,
                 "engine.trunk_expframes_real": 10, "msda.fwd": 12},
    "counters_by_span": {}, "clock_offset_ns": 0}
SERVE_WANT = {"serve.host_stack_ms_per_frame": 1.0, "serve.h2d_ms_per_frame": 0.3,
              "serve.transformer_ms_per_expframe": 0.5,
              "serve.pixel_decoder_ms_per_expframe": 0.4,
              "serve.outputs_ms_per_expframe": 0.1, "serve.idle_in_preprocess_pct": 10.0,
              "serve.idle_in_trunk_pct": 20.0, "serve.padded_work_pct": 37.5}

# steps: the forward over [0, 40] with the device busy over [10, 20] and
# [35, 50]; the backward over [40, 70], busy over [35, 50] and [60, 62]
TRAIN_TRACE = dict(
    host=[("bench.step", 0, 80), ("tce.train.step", 0, 80), ("tce.train.forward", 0, 40),
          ("tce.model.encoder", 5, 15), ("tce.train.backward", 40, 70),
          ("tce.train.read_metrics", 80, 95)],
    dev=[("k0", 10, 20), ("k1", 35, 50), ("k2", 60, 62)])
TRAIN_RECORDS = {
    "spans": [_span(1, "tce.train.step", None, 80.0, 1),
              _span(2, "tce.train.read_metrics", None, 10.0, 1),
              _span(3, "tce.train.step", None, 70.0, 1),
              _span(4, "tce.train.read_metrics", None, 20.0, 1)],
    "counters": {}, "counters_by_span": {}, "clock_offset_ns": 0}
TRAIN_WANT = {"train.idle_in_forward_pct": 25.0, "train.idle_in_backward_pct": 18.0,
              "train.sync_wait_ms_per_step": 15.0}


def _read(name, ctx):
    return core.reader(name)(ctx)


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_readers_on_a_synthetic_run(kind):
    trace, records, want = ((SERVE_TRACE, SERVE_RECORDS, SERVE_WANT) if kind == "serve"
                            else (TRAIN_TRACE, TRAIN_RECORDS, TRAIN_WANT))
    ctx = Context(kind=kind, trace=_trace(**trace), program=records)
    got = {name: _read(name, ctx) for name in NEW[kind]}
    assert got == pytest.approx(want)
    device_idle = _read(f"{kind}.device_idle_pct", ctx)
    assert device_idle == pytest.approx(70.0 if kind == "serve" else 73.0)
    assert sum(got[name] for name in IDLE[kind]) <= device_idle + 0.5
    other = "train" if kind == "serve" else "serve"
    assert all(_read(name, ctx) is None for name in NEW[other])


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_silent_where_the_program_records_nothing(kind):
    """A program without its own spans (host ranges named by the benchmark
    alone, no records): every new reader reads nothing, and raises
    nothing."""
    host = [("bench.preprocess", 0, 20), ("bench.step", 20, 60), ("aten::mm", 30, 40)]
    ctx = Context(kind=kind, trace=_trace(host, [("k0", 5, 10)]), program=None)
    assert all(_read(name, ctx) is None for name in NEW[kind])


def test_idle_under_is_the_range_minus_the_busy_device():
    tr = _trace(**SERVE_TRACE)
    assert program.idle_under(tr, "tce.engine.preprocess.stack") == pytest.approx(0.005)
    assert program.idle_under(tr, "tce.engine.request") == pytest.approx(0.089 - 0.029)
    assert program.idle_under(tr, "tce.model.heads") is None


RUN_CELLS = ["tce_r50_ftf8_iqt.ytvos_whole", "tce_r50_ftf8_iqt.clip_e1",
             "tce_r50_ftf8_iqt.train_b1"]


@pytest.mark.parametrize("name", RUN_CELLS)
def test_trace_0_records_nothing_and_trace_1_reads_every_new_metric(name, monkeypatch):
    cell = bh.tiny_cell(name)
    kind = cell.mix["kind"]
    with profiling.tracing():
        pass  # clears the records
    seen = []
    span = profiling.span
    monkeypatch.setattr(profiling, "span", lambda *a: (seen.append(profiling.enabled()),
                                                       span(*a))[1])
    res = core.run_cell(cell, 2**31 + 17, 0.3, False, "cpu", time.perf_counter())
    assert seen and not any(seen) and not profiling.enabled()
    got = profiling.collect()
    assert got["spans"] == [] and got["counters"] == {}
    assert not set(res["metrics"]) & set(NEW[kind])

    res = core.run_cell(cell, 2**31 + 17, 0.3, True, "cpu", time.perf_counter())
    values = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(NEW[kind]) <= set(values), sorted(values)
    assert all(math.isfinite(values[k]) for k in NEW[kind])
    assert all(0 <= values[k] <= 100 for k in IDLE[kind])
    if name.endswith("clip_e1"):  # E = 1 and the window divides T: no padding
        assert values["serve.padded_work_pct"] == 0
    if name.endswith("ytvos_whole"):  # T = 3 -> 4 (t_bucket 2), E = 3 -> 4
        assert values["serve.padded_work_pct"] > 0

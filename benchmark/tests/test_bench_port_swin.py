"""The image-Swin family (``reference/backbone_swin.py``) and the readers
of the port's Swin spans and counters, on the CPU:

* its FLOP count equals ``torch.utils.flop_counter`` over the reference's
  Swin-L at 224x224, where every stage's map is a whole number of 7x7
  windows, and is within 3% of twice Swin-L's published 34.5 G
  multiply-adds there;
* the port's ``SwinBackbone`` and the reference's take one state dict
  strictly and give the same four maps in float32 at 64x96, where every
  stage pads to whole windows;
* the four readers of the Swin-L cell on synthetic records, on the port's
  own records of a Swin-L forward at the cell's 384x640 (on the meta
  device: shapes and counters, no arithmetic), and their silence on a
  program without the stage spans and counters;
* a tiny traced run of the cell through the serve runner reads all four."""

import math
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import bench_helpers as bh
import reference
from harness import check, core, counts
from harness.context import Context
from reference import backbone_swin
from tce_rvos_tpu_torch.utils import profiling

NAME = "tce_swinl_ftf8_iqt"
CELL = f"{NAME}.clip_e1"
READERS = ["serve.backbone_mfu_pct", "serve.backbone_stage3_ms_per_frame",
           "serve.idle_in_backbone_pct", "serve.window_pad_pct"]
HW = (384, 640)
STAGES = [f"tce.model.backbone.stage{i}" for i in range(4)]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _read(name, ctx):
    return core.reader(name)(ctx)


def _records(spans, by_span):
    return {"spans": spans, "counters": {}, "counters_by_span": by_span, "clock_offset_ns": 0}


def _span(i, name, parent, units, device_ms):
    return {"name": name, "id": i, "parent": parent, "root": 1, "units": units,
            "host_start_ns": 0, "host_end_ns": 1, "host_ms": 2 * device_ms,
            "device_ms": device_ms}


def _padded(n, w=7):
    return -(-n // w) * w


def test_the_family_is_found_by_name():
    cfg = bh.config(NAME)
    assert cfg["backbone"] == "swin_l_p4w7" and cfg["reduced"] == []
    assert reference.family("swin_l_p4w7") is backbone_swin
    assert backbone_swin.channels("swin_l_p4w7") == [192, 384, 768, 1536]
    assert counts.backbone_channels(cfg) == [192, 384, 768, 1536]
    for name in backbone_swin.CONFIGS:
        assert reference.family(name) is backbone_swin


def test_the_count_is_the_flop_counters_and_swins_published_one():
    cfg = reference.model_config(bh.config(NAME))
    body, strides, chans = backbone_swin.build("swin_l_p4w7", cfg)
    assert strides == [4, 8, 16, 32] and chans == [192, 384, 768, 1536]
    body.eval().requires_grad_(False)
    x = torch.randn(1, 3, 224, 224, generator=torch.Generator().manual_seed(0))
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        maps = body(x)
    total, first, sizes = backbone_swin.flops("swin_l_p4w7", {}, 1, (224, 224))
    assert sizes == [(56, 56), (28, 28), (14, 14), (7, 7)]
    assert [tuple(m.shape[1:]) for m in maps] == [(c, *s) for c, s in zip(chans, sizes)]
    assert total == fc.get_total_flops()
    assert first == 2.0 * 56 * 56 * 192 * 3 * 16
    assert abs(total / (2 * 34.5e9) - 1) < 0.03
    # linear in the frames; at the cell's size, 338 GFLOP a frame
    assert backbone_swin.flops("swin_l_p4w7", {}, 5, HW)[0] == 5 * backbone_swin.flops(
        "swin_l_p4w7", {}, 1, HW)[0]
    assert 337e9 < backbone_swin.flops("swin_l_p4w7", {}, 1, HW)[0] < 339e9


def test_the_port_and_the_reference_take_one_state_dict_and_agree():
    from tce_rvos_tpu_torch.models import swin as port_swin

    cfg = reference.model_config(bh.config(NAME))
    ref, _, _ = backbone_swin.build("swin_l_p4w7", cfg)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in ref.parameters():
            p.normal_(0.0, 0.02, generator=g)
    sd = ref.state_dict()
    port = port_swin.SwinBackbone(port_swin.swin_spec("swin_l_p4w7"))
    port.load_state_dict(sd, strict=True)
    assert sorted(port.state_dict()) == sorted(sd)
    x = torch.randn(2, 3, 64, 96, generator=g)
    with torch.no_grad():
        got, want = port.eval()(x), ref.eval()(x)
    # stage maps 16x24, 8x12, 4x6, 2x3: each pads to whole 7x7 windows
    assert [tuple(m.shape) for m in want] == [(2, 192, 16, 24), (2, 384, 8, 12),
                                              (2, 768, 4, 6), (2, 1536, 2, 3)]
    for a, b in zip(got, want):
        assert check.rel_gap(a.numpy(), b.numpy()) < 1e-5


def _cell_context(records, trace=None):
    cell = core.load_cell(CELL)
    hw = counts.padded_hw(cell.mix["frame_hw"], cell.mix["engine"]["size"],
                          cell.mix["engine"]["max_size"], cell.mix["engine"]["pad_mult"])
    assert hw == HW
    return Context(cell=cell, kind="serve", hw=hw, program=records, trace=trace)


def test_the_readers_on_synthetic_records():
    # two 5-frame windows: 10 ms and 30 ms on the device for the backbone,
    # 4 ms and 8 ms in its third stage (stage2)
    spans = [_span(1, "tce.model.backbone", None, 5, 10.0),
             _span(2, STAGES[2], 1, 5, 4.0),
             _span(3, "tce.model.backbone", None, 5, 30.0),
             _span(4, STAGES[2], 3, 5, 8.0)]
    by_span = {STAGES[0]: {"swin.window_tokens": 300, "swin.window_tokens_real": 200},
               STAGES[2]: {"swin.window_tokens": 100, "swin.window_tokens_real": 100}}
    ctx = _cell_context(_records(spans, by_span))
    flops = counts.backbone_flops(ctx.cfg, 10, HW)[0]
    assert _read("serve.backbone_mfu_pct", ctx) == pytest.approx(
        100 * flops / (0.040 * counts.PEAK_BF16_FLOPS))
    assert _read("serve.backbone_stage3_ms_per_frame", ctx) == pytest.approx(1.2)
    # 192^2 x 100 padding over 192^2 x 300 + 768^2 x 100
    assert _read("serve.window_pad_pct", ctx) == pytest.approx(
        100 * 192**2 * 100 / (192**2 * 300 + 768**2 * 100))


def test_the_window_padding_at_the_cells_size_from_the_ports_own_counters():
    """Swin-L on five frames at 384x640: stage maps 96x160, 48x80, 24x40,
    12x20 pad to 98x161, 49x84, 28x42, 14x21; 16.4% of the attention
    branch's linear work is padding."""
    from tce_rvos_tpu_torch.models import swin as port_swin

    with torch.device("meta"):
        body = port_swin.SwinBackbone(port_swin.swin_spec("swin_l_p4w7")).eval()
    with profiling.tracing(), torch.no_grad():
        body(torch.empty(5, 3, *HW, device="meta"))
        rec = profiling.collect()
    depths, chans = (2, 2, 18, 2), [192, 384, 768, 1536]
    pad = padded = 0
    for i, (depth, c) in enumerate(zip(depths, chans)):
        h, w = HW[0] // 4 >> i, HW[1] // 4 >> i
        want = {"swin.window_tokens": depth * 5 * _padded(h) * _padded(w),
                "swin.window_tokens_real": depth * 5 * h * w}
        assert rec["counters_by_span"][STAGES[i]] == want
        padded += c * c * want["swin.window_tokens"]
        pad += c * c * (want["swin.window_tokens"] - want["swin.window_tokens_real"])
    assert [(s["name"], s["units"]) for s in rec["spans"]] == [(n, 5) for n in STAGES]
    got = _read("serve.window_pad_pct", _cell_context(rec))
    assert got == pytest.approx(100 * pad / padded)
    assert abs(got - 16.4) < 0.05


def test_silent_on_a_program_without_the_stage_spans_and_counters():
    """The parent's records: the backbone's span, no stage span or Swin
    counter; the stage and padding readers read nothing, and raise
    nothing; without records every reader reads nothing."""
    spans = [_span(1, "tce.model.backbone", None, 5, 10.0)]
    ctx = _cell_context(_records(spans, {}))
    assert _read("serve.backbone_stage3_ms_per_frame", ctx) is None
    assert _read("serve.window_pad_pct", ctx) is None
    assert math.isfinite(_read("serve.backbone_mfu_pct", ctx))
    ctx = _cell_context(None)
    assert all(_read(name, ctx) is None for name in READERS)


def test_a_tiny_traced_run_of_the_cell_reads_every_new_metric():
    cell = bh.tiny_cell(CELL)
    assert cell.config["backbone"] == "swin_l_p4w7"
    with profiling.tracing():
        pass  # clears the records
    res = core.run_cell(cell, 2**33 + 20, 0.3, True, "cpu", time.perf_counter())
    values = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(READERS) <= set(values), sorted(values)
    assert all(math.isfinite(values[k]) for k in READERS)
    assert 0 <= values["serve.idle_in_backbone_pct"] <= 100
    # tiny frames 48x80 -> 64x112 padded to 64x128: stage maps 16x32, 8x16,
    # 4x8, 2x4 pad to 21x35, 14x21, 7x14, 7x7
    sizes = [(16, 32), (8, 16), (4, 8), (2, 4)]
    chans, depths = [192, 384, 768, 1536], (2, 2, 18, 2)
    padded = sum(d * c * c * _padded(h) * _padded(w)
                 for (h, w), c, d in zip(sizes, chans, depths))
    real = sum(d * c * c * h * w for (h, w), c, d in zip(sizes, chans, depths))
    assert values["serve.window_pad_pct"] == pytest.approx(100 * (1 - real / padded))
    assert res["correct"], res["compared"]

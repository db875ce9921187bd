"""What the CPU can hold of the backbone's CUDA graphs
(``infer.BackboneGraphs``), without JAX:

* ``swin.region_labels``, the shifted blocks' region labels kept on the
  device: ``shift_region_labels``' values, bitwise, in the plain layout
  and in the frame-sharded one (the temporal windows a rank takes); a
  second call with the same key gives the same tensor and uploads nothing
  (``swin.label_uploads``);
* ``backbone_graph_gate`` at the windows the serving mixes of
  ``benchmark/traffic/`` dispatch: every ``clip_e1`` window passes it, the
  ``ytvos_whole`` buckets pass exactly when they hold at most
  ``BACKBONE_GRAPH_MAX_FRAMES`` frames; never on the CPU;
* a CPU engine runs every backbone dispatch eagerly
  (``engine.backbone_graph_eager``), and the tiny Swin backbone's forward
  recorded with the capture stubbed replays the spans and counts of an
  eager run;
* a kept key's labels are never evicted, however many other keys follow.

The captures and replays themselves run on the card:
``tests/test_torch_cuda_kernels.py``.
"""

import json
import math
import pathlib
import types

import numpy as np
import pytest
import torch

from tce_rvos_tpu_torch.config import ModelConfig
from tce_rvos_tpu_torch.infer import (
    BACKBONE_GRAPH_MAX_FRAMES,
    InferenceEngine,
    _pad_to,
    backbone_graph_gate,
    get_size_with_aspect_ratio,
)
from tce_rvos_tpu_torch.models.build import build_model
from tce_rvos_tpu_torch.models.swin import region_labels, shift_region_labels, temporal_window_plan
from tce_rvos_tpu_torch.utils import profiling

TRAFFIC = pathlib.Path(__file__).resolve().parents[1] / "benchmark" / "traffic"
SERVING_MIXES = sorted(p.stem for p in TRAFFIC.glob("*.json")
                       if json.loads(p.read_text())["kind"] == "serve")
TINY_SWIN = ModelConfig(backbone="swin_t_p4w7", enc_layers=1, dec_layers=1, dim_feedforward=64,
                        text_encoder_layers=1, text_encoder_hidden=32, text_encoder_heads=2,
                        text_encoder_intermediate=64, binary=True)


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """At most 2 torch threads while this module runs, as
    ``torch_parity_helpers.torch_threads`` gives the modules that import
    JAX (this one does not import that module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# ---- the region labels --------------------------------------------------------------

# (padded dims, window, shift): Swin-L's stage 1 at 384x640 (96x160 tokens
# padded to 98x161), and Video-Swin's 3D blocks over 5 frames (temporal
# window 5, no temporal shift) and over 16 padded frames (8 shifted by 4)
LAYOUTS = [((98, 161), (7, 7), (3, 3)), ((5, 49, 84), (5, 7, 7), (0, 3, 3)),
           ((16, 14, 21), (8, 7, 7), (4, 3, 3))]


@pytest.mark.parametrize("padded,window,shift", LAYOUTS, ids=["2d", "3d_t5", "3d_t16"])
def test_region_labels_are_the_shift_labels_in_the_plain_layout(padded, window, shift):
    region_labels.cache_clear()
    got = region_labels(padded, window, shift, None, torch.device("cpu"))
    want = shift_region_labels(padded, window, shift)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want)
    assert got.shape == (math.prod(p // w for p, w in zip(padded, window)), math.prod(window))
    assert not got.is_inference()


@pytest.mark.parametrize("frames,first,count", [(12, 0, 6), (12, 6, 6), (16, 8, 8)])
def test_region_labels_take_a_ranks_temporal_windows(frames, first, count):
    """The frame-sharded layout: the labels of the whole padded clip, only
    the temporal windows the rank's frames fall in (``WindowPlan.windows``),
    in their order, as ``_sharded_windows`` built them before."""
    region_labels.cache_clear()
    window, shift = (8, 7, 7), (4, 3, 3)
    plan = temporal_window_plan(frames, window[0], shift[0], first, count)
    padded = (plan.padded_frames, 14, 21)
    grid = shift_region_labels(padded, window, shift)
    n = math.prod(window)
    want = grid.reshape(plan.padded_frames // window[0], -1, n)[list(plan.windows)].reshape(-1, n)
    got = region_labels(padded, window, shift, plan.windows, torch.device("cpu"))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def test_region_labels_upload_once_per_key():
    region_labels.cache_clear()
    key = ((98, 161), (7, 7), (3, 3))
    cpu = torch.device("cpu")
    with profiling.tracing():
        first = region_labels(*key, None, cpu)
        uploads = profiling.counters().get("swin.label_uploads")
        again = region_labels(*key, None, cpu)
        again_uploads = profiling.counters().get("swin.label_uploads")
        other = region_labels((49, 84), (7, 7), (3, 3), None, cpu)
    assert uploads == again_uploads == 1
    assert again is first
    assert other is not first and profiling.counters()["swin.label_uploads"] == 2


# ---- the gate -------------------------------------------------------------------------


def _windows(mix: dict):
    """(frames of each backbone dispatch, padded size) of a serving mix, as
    ``InferenceEngine.run_video_batch`` cuts its requests."""
    eng = mix["engine"]
    shim = types.SimpleNamespace(window=mix["window"], t_bucket=mix["t_bucket"])
    oh, ow = get_size_with_aspect_ratio(tuple(mix["frame_hw"]), eng["size"], eng["max_size"])
    hw = (_pad_to(oh, eng["pad_mult"]), _pad_to(ow, eng["pad_mult"]))
    lengths = {InferenceEngine.window_length(shim, t, mix["whole_video"]) + 2 * mix["f_extra"]
               for t in mix["frames"]}
    return sorted(lengths), hw


@pytest.mark.parametrize("mix", SERVING_MIXES)
def test_backbone_gate_at_the_serving_windows(mix):
    """bf16 windows of the serving mixes: the interactive cells' 5-frame
    windows always replay; a whole-video bucket replays exactly when it is
    at most ``BACKBONE_GRAPH_MAX_FRAMES`` frames at 384x640; f32 counts
    twice its bytes, four times the pixels four times; never on the CPU."""
    spec = json.loads((TRAFFIC / f"{mix}.json").read_text())
    lengths, hw = _windows(spec)
    assert hw == (384, 640)
    bf16 = torch.bfloat16
    passed = [t for t in lengths if backbone_graph_gate(t, hw, bf16, "cuda")]
    assert passed == [t for t in lengths if t <= BACKBONE_GRAPH_MAX_FRAMES]
    if not spec["whole_video"]:
        assert passed == lengths == [5]
    for t in lengths:
        assert backbone_graph_gate(t, hw, torch.float32, "cuda") == (
            2 * t <= BACKBONE_GRAPH_MAX_FRAMES)
        assert backbone_graph_gate(t, (768, 1280), bf16, "cuda") == (
            4 * t <= BACKBONE_GRAPH_MAX_FRAMES)
        assert not backbone_graph_gate(t, hw, bf16, "cpu")


# ---- the engine on the CPU; recording and replay ---------------------------------------


class _StubCapture:
    """``begin``/``end`` for ``profiling.recording``: each segment's index."""

    def __init__(self):
        self.segments = 0

    def begin(self):
        self.segments += 1

    def end(self):
        return self.segments - 1


def _span_tree(records):
    by_id = {s["id"]: s for s in records["spans"]}
    return sorted((s["name"], s["units"], by_id[s["parent"]]["name"] if s["parent"] else None)
                  for s in records["spans"])


def test_cpu_backbone_is_eager_and_its_recording_replays_an_eager_runs_spans():
    """A CPU engine builds no graphs and counts each backbone dispatch as
    eager. The tiny Swin-T model's backbone recorded with the capture
    stubbed (after a first run has kept its labels): one segment more than
    twice its spans, no upload, and replayed under the engine's span the
    spans, counters and counters by span of the eager run."""
    engine = InferenceEngine(TINY_SWIN, build_model(TINY_SWIN, device="cpu", seed=1).state_dict(),
                             device="cpu", size=64, max_size=96, window=2)
    assert engine._backbone_graphs is None and engine._graphs is None
    region_labels.cache_clear()  # no other test's labels
    rng = np.random.RandomState(0)
    video, mask, _ = engine.preprocess([rng.rand(48, 72, 3).astype(np.float32)] * 2)
    with profiling.tracing():
        with profiling.span("tce.engine.backbone", 2):
            want = engine._backbone_eager(video, mask)
    eager = profiling.collect()
    with profiling.tracing():
        got = engine.backbone(video, mask)
    assert profiling.collect()["counters"]["engine.backbone_graph_eager"] == 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # the first run uploads the labels of each stage's shifted blocks, under
    # the stages' spans
    uploads = {k: v["swin.label_uploads"] for k, v in eager["counters_by_span"].items()
               if "swin.label_uploads" in v}
    assert set(uploads) <= {f"tce.model.backbone.stage{i}" for i in range(4)}
    assert 0 < sum(uploads.values()) == eager["counters"]["swin.label_uploads"]
    with profiling.tracing():  # the labels kept: nothing uploaded
        with profiling.span("tce.engine.backbone", 2):
            engine._backbone_eager(video, mask)
    eager = profiling.collect()
    assert "swin.label_uploads" not in eager["counters"]

    cap = _StubCapture()
    with torch.inference_mode():
        with profiling.recording(cap.begin, cap.end) as steps:
            engine._backbone_eager(video, mask)
    n_spans = sum(s[0] == "open" for s in steps)
    assert n_spans == len(eager["spans"]) - 1 == 5  # tce.model.backbone and 4 stages
    assert cap.segments == 2 * n_spans + 1
    with profiling.tracing():
        with profiling.span("tce.engine.backbone", 2):
            profiling.replay(steps, lambda segment: None)
    replayed = profiling.collect()
    assert _span_tree(replayed) == _span_tree(eager)
    assert replayed["counters"] == eager["counters"]
    assert replayed["counters_by_span"] == eager["counters_by_span"]
    for i in range(4):  # each stage's span counts its window tokens
        assert {"swin.window_tokens", "swin.window_tokens_real"} <= set(
            eager["counters_by_span"][f"tce.model.backbone.stage{i}"])


def test_region_labels_outlive_any_number_of_other_keys():
    """A captured graph reads the labels at their address, so a kept key's
    tensor is never evicted: after an engine's first run, 80 other keys
    through ``region_labels`` (more than any bounded cache the size of a
    few engines' shapes would hold), and the engine's next run uploads
    nothing and gives bitwise the first run's features."""
    engine = InferenceEngine(TINY_SWIN, build_model(TINY_SWIN, device="cpu", seed=1).state_dict(),
                             device="cpu", size=64, max_size=96, window=2)
    region_labels.cache_clear()  # no other test's labels
    rng = np.random.RandomState(1)
    video, mask, _ = engine.preprocess([rng.rand(48, 72, 3).astype(np.float32)] * 2)
    with profiling.tracing():
        want = engine._backbone_eager(video, mask)
    assert profiling.collect()["counters"]["swin.label_uploads"] > 0
    cpu = torch.device("cpu")
    for k in range(2, 82):
        region_labels((7 * k, 7 * k + 7), (7, 7), (3, 3), None, cpu)
    with profiling.tracing():
        got = engine._backbone_eager(video, mask)
    assert "swin.label_uploads" not in profiling.collect()["counters"]
    for a, b in zip(got, want):
        assert torch.equal(a, b)

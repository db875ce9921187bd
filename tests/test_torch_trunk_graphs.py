"""What the CPU can hold of the trunk's CUDA graphs (``infer.TrunkGraphs``),
without JAX:

* ``MSDeformAttn``'s kept level normaliser against the per-call tensor it
  replaces, for 2-D and 4-D reference points, under ``inference_mode`` and
  then with grad (a normaliser made in a served forward may be saved for a
  training backward);
* ``graph_gate`` at the serving cells' dispatch shapes: the interactive
  clip (E = 1 over 5 frames) and each whole-video dispatch of the
  Ref-YouTube-VOS mix (E padded to 1, 2, 4 or 8 over 16-40 frames), in
  bf16 and f32;
* ``profiling.recording`` and ``profiling.replay`` with the capture
  stubbed: the segments cut at every span boundary, the spans replayed
  with their parents and units, the counts at their sites, and nothing
  while tracing is off; at the tiny model's trunk forward, the replayed
  spans are an eager run's.

The captures and replays themselves run on the card:
``tests/test_torch_cuda_kernels.py``.
"""

import numpy as np
import pytest
import torch

from tce_rvos_tpu_torch import infer
from tce_rvos_tpu_torch.config import ModelConfig
from tce_rvos_tpu_torch.infer import GRAPH_MAX_EXPFRAMES, InferenceEngine, graph_gate
from tce_rvos_tpu_torch.models.build import build_model
from tce_rvos_tpu_torch.models.transformer import MSDeformAttn
from tce_rvos_tpu_torch.utils import profiling

TINY = ModelConfig(enc_layers=2, dec_layers=2, dim_feedforward=64, text_encoder_layers=1,
                   text_encoder_hidden=32, text_encoder_heads=2, text_encoder_intermediate=64,
                   f_token=2, qtrans=True, with_box_refine=True, binary=True)


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """At most 2 torch threads while this module runs, as
    ``torch_parity_helpers.torch_threads`` gives the modules that import
    JAX (this one does not import that module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# ---- the level normaliser -------------------------------------------------------

SHAPES = ((6, 10), (3, 5))


def _per_call_normalizer(spatial_shapes, dtype, device):
    """The tensor ``MSDeformAttn.forward`` built on every call before."""
    return torch.tensor([[w, h] for h, w in spatial_shapes], dtype=dtype, device=device)


def _msda_case(ref_dim, seed=0):
    g = torch.Generator().manual_seed(seed)
    mod = MSDeformAttn(d_model=32, n_levels=2, n_heads=2, n_points=2)
    with torch.no_grad():
        for p in mod.parameters():  # offsets and weights that depend on the query
            p.add_(0.1 * torch.randn(p.shape, generator=g))
    n, q, s = 2, 7, sum(h * w for h, w in SHAPES)
    query = torch.randn(n, q, 32, generator=g)
    ref = torch.rand(n, q, 2, ref_dim, generator=g)
    value = torch.randn(n, s, 32, generator=g)
    return mod, query, ref, value


def _run(mod, query, ref, value, grad: bool):
    query = query.clone().requires_grad_(grad)
    out, loc, attn = mod(query, ref, value, SHAPES)
    if not grad:
        return out, loc, None, None
    out.square().sum().backward()
    grads = {k: p.grad.clone() for k, p in mod.named_parameters()}
    mod.zero_grad(set_to_none=True)
    return out, loc, query.grad, grads


@pytest.mark.parametrize("ref_dim", [2, 4])
def test_kept_normalizer_is_the_per_call_one(ref_dim):
    """Outputs, sampling locations and gradients bitwise those of the
    per-call normaliser, first under ``inference_mode`` (which makes the
    kept one), then with grad through the kept one."""
    mod, query, ref, value = _msda_case(ref_dim)
    old = MSDeformAttn(d_model=32, n_levels=2, n_heads=2, n_points=2)
    old.load_state_dict(mod.state_dict())
    old._normalizer = _per_call_normalizer
    with torch.inference_mode():
        got, want = _run(mod, query, ref, value, False), _run(old, query, ref, value, False)
    for a, b in zip(got[:2], want[:2]):
        assert torch.equal(a, b)
    kept = list(mod._normalizers.values())
    assert len(kept) == (1 if ref_dim == 2 else 0)
    assert not any(t.is_inference() for t in kept)
    got, want = _run(mod, query, ref, value, True), _run(old, query, ref, value, True)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    assert got[3].keys() == want[3].keys()
    for k in got[3]:
        assert torch.equal(got[3][k], want[3][k]), k
    if ref_dim == 2:  # made once, kept for the grad run
        assert list(mod._normalizers.values())[0] is kept[0]
        assert torch.equal(kept[0], _per_call_normalizer(SHAPES, torch.float32, "cpu"))


# ---- the gate ---------------------------------------------------------------------

# (cell, E padded, frames of the clip): the interactive cells' one dispatch
# shape and the Ref-YouTube-VOS whole-video mix's (T in {12, 20, 28, 36}
# rounded up to t_bucket 8; E in {1, 2, 4, 6, 8} padded to a power of two)
DISPATCHES = [("clip_e1", 1, 5)] + [("ytvos_whole", e, t) for t in (16, 24, 32, 40)
                                    for e in (1, 2, 4, 8)]


@pytest.mark.parametrize("cell,e_pad,t_clip", DISPATCHES,
                         ids=[f"{c}-{e}x{t}" for c, e, t in DISPATCHES])
def test_graph_gate_at_the_serving_dispatches(cell, e_pad, t_clip, monkeypatch):
    """bf16 features at 384x640: a graph exactly when the dispatch is at
    most ``GRAPH_MAX_EXPFRAMES`` expression-frames, the interactive clip
    always; a bucket of four times the pixels counts four times, f32
    features twice; never on the CPU; none once the constant is 0 (read
    at each call)."""
    hw, bf16 = (384, 640), torch.bfloat16
    engages = graph_gate(e_pad, t_clip, hw, bf16, "cuda")
    assert engages == (e_pad * t_clip <= GRAPH_MAX_EXPFRAMES)
    if cell == "clip_e1":
        assert engages
    assert graph_gate(e_pad, t_clip, (768, 1280), bf16, "cuda") == (
        4 * e_pad * t_clip <= GRAPH_MAX_EXPFRAMES)
    assert graph_gate(e_pad, t_clip, hw, torch.float32, "cuda") == (
        2 * e_pad * t_clip <= GRAPH_MAX_EXPFRAMES)
    assert not graph_gate(e_pad, t_clip, hw, bf16, "cpu")
    monkeypatch.setattr(infer, "GRAPH_MAX_EXPFRAMES", 0)
    assert not graph_gate(e_pad, t_clip, hw, bf16, "cuda")


# ---- recording and replay -----------------------------------------------------------


class _StubCapture:
    """``begin``/``end`` for ``profiling.recording``: each segment is the
    list of the work issued while it was open; ``end`` returns its index."""

    def __init__(self):
        self.segments = []

    def begin(self):
        self.segments.append([])

    def end(self):
        return len(self.segments) - 1

    def work(self, x):
        self.segments[-1].append(x)


def test_recording_cuts_at_spans_and_replay_gives_spans_and_counts():
    cap = _StubCapture()
    with profiling.tracing():  # recorded whether tracing is on or not
        with profiling.recording(cap.begin, cap.end) as steps:
            cap.work("a")
            with profiling.span("tce.s1", 3):
                cap.work("b")
                profiling.count("k", 2)
                with profiling.span("tce.s2", 1):
                    cap.work("c")
                    profiling.count("k")
                    profiling.count("j", 5, site="tce.there")
                    assert profiling.site() == "tce.s2"
                cap.work("d")
            profiling.count("top")
            cap.work("e")
        assert profiling.site() is None
    assert profiling.collect()["spans"] == [] and profiling.collect()["counters"] == {}
    assert cap.segments == [["a"], ["b"], ["c"], ["d"], ["e"]]
    assert [s[0] for s in steps if s[0] != "count"] == [
        "segment", "open", "segment", "open", "segment", "close", "segment", "close", "segment"]

    ran = []
    profiling.replay(steps, ran.append)  # tracing off: the segments, no record
    assert ran == [0, 1, 2, 3, 4]
    assert profiling.collect()["spans"] == [] and profiling.collect()["counters"] == {}

    with profiling.tracing():
        with profiling.span("tce.engine.trunk", 5):
            profiling.replay(steps, ran.append)
    assert ran == [0, 1, 2, 3, 4] * 2
    got = profiling.collect()
    by_id = {s["id"]: s for s in got["spans"]}
    parents = {s["name"]: (by_id[s["parent"]]["name"] if s["parent"] else None, s["units"])
               for s in got["spans"]}
    assert parents == {"tce.s2": ("tce.s1", 1), "tce.s1": ("tce.engine.trunk", 3),
                       "tce.engine.trunk": (None, 5)}
    assert got["counters"] == {"k": 3, "j": 5, "top": 1}
    assert got["counters_by_span"] == {"tce.s1": {"k": 2}, "tce.s2": {"k": 1},
                                       "tce.there": {"j": 5}, "tce.engine.trunk": {"top": 1}}


def test_replay_closes_its_spans_when_a_segment_raises():
    cap = _StubCapture()
    with profiling.recording(cap.begin, cap.end) as steps:
        with profiling.span("tce.s1", 1):
            cap.work("x")

    def boom(i):
        if i == 1:
            raise RuntimeError("replay failed")

    with profiling.tracing():
        with pytest.raises(RuntimeError):
            profiling.replay(steps, boom)
        assert profiling.site() is None
    assert [s["name"] for s in profiling.collect()["spans"]] == ["tce.s1"]
    with pytest.raises(RuntimeError):  # one recording at a time on a thread
        with profiling.recording(cap.begin, cap.end):
            with profiling.recording(cap.begin, cap.end):
                pass


def _span_tree(records):
    by_id = {s["id"]: s for s in records["spans"]}
    return sorted((s["name"], s["units"], by_id[s["parent"]]["name"] if s["parent"] else None)
                  for s in records["spans"])


def test_replayed_trunk_spans_are_an_eager_runs():
    """The tiny model's trunk forward recorded with the capture stubbed: one
    segment more than twice its spans, and replayed under the engine's span
    the same spans (names, units, parents) as the eager forward's."""
    engine = InferenceEngine(TINY, build_model(TINY, device="cpu", seed=1).state_dict(),
                             device="cpu", size=64, max_size=96, window=2)
    rng = np.random.RandomState(0)
    video, mask, size = engine.preprocess([rng.rand(48, 72, 3).astype(np.float32)] * 2)
    feats = engine.backbone(video, mask)
    ids, attn = np.asarray([[0, 11, 12, 2]] * 2), np.ones((2, 4), np.int64)

    def forward():
        return engine.model(None, mask, *engine._inputs(ids, attn, size),
                            precomputed_feats=feats)

    with torch.inference_mode():
        with profiling.tracing():
            with profiling.span("tce.engine.trunk", 4):
                forward()
        eager = profiling.collect()
        cap = _StubCapture()
        with profiling.recording(cap.begin, cap.end) as steps:
            forward()
    n_spans = sum(s[0] == "open" for s in steps)
    assert n_spans == len(eager["spans"]) - 1 == 6 + TINY.enc_layers
    assert len(cap.segments) == 2 * n_spans + 1
    with profiling.tracing():
        with profiling.span("tce.engine.trunk", 4):
            profiling.replay(steps, lambda segment: None)
    assert _span_tree(profiling.collect()) == _span_tree(eager)

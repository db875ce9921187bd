"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card: the 2D MSDA forward and backward (flat and staged
path, two levels with the runtime loops and the flagship's L = P = 4), the
3D ones (the runtime loops, the flagship shape and its edge cases, and the
forward's query frames fewer than the value's, as the frame-sharded
forward calls it) and the
fused flat AdamW update (``csrc/flat_adamw.cu``: its float4 and its
one-float path, four tiers, the clip on and off, early and late steps),
the engine's input stage on the card (the pinned ``FrameStage``
against the stack and pageable copy, bitwise) and the engine's trunk and
backbone replayed from CUDA graphs against their eager runs (bitwise,
with the spans and counters a replay gives).

The file imports torch, numpy, pytest and the port only, so that it runs
on a machine with a GPU and no JAX:

    python -m pytest tests/test_torch_cuda_kernels.py -q

Its tests (marker ``cuda``) skip on a machine without a CUDA device;
``chip_smoke.py`` makes the same comparisons at the model's call shapes.
The seeded op inputs defined here also feed the CPU tests of
``tests/test_torch_msda.py`` and ``tests/test_torch_msda3d.py``.
"""

import numpy as np
import pytest
import torch

from tce_rvos_tpu_torch.config import ModelConfig
from tce_rvos_tpu_torch.infer import InferenceEngine, backbone_graph_gate
from tce_rvos_tpu_torch.models.build import build_model
from tce_rvos_tpu_torch.models.text_encoder import tokenize
from tce_rvos_tpu_torch.ops.msda import ms_deform_attn_3d_plain, ms_deform_attn_plain
from tce_rvos_tpu_torch.ops.flat_adamw_cuda import UpdateScalars, flat_adamw_cuda
from tce_rvos_tpu_torch.ops.msda_cuda import ms_deform_attn, ms_deform_attn_3d
from tce_rvos_tpu_torch.parallel.flat_adamw import flat_adamw_update_plain
from tce_rvos_tpu_torch.utils import profiling

SHAPES_SEP_2D = ((40, 64), (4, 8))  # 2560-pixel level: the Pallas sep kernel
SHAPES_SEP_3D = ((40, 32), (4, 8))  # 1280-pixel level: the Pallas 3D sep kernel
FLAGSHIP = ((48, 80), (24, 40), (12, 20), (6, 10))  # 384x640 clip


def op_inputs_2d(shapes, n=2, q=12, m=2, d=8, p=3, seed=0):
    """value, loc [N, Q, M, L, P, 2] (x, y in [-0.2, 1.2]; point 0 of every
    level and head on a pixel centre), attn (normalised over L x P)."""
    rng = np.random.RandomState(seed)
    s = sum(h * w for h, w in shapes)
    l = len(shapes)
    value = rng.randn(n, s, m, d).astype(np.float32)
    loc = (rng.rand(n, q, m, l, p, 2) * 1.4 - 0.2).astype(np.float32)  # outside [0, 1] too
    # exact pixel centres for the first point of every level and head
    for lvl, (h, w) in enumerate(shapes):
        px = rng.randint(0, w, (n, q, m))
        py = rng.randint(0, h, (n, q, m))
        loc[:, :, :, lvl, 0, 0] = (px + 0.5) / w
        loc[:, :, :, lvl, 0, 1] = (py + 0.5) / h
    attn = rng.rand(n, q, m, l, p).astype(np.float32) + 1e-3
    attn /= attn.reshape(n, q, m, l * p).sum(-1)[..., None, None]
    return value, loc, attn


def op_inputs_3d(shapes, n=3, q=12, m=2, d=8, p=4, seed=0):
    """value, loc [N, Q, M, L, P, 3], attn. Points 0: pixel centres on the
    query's own frame ((n + 0.5) / N, an exact-integer f_im); points 1:
    halfway between two frames; the rest: x, y in [-0.2, 1.2] and frames
    in [-0.3, 1.3] (outside [0, N - 1] too)."""
    rng = np.random.RandomState(seed)
    s = sum(h * w for h, w in shapes)
    l = len(shapes)
    value = rng.randn(n, s, m, d).astype(np.float32)
    loc = (rng.rand(n, q, m, l, p, 3) * 1.4 - 0.2).astype(np.float32)
    loc[..., 2] = rng.rand(n, q, m, l, p) * 1.6 - 0.3
    for lvl, (h, w) in enumerate(shapes):
        px = rng.randint(0, w, (n, q, m))
        py = rng.randint(0, h, (n, q, m))
        loc[:, :, :, lvl, 0, 0] = (px + 0.5) / w
        loc[:, :, :, lvl, 0, 1] = (py + 0.5) / h
    own = (np.arange(n, dtype=np.float32) + np.float32(0.5)) / np.float32(n)
    loc[..., 0, 2] = own[:, None, None, None]
    loc[..., 1, 2] = (rng.randint(0, n - 1, (n, q, m, l)) + 1).astype(np.float32) / n
    attn = rng.rand(n, q, m, l, p).astype(np.float32) + 1e-3
    attn /= attn.reshape(n, q, m, l * p).sum(-1)[..., None, None]
    return value, loc.astype(np.float32), attn


def cotangent(value, loc, seed):
    """A seeded upstream gradient of the op's [N, Q, M * D] output."""
    n, _, m, d = value.shape
    return np.random.RandomState(seed).randn(n, loc.shape[1], m * d).astype(np.float32)


# ---- 2D kernels ----------------------------------------------------------------

# flat path (q = 64) and staged path (q = 600 >= 512) of the 2D kernels, at
# two levels (the runtime loop) and at the flagship's L = P = 4
CUDA_CASES = ((SHAPES_SEP_2D, 64, 4), (SHAPES_SEP_2D, 600, 3), (FLAGSHIP, 600, 4))


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """The hand-written kernel against the plain version on the card, f32
    (rtol = atol = 1e-5) and bf16 value (both round one f32 sum to bf16:
    at most one bf16 step apart), on the flat and the staged path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this comparison on the GPU")
    for shapes, q, p in CUDA_CASES:
        value, loc, attn = (torch.from_numpy(a).cuda()
                            for a in op_inputs_2d(shapes, n=3, q=q, m=8, d=32, p=p))
        for dtype, rtol, atol in ((torch.float32, 1e-5, 1e-5), (torch.bfloat16, 8e-3, 1e-2)):
            v = value.to(dtype)
            got = ms_deform_attn(v, shapes, loc, attn)
            torch.cuda.synchronize()
            want = ms_deform_attn_plain(v, shapes, loc, attn)
            torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_cuda_backward_matches_plain_gradients():
    """The backward kernel (through ``MSDeformAttnFunction``) against
    autograd through the plain version on the card, on the flat and the
    staged path. d_loc and d_attn are f32 sums of the same products in
    another order in both dtypes (rtol 1e-4 plus 1e-5 of the largest
    magnitude); d_value is summed with atomics in an order that changes
    from run to run, then cast to the value's dtype: f32 as above, bf16
    within one bf16 step (rtol 1e-2 plus 1e-3 of the largest magnitude)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this comparison on the GPU")
    for shapes, q, p in CUDA_CASES:
        arrays = op_inputs_2d(shapes, n=3, q=q, m=8, d=32, p=p)
        g = torch.from_numpy(cotangent(arrays[0], arrays[1], seed=8)).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            grads = {}
            for which, fn in (("kernel", ms_deform_attn), ("plain", ms_deform_attn_plain)):
                ins = [torch.from_numpy(a).cuda() for a in arrays]
                ins[0] = ins[0].to(dtype)
                for t in ins:
                    t.requires_grad_(True)
                with profiling.tracing():
                    fn(ins[0], shapes, ins[1], ins[2]).backward(g.to(dtype))
                    torch.cuda.synchronize()
                assert profiling.collect()["counters"].get("msda.bwd", 0) == (which == "kernel")
                grads[which] = [t.grad.float() for t in ins]
            for i, (a, b) in enumerate(zip(grads["kernel"], grads["plain"])):
                rtol, atol = (1e-2, 1e-3) if (i == 0 and dtype == torch.bfloat16) else (1e-4, 1e-5)
                torch.testing.assert_close(a, b, rtol=rtol, atol=atol * float(b.abs().max()))


# ---- 3D kernels ----------------------------------------------------------------

def cuda_cases_3d():
    """(name, level shapes, value, loc, attn) for the 3D kernels: the
    runtime loops (two levels, 64 and 600 queries), the flagship's
    L = P = 4 (600 queries), and on that the edge cases: a ragged query
    count, shuffled queries, offsets of about 25 pixels and 6 frames,
    x = -1 or y = -1, f_im exactly -1 or N - 1, integer frames other than
    the own one and halfway frames, frames past both ends, N = 1, and L = 3
    with P = 2 at 600 and at 5 queries. N = 8, so f_im = f * N - 0.5 is
    exact at the chosen f."""
    rng = np.random.RandomState(21)
    yield ("runtime_loop_q64", SHAPES_SEP_3D, *op_inputs_3d(SHAPES_SEP_3D, n=6, q=64, m=8, d=32, p=4))
    yield ("runtime_loop_q600", SHAPES_SEP_3D,
           *op_inputs_3d(SHAPES_SEP_3D, n=6, q=600, m=8, d=32, p=3))
    n, q = 8, 600
    value, loc, attn = op_inputs_3d(FLAGSHIP, n=n, q=q, m=8, d=32, p=4, seed=1)
    yield "flagship", FLAGSHIP, value, loc, attn
    yield "ragged", FLAGSHIP, value, loc[:, :q - 37].copy(), attn[:, :q - 37].copy()
    perm = rng.permutation(q)
    yield "shuffled", FLAGSHIP, value, loc[:, perm].copy(), attn[:, perm].copy()
    wh = np.array([[w, h] for h, w in FLAGSHIP], np.float32)[:, None, :]
    far = loc.copy()
    far[..., :2] += rng.randn(*loc.shape[:-1], 2).astype(np.float32) * 25 / wh
    far[..., 2] += rng.randn(*loc.shape[:-1]).astype(np.float32) * 6 / n
    yield "far", FLAGSHIP, value, far, attn
    half = q // 2
    edge = loc.copy()
    for lvl, (h, w) in enumerate(FLAGSHIP):
        edge[:, :half, :, lvl, 1, 0] = np.float32(-0.5 / w)  # pixel coordinate exactly -1
        edge[:, half:, :, lvl, 1, 1] = np.float32(-0.5 / h)
    yield "x_or_y_at_-1", FLAGSHIP, value, edge, attn
    edge = loc.copy()
    edge[:, :half, :, :, 2, 2] = np.float32(-0.5 / n)        # f_im exactly -1
    edge[:, half:, :, :, 2, 2] = np.float32((n - 0.5) / n)   # f_im exactly N - 1
    yield "f_at_-1_and_N-1", FLAGSHIP, value, edge, attn
    edge = loc.copy()
    shape = edge.shape[:4]
    edge[..., 2, 2] = (rng.randint(0, n, shape) + np.float32(0.5)) / np.float32(n)
    edge[..., 3, 2] = rng.randint(1, n, shape).astype(np.float32) / np.float32(n)
    yield "integer_and_halfway_frames", FLAGSHIP, value, edge, attn
    edge = loc.copy()
    edge[..., 2, 2] = rng.rand(*shape) * -0.4 - 0.05   # f_im -4.1..-0.9
    edge[..., 3, 2] = rng.rand(*shape) * 0.4 + 1.0     # f_im 7.5..10.7
    yield "past_both_ends", FLAGSHIP, value, edge, attn
    one = loc[:1].copy()
    one[..., 0, 2] = 0.5  # the own frame of N = 1
    yield "N1", FLAGSHIP, value[:1].copy(), one, attn[:1].copy()
    shapes3 = FLAGSHIP[:3]
    yield ("L3_P2_q600", shapes3, *op_inputs_3d(shapes3, n=n, q=q, m=8, d=32, p=2, seed=2))
    yield ("L3_P2_q5", shapes3, *op_inputs_3d(shapes3, n=n, q=5, m=8, d=32, p=2, seed=3))


@pytest.mark.cuda
def test_cuda_3d_kernel_matches_plain():
    """The 3D forward kernel against the plain version on the card, f32
    (rtol = atol = 1e-5) and bf16 value (both round one f32 sum to bf16: at
    most one bf16 step apart), on the cases of ``cuda_cases_3d``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this comparison on the GPU")
    for name, shapes, *arrays in cuda_cases_3d():
        value, loc, attn = (torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays)
        for dtype, rtol, atol in ((torch.float32, 1e-5, 1e-5), (torch.bfloat16, 8e-3, 1e-2)):
            v = value.to(dtype)
            with profiling.tracing():
                got = ms_deform_attn_3d(v, shapes, loc, attn)
                torch.cuda.synchronize()
            assert profiling.collect()["counters"] == {"msda3d.fwd": 1}
            want = ms_deform_attn_3d_plain(v, shapes, loc, attn)
            torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol,
                                       msg=lambda m: f"{name} {dtype}: {m}")


@pytest.mark.cuda
def test_cuda_3d_kernel_takes_fewer_query_frames():
    """The frame-sharded forward's 3D call: the queries of frames [3, 6)
    and [7, 8) of N = 8 over the whole value (Nq < N). The kernel against
    the plain version (f32 and bf16, as above) and bitwise against the
    matching rows of the whole call; the backward of such a call raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this comparison on the GPU")
    arrays = op_inputs_3d(FLAGSHIP, n=8, q=600, m=8, d=32, p=4, seed=1)
    value, loc, attn = (torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays)
    for dtype, rtol, atol in ((torch.float32, 1e-5, 1e-5), (torch.bfloat16, 8e-3, 1e-2)):
        v = value.to(dtype)
        whole = ms_deform_attn_3d(v, FLAGSHIP, loc, attn)
        for first, count in ((3, 3), (7, 1)):
            rows = slice(first, first + count)
            with profiling.tracing():
                got = ms_deform_attn_3d(v, FLAGSHIP, loc[rows].contiguous(),
                                        attn[rows].contiguous())
                torch.cuda.synchronize()
            assert profiling.collect()["counters"] == {"msda3d.fwd": 1}
            assert got.shape[0] == count
            want = ms_deform_attn_3d_plain(v, FLAGSHIP, loc[rows], attn[rows])
            torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol,
                                       msg=lambda m: f"Nq={count} {dtype}: {m}")
            assert torch.equal(got, whole[rows])
    ins = [value.clone().requires_grad_(True), loc[3:6].contiguous(), attn[3:6].contiguous()]
    out = ms_deform_attn_3d(ins[0], FLAGSHIP, ins[1], ins[2])
    with pytest.raises(NotImplementedError, match="query frames"):
        out.sum().backward()


@pytest.mark.cuda
def test_cuda_3d_backward_matches_plain_gradients():
    """The 3D backward kernel (through ``MSDeformAttn3DFunction``) against
    autograd through the plain version on the card, on the cases of
    ``cuda_cases_3d``, with the 2D backward's tolerances: d_loc and d_attn
    rtol 1e-4 plus 1e-5 of the largest magnitude; d_value (atomics, then a
    cast) the same in f32 and rtol 1e-2 plus 1e-3 of it in bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this comparison on the GPU")
    for name, shapes, *arrays in cuda_cases_3d():
        arrays = [np.ascontiguousarray(a) for a in arrays]
        g = torch.from_numpy(cotangent(arrays[0], arrays[1], seed=8)).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            grads = {}
            for which, fn in (("kernel", ms_deform_attn_3d), ("plain", ms_deform_attn_3d_plain)):
                ins = [torch.from_numpy(a).cuda() for a in arrays]
                ins[0] = ins[0].to(dtype)
                for t in ins:
                    t.requires_grad_(True)
                with profiling.tracing():
                    fn(ins[0], shapes, ins[1], ins[2]).backward(g.to(dtype))
                    torch.cuda.synchronize()
                assert profiling.collect()["counters"].get("msda3d.bwd", 0) == (which == "kernel")
                grads[which] = [t.grad.float() for t in ins]
            for i, (a, b) in enumerate(zip(grads["kernel"], grads["plain"])):
                rtol, atol = (1e-2, 1e-3) if (i == 0 and dtype == torch.bfloat16) else (1e-4, 1e-5)
                torch.testing.assert_close(a, b, rtol=rtol, atol=atol * float(b.abs().max()),
                                           msg=lambda m: f"{name} {dtype}: {m}")


def adamw_inputs(n: int, seed: int = 0):
    """Seeded flat AdamW buffers of ``n`` live elements: p, g, mu, nu (nu
    non-negative), as numpy. Each element's gradient and moments share a
    magnitude from 1e-8 to 1, so that ``sqrt(nu)`` runs from far below eps
    to far above it."""
    rng = np.random.RandomState(seed)
    mag = (10.0 ** rng.uniform(-8, 0, n)).astype(np.float32)
    p = rng.randn(n).astype(np.float32) * np.float32(0.1)
    g = rng.randn(n).astype(np.float32) * mag
    mu = rng.randn(n).astype(np.float32) * mag * np.float32(1e-3)
    nu = rng.rand(n).astype(np.float32) * np.square(mag * np.float32(1e-3))
    return p, g, mu, nu


def adamw_scalars(n: int, count: int, lr: float = 1e-4, wd: float = 5e-4) -> UpdateScalars:
    """Four tiers over ``n`` elements (ends not on 4-element boundaries),
    the f32 values the port's ``update_scalars`` gives."""
    f32 = np.float32
    his = (n // 5 + 1, n // 2 + 3, 3 * n // 4 + 2, n)
    lrs = [f32(f32(lr) * f32(r)) for r in (1.0, 0.2, 0.1, 1.0)]
    c = f32(count)
    return UpdateScalars(his=his, lrs=tuple(float(x) for x in lrs),
                         decays=tuple(float(f32(1) - x * f32(wd)) for x in lrs),
                         clip=float(f32(0.1)), b1=float(f32(0.9)), omb1=float(f32(1 - 0.9)),
                         b2=float(f32(0.999)), omb2=float(f32(1 - 0.999)),
                         bc1=float(f32(1) - f32(0.9) ** c), bc2=float(f32(1) - f32(0.999) ** c),
                         eps=float(f32(1e-8)))


def adamw_run(update, arrays, offset: int, n: int, gnorm: float, s: UpdateScalars):
    """``update`` (the kernel or the plain version) on copies of ``arrays``
    on the card, the live range ``offset`` floats into p and g; returns
    (p, mu, nu)."""
    p, g, mu, nu = (torch.from_numpy(a).cuda() for a in arrays)
    p, g = p[offset:], g[offset:]
    mu, nu = mu[:n].clone(), nu[:n].clone()
    update(p, g, mu, nu, torch.tensor(gnorm, device="cuda"), s)
    torch.cuda.synchronize()
    return p, mu, nu


@pytest.mark.cuda
@pytest.mark.parametrize("wd", [5e-4, 0.1])
def test_cuda_flat_adamw_matches_plain(wd):
    """The update kernel against ``flat_adamw_update_plain`` on the card:
    on the float4 path (aligned, n not a multiple of 4) and the one-float
    path (the live range one float past a 16-byte boundary), with the
    gradient norm below and above the clip, at Adam steps 1 and 1000, at
    the default weight decay and at one (0.1) whose term dominates the
    rounding; p, mu and nu bitwise equal (every operation is rounded alone
    on both sides), one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this comparison on the GPU")
    n = 1_000_003
    for offset in (0, 1):  # float4 path, one-float path
        for gnorm in (0.05, 7.0):
            for count in (1, 1000):
                arrays = adamw_inputs(n + offset, seed=count)
                s = adamw_scalars(n, count, wd=wd)
                with profiling.tracing():
                    got = adamw_run(flat_adamw_cuda, arrays, offset, n, gnorm, s)
                assert profiling.collect()["counters"] == {"flat_adamw.launches": 1}
                want = adamw_run(flat_adamw_update_plain, arrays, offset, n, gnorm, s)
                for name, a, b in zip(("p", "mu", "nu"), got, want):
                    assert torch.equal(a, b), (
                        f"{name} offset {offset} gnorm {gnorm} count {count} wd {wd}: max "
                        f"|kernel - plain| {float((a - b).abs().max()):.3e}")


@pytest.mark.cuda
def test_cuda_flat_adamw_gate_refuses_adam_without_decay_or_eps():
    """The bitwise gate above sees the kernel launched without its weight
    decay (every decay 1) and without eps: each misses the plain AdamW's
    p, at the default weight decay too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this comparison on the GPU")
    n = 1_000_003
    arrays = adamw_inputs(n, seed=1)
    s = adamw_scalars(n, 1)
    want = adamw_run(flat_adamw_update_plain, arrays, 0, n, 7.0, s)
    for name, wrong in (("no decay", s._replace(decays=(1.0,) * len(s.his))),
                        ("no eps", s._replace(eps=0.0))):
        got = adamw_run(flat_adamw_cuda, arrays, 0, n, 7.0, wrong)
        assert not torch.equal(got[0], want[0]), name


@pytest.mark.cuda
def test_cuda_preprocess_pinned_stage_is_bitwise_the_pageable_path():
    """``preprocess`` on a CUDA engine (frames staged in its pinned buffer,
    one asynchronous upload) against the same engine's stack and pageable
    copy, on 720x1280 windows of f32 and uint8 frames: ``video`` and
    ``mask`` bitwise. Two windows go in a row with no synchronise and the
    first upload queued behind a sleeping kernel: the second window's
    staging waits for it (``engine.pinned_waits``), and both come out
    right. Equal shapes allocate the buffer once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU engine's stage is not pinned")
    cfg = ModelConfig(enc_layers=1, dec_layers=1, dim_feedforward=64, text_encoder_layers=1,
                      text_encoder_hidden=64, text_encoder_heads=4,
                      text_encoder_intermediate=128)
    engine = InferenceEngine(cfg, build_model(cfg, device="cpu").state_dict(), device="cuda")
    rng = np.random.RandomState(0)
    windows = [[rng.rand(720, 1280, 3).astype(np.float32) for _ in range(5)] for _ in range(3)]
    windows.append([rng.randint(0, 256, (720, 1280, 3)).astype(np.uint8) for _ in range(5)])

    class PageableStage:  # the oracle: stack, then a pageable copy
        def upload(self, frames):
            return torch.as_tensor(np.stack([np.asarray(f, np.float32) for f in frames])).to(
                engine.device)

    def pageable(frames):
        stage, engine._stage = engine._stage, PageableStage()
        try:
            return engine.preprocess(frames)
        finally:
            engine._stage = stage

    with profiling.tracing():
        torch.cuda._sleep(200_000_000)  # about 0.1 s: the first upload waits behind it
        got = [engine.preprocess(w) for w in windows]
        waits = profiling.counters().get("engine.pinned_waits", 0)
        torch.cuda.synchronize()
    counters = profiling.collect()["counters"]
    assert engine._stage.buf.is_pinned()
    assert counters["engine.pinned_frames"] == 20 and counters["engine.pinned_allocs"] == 1
    assert waits >= 1
    for w, (video, mask, size) in zip(windows, got):
        want = pageable(w)
        assert size == want[2] == (360, 640)
        assert torch.equal(video, want[0]) and torch.equal(mask, want[1])


# ---- the trunk from CUDA graphs -------------------------------------------------------

SERVING = dict(with_box_refine=True, qtrans=True, f_token=8, binary=True,
               compute_dtype="bfloat16")


def _serving_engine(backbone):
    """The serving cells' model on ``backbone`` at full width, its weights
    the model's init plus N(0, 0.02) drawn on the card."""
    from tce_rvos_tpu_torch.models.referformer import ReferFormer, init_weights

    cfg = ModelConfig(backbone=backbone, **SERVING)
    with torch.device("cuda"):
        model = ReferFormer(cfg)
    gen = torch.Generator("cuda").manual_seed(0)
    init_weights(model, gen)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen, device="cuda") * 0.02)
    return InferenceEngine(cfg, model.state_dict(), device="cuda", window=5)


def _outputs_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), (k, (got[k].float() - want[k].float()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("backbone", ["resnet50", "swin_l_p4w7"])
def test_cuda_trunk_graph_replay_is_bitwise_eager(backbone):
    """The trunk replayed from CUDA graphs against the same engine's eager
    trunk, bitwise, at the interactive cells' dispatch (E = 1 over 5
    720x1280 frames, padded to 384x640) on ResNet-50 and on Swin-L's
    feature channels: two captions and two frame sets, a dispatch of
    another shape (E = 2) captured and replayed in between, and outputs
    returned earlier untouched by later replays. Traced: the first dispatch runs eagerly and captures
    once; a replay counts 12 MSDA launches under the model's spans, which
    keep their parents, units and finite CUDA-event times."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU engine never replays")
    engine = _serving_engine(backbone)
    rng = np.random.RandomState(0)
    clips = []
    for _ in range(2):
        video, mask, size = engine.preprocess(
            [rng.rand(720, 1280, 3).astype(np.float32) for _ in range(5)])
        clips.append((engine.backbone(video, mask), mask, size))
    assert tuple(clips[0][1].shape[2:]) == (384, 640)
    captions = ["the man in a red shirt on the left", "a small brown dog running"]
    caps = [tokenize([c], max_len=16) for c in captions]
    both = tokenize(captions, max_len=16)

    def trunk(clip, text, run=engine.trunk):
        feats, mask, size = clip
        return run(feats, mask, *text, size)

    eager = engine._trunk_eager  # the references
    want = {(c, x): trunk(clips[c], caps[x], eager) for c in range(2) for x in range(2)}
    want_both = trunk(clips[0], both, eager)
    assert engine._graphs.entries == {}

    with profiling.tracing():
        first = trunk(clips[0], caps[0])
    got = profiling.collect()
    assert got["counters"]["engine.trunk_graph_captures"] == 1
    assert "engine.trunk_graph_replays" not in got["counters"]
    assert got["counters"]["msda.fwd"] == 12  # the first dispatch's eager run
    _outputs_equal(first, want[0, 0])

    with profiling.tracing():
        replayed = trunk(clips[0], caps[0])
    got = profiling.collect()
    assert got["counters"]["engine.trunk_graph_replays"] == 1
    assert "engine.trunk_graph_captures" not in got["counters"]
    assert got["counters"]["msda.fwd"] == 12
    sites = got["counters_by_span"]
    assert sites["tce.model.encoder"]["msda.fwd"] == 4 == sites["tce.model.ftf"]["msda.fwd"]
    assert sites["tce.model.decoder"]["msda.fwd"] == 4
    by_id = {s["id"]: s for s in got["spans"]}
    names = [s["name"] for s in got["spans"]]
    for name in ("tce.model.text", "tce.model.fusion", "tce.model.encoder",
                 "tce.model.decoder", "tce.model.pixel_decoder", "tce.model.heads"):
        assert names.count(name) == 1, name
    assert names.count("tce.model.ftf") == 4
    for s in got["spans"]:
        assert np.isfinite(s["device_ms"]) and s["device_ms"] >= 0, s
        if s["name"] == "tce.model.ftf":
            assert by_id[s["parent"]]["name"] == "tce.model.encoder"
        elif s["name"].startswith("tce.model."):
            assert by_id[s["parent"]]["name"] == "tce.engine.trunk" and s["units"] == 5
    _outputs_equal(replayed, want[0, 0])

    other = trunk(clips[1], caps[1])
    _outputs_equal(other, want[1, 1])
    _outputs_equal(trunk(clips[0], both), want_both)  # another shape: eager, captured
    _outputs_equal(trunk(clips[1], caps[0]), want[1, 0])
    _outputs_equal(trunk(clips[0], both), want_both)  # its replay
    _outputs_equal(trunk(clips[0], caps[1]), want[0, 1])
    _outputs_equal(replayed, want[0, 0])  # clones: no later replay wrote them
    _outputs_equal(other, want[1, 1])
    assert len(engine._graphs.entries) == 2


@pytest.mark.cuda
def test_cuda_trunk_graph_captures_and_replays_under_the_profiler():
    """A shape's first dispatch captured, and replayed, while a torch
    profiler records (``infer.main --trace_dir``): outputs bitwise the
    eager trunk's, and the replay's MSDA kernels in the profiler's trace."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU engine never replays")
    from torch.profiler import ProfilerActivity, profile

    engine = _serving_engine("resnet50")
    rng = np.random.RandomState(1)
    video, mask, size = engine.preprocess(
        [rng.rand(720, 1280, 3).astype(np.float32) for _ in range(5)])
    feats = engine.backbone(video, mask)
    text = tokenize(["the man in a red shirt on the left"], max_len=16)
    want = engine._trunk_eager(feats, mask, *text, size)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        first = engine.trunk(feats, mask, *text, size)
        replayed = engine.trunk(feats, mask, *text, size)
        torch.cuda.synchronize()
    _outputs_equal(first, want)
    _outputs_equal(replayed, want)
    assert len(engine._graphs.entries) == 1
    launches = sum(e.count for e in prof.key_averages() if "msda_fwd_kernel<" in e.key)
    assert launches == 24, launches  # the first dispatch's 12 and the replay's 12


# ---- the backbone from CUDA graphs ----------------------------------------------------

# the smallest of each backbone family the port builds (and ResNet's DC5)
BACKBONES = (("resnet50", False), ("resnet50", True), ("swin_t_p4w7", False),
             ("video_swin_t_p4w7", False), ("x3d_xs", False))
SMALL_TRUNK = dict(enc_layers=1, dec_layers=1, dim_feedforward=64, text_encoder_layers=1,
                   text_encoder_hidden=64, text_encoder_heads=4, text_encoder_intermediate=128,
                   compute_dtype="bfloat16")
# frames of the windows, 720x1280 frames at the engine's small size (padded
# 192x320): 5 frames, and 9 (Video-Swin's temporal windows of 8 shifted by
# 4), both under the gate's bytes
BACKBONE_WINDOWS = (5, 5, 9)


def _backbone_engine(backbone, dilation=False):
    """A small trunk on ``backbone`` at its full width, its weights the
    model's init plus N(0, 0.02) drawn on the card, in an engine that
    resizes frames to at most 160x320."""
    from tce_rvos_tpu_torch.models.referformer import ReferFormer, init_weights

    cfg = ModelConfig(backbone=backbone, dilation=dilation, **SMALL_TRUNK)
    with torch.device("cuda"):
        model = ReferFormer(cfg)
    gen = torch.Generator("cuda").manual_seed(0)
    init_weights(model, gen)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen, device="cuda") * 0.02)
    return InferenceEngine(cfg, model.state_dict(), device="cuda", size=160, max_size=320,
                           window=5)


def _backbone_windows(engine, seed=0):
    rng = np.random.RandomState(seed)
    return [engine.preprocess([rng.rand(720, 1280, 3).astype(np.float32) for _ in range(t)])[:2]
            for t in BACKBONE_WINDOWS]


def _features_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and a.stride() == b.stride()
        assert torch.equal(a, b), (a.float() - b.float()).abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("backbone,dilation", BACKBONES,
                         ids=[n + ("_dc5" if d else "") for n, d in BACKBONES])
def test_cuda_backbone_graph_replay_is_bitwise_eager(backbone, dilation):
    """Each family's backbone replayed from CUDA graphs against the same
    engine's eager backbone, bitwise: two 5-frame windows of one shape and
    a 9-frame window, each shape's first dispatch eager and
    captured, the later ones replayed; features returned earlier untouched
    by later replays; the Swin labels uploaded only in the first dispatch
    of a shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU engine never replays")
    engine = _backbone_engine(backbone, dilation)
    windows = _backbone_windows(engine)
    for video, mask in windows:
        assert tuple(video.shape[2:4]) == (192, 320)
        assert backbone_graph_gate(video.shape[1], (192, 320), engine.dtype, "cuda")
    want = [engine._backbone_eager(*w) for w in windows]  # the references
    assert engine._backbone_graphs.entries == {}

    with profiling.tracing():
        first = engine.backbone(*windows[0])
    got = profiling.collect()["counters"]
    assert got["engine.backbone_graph_captures"] == 1
    assert "engine.backbone_graph_replays" not in got and "swin.label_uploads" not in got
    _features_equal(first, want[0])

    with profiling.tracing():
        replayed = engine.backbone(*windows[0])
        other = engine.backbone(*windows[1])
    got = profiling.collect()["counters"]
    assert got["engine.backbone_graph_replays"] == 2
    assert "engine.backbone_graph_captures" not in got and "swin.label_uploads" not in got
    _features_equal(replayed, want[0])
    _features_equal(other, want[1])
    _features_equal(engine.backbone(*windows[2]), want[2])  # another shape: eager, captured
    _features_equal(engine.backbone(*windows[2]), want[2])  # its replay
    _features_equal(engine.backbone(*windows[1]), want[1])
    _features_equal(replayed, want[0])  # clones: no later replay wrote them
    _features_equal(other, want[1])
    assert len(engine._backbone_graphs.entries) == 2


@pytest.mark.cuda
def test_cuda_backbone_replay_reads_kept_labels_after_many_other_keys(monkeypatch):
    """A captured Swin-T window shape, then 80 other keys through
    ``swin.region_labels`` and the device memory refilled with random
    labels of each captured label tensor's size (what an evicted tensor's
    blocks would hold): the captured shape's labels still lie where the
    capture read them and its replay is still bitwise the eager backbone.
    The test keeps the labels' addresses, not the tensors, so that only
    the cache keeps them alive."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU engine never replays")
    from tce_rvos_tpu_torch.models import swin

    engine = _backbone_engine("swin_t_p4w7")
    video, mask = _backbone_windows(engine, seed=2)[0]
    kept = {}
    fetch = swin.region_labels

    def region_labels(*key):
        got = fetch(*key)
        kept[key] = (got.data_ptr(), got.shape, got.dtype)
        return got

    monkeypatch.setattr(swin, "region_labels", region_labels)
    want = engine._backbone_eager(video, mask)
    _features_equal(engine.backbone(video, mask), want)  # eager, then captured
    monkeypatch.setattr(swin, "region_labels", fetch)
    assert kept
    cuda = torch.device("cuda", torch.cuda.current_device())
    for k in range(2, 82):
        fetch((7 * k, 7 * k + 7), (7, 7), (3, 3), None, cuda)
    gen = torch.Generator("cuda").manual_seed(0)
    refill = [torch.randint(0, 64, shape, generator=gen, dtype=dtype, device="cuda")
              for _, shape, dtype in kept.values() for _ in range(8)]
    for key, (ptr, _, _) in kept.items():
        assert fetch(*key).data_ptr() == ptr, key
    with profiling.tracing():
        replayed = engine.backbone(video, mask)
    assert profiling.collect()["counters"]["engine.backbone_graph_replays"] == 1
    _features_equal(replayed, want)
    del refill


def _kernel_counts(prof) -> dict:
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


@pytest.mark.cuda
@pytest.mark.parametrize("backbone", ["swin_t_p4w7", "video_swin_t_p4w7"])
def test_cuda_backbone_replay_spans_and_counts_are_an_eager_runs(backbone):
    """A replay's spans (names, units, parents; finite CUDA-event times),
    counters and counters by span under ``profiling.tracing()`` equal an
    eager run's under the engine's span, the graph counter aside; under
    the profiler, a shape's first dispatch (captured there) and a replay
    give bitwise the eager features, twice the eager run's spans as the
    profiler's ranges and at least twice each of its kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU engine never replays")
    from torch.profiler import ProfilerActivity, profile

    engine = _backbone_engine(backbone)
    video, mask = _backbone_windows(engine, seed=1)[0]
    t = video.shape[1]
    want = engine._backbone_eager(video, mask)  # keeps the labels

    def tree(records):
        by_id = {s["id"]: s for s in records["spans"]}
        for s in records["spans"]:
            assert np.isfinite(s["device_ms"]) and s["device_ms"] >= 0, s
        return sorted((s["name"], s["units"], by_id[s["parent"]]["name"] if s["parent"] else None)
                      for s in records["spans"])

    with profiling.tracing():
        with profiling.span("tce.engine.backbone", t):
            engine._backbone_eager(video, mask)
    eager = profiling.collect()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) as eager_prof:
        engine._backbone_eager(video, mask)
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        first = engine.backbone(video, mask)
        replayed = engine.backbone(video, mask)
        torch.cuda.synchronize()
    _features_equal(first, want)
    _features_equal(replayed, want)
    with profiling.tracing():
        _features_equal(engine.backbone(video, mask), want)
    got = profiling.collect()

    assert tree(got) == tree(eager)
    names = [s["name"] for s in eager["spans"]]
    assert names.count("tce.model.backbone") == 1
    assert {f"tce.model.backbone.stage{i}" for i in range(4)} <= set(names)
    assert got["counters"].pop("engine.backbone_graph_replays") == 1
    got["counters_by_span"]["tce.engine.backbone"].pop("engine.backbone_graph_replays")
    got["counters_by_span"] = {k: v for k, v in got["counters_by_span"].items() if v}
    assert got["counters"] == eager["counters"] and "swin.window_tokens" in got["counters"]
    assert got["counters_by_span"] == eager["counters_by_span"]

    ranges = {e.key: e.count for e in prof.key_averages()}
    for name in set(names) - {"tce.engine.backbone"}:
        assert ranges.get(name) == 2 * names.count(name), (name, ranges.get(name))
    kernels, eager_kernels = _kernel_counts(prof), _kernel_counts(eager_prof)
    assert eager_kernels
    for k, n in eager_kernels.items():
        assert kernels.get(k, 0) >= 2 * n, (k, kernels.get(k, 0), n)

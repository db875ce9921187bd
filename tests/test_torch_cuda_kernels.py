"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card: the 2D MSDA forward and backward (flat and staged
path, two levels with the runtime loops and the flagship's L = P = 4) and
the 3D ones (the runtime loops, the flagship shape and its edge cases).

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

from tce_rvos_tpu_torch.ops.msda import ms_deform_attn_3d_plain, ms_deform_attn_plain
from tce_rvos_tpu_torch.ops.msda_cuda import ms_deform_attn, ms_deform_attn_3d

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
                before = ms_deform_attn.backward_launches
                fn(ins[0], shapes, ins[1], ins[2]).backward(g.to(dtype))
                torch.cuda.synchronize()
                assert ms_deform_attn.backward_launches - before == (which == "kernel")
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
            before = ms_deform_attn_3d.launches
            got = ms_deform_attn_3d(v, shapes, loc, attn)
            torch.cuda.synchronize()
            assert ms_deform_attn_3d.launches == before + 1
            want = ms_deform_attn_3d_plain(v, shapes, loc, attn)
            torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol,
                                       msg=lambda m: f"{name} {dtype}: {m}")


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
                before = ms_deform_attn_3d.backward_launches
                fn(ins[0], shapes, ins[1], ins[2]).backward(g.to(dtype))
                torch.cuda.synchronize()
                assert ms_deform_attn_3d.backward_launches - before == (which == "kernel")
                grads[which] = [t.grad.float() for t in ins]
            for i, (a, b) in enumerate(zip(grads["kernel"], grads["plain"])):
                rtol, atol = (1e-2, 1e-3) if (i == 0 and dtype == torch.bfloat16) else (1e-4, 1e-5)
                torch.testing.assert_close(a, b, rtol=rtol, atol=atol * float(b.abs().max()),
                                           msg=lambda m: f"{name} {dtype}: {m}")

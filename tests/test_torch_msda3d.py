"""The port's temporal MSDA (``--msda_3d``) against the JAX package's, on the
CPU.

* ``ms_deform_attn_3d_plain`` against the XLA op
  ``tce_rvos_tpu/ops/msda.py::ms_deform_attn_3d`` (f32, rtol = atol = 1e-5)
  and against the Pallas forward ``ms_deform_attn_pallas_3d`` in TPU
  interpret mode (rtol 0.05, atol 5e-3: the Pallas kernels round their taps
  to bf16), at shapes with a level above 1024 pixels and at the tiny
  model's level shapes, for N = 3 and N = 6 frames, with frame coordinates
  outside [0, N - 1], exactly on a frame ((n + 0.5) / N, the query's own
  frame at zero offset) and halfway between two frames;
* the plain version's gradients (autograd) against ``jax.vjp`` of the XLA
  op (1e-5 of each gradient's largest magnitude) and against the Pallas 3D
  backward in TPU interpret mode (0.02 of it), with pixel-centre taps and
  exact-integer frames, where both take the right derivative;
* ``MSDeformAttn(is_3d=True)`` against ``MSDeformAttnLayer(is_3d=True)``
  on shared seeded weights (encoder pixel queries, decoder queries with
  2-d and 4-d reference points, a padding mask): output, ``loc[..., :2]``,
  attention weights and every parameter's gradient; with zero temporal
  offsets the 3D module gives the 2D module's output;
* time is the call's whole batch axis, in both packages: with two clips
  stacked on it, clip 0's output depends on clip 1's features;
* the 3D CUDA kernels against the plain version, forward and gradients
  (skip without a card; ``chip_smoke.py`` runs those comparisons on the GPU).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util
from jax.experimental.pallas import tpu as pltpu

from tce_rvos_tpu.models.transformer import MSDeformAttnLayer
from tce_rvos_tpu.ops.msda import ms_deform_attn_3d as jax_ms_deform_attn_3d
from tce_rvos_tpu.ops.pallas_msda_3d import ms_deform_attn_pallas_3d
from tce_rvos_tpu_torch.models.transformer import MSDeformAttn
from tce_rvos_tpu_torch.ops import msda_cuda
from tce_rvos_tpu_torch.ops.msda import ms_deform_attn_3d_plain
from tce_rvos_tpu_torch.ops.msda_cuda import ms_deform_attn, ms_deform_attn_3d
from tce_rvos_tpu_torch.utils.convert import state_dict_from_jax
from torch_parity_helpers import assert_close, prefixed, random_variables, sub_state_dict

SHAPES_SEP = ((40, 32), (4, 8))                # 1280-pixel level: the Pallas sep kernel
SHAPES_TINY = ((8, 12), (4, 6), (2, 3), (1, 2))  # the tiny model's levels at 64x96
SHAPES = {"sep": SHAPES_SEP, "tiny": SHAPES_TINY}


def _op_inputs(shapes, n=3, q=12, m=2, d=8, p=4, seed=0):
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


def _cotangent(value, loc, seed):
    n, _, m, d = value.shape
    return np.random.RandomState(seed).randn(n, loc.shape[1], m * d).astype(np.float32)


def _plain_grads(value, shapes, loc, attn, g):
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (value, loc, attn)]
    out = ms_deform_attn_3d_plain(ins[0], shapes, ins[1], ins[2])
    return torch.autograd.grad(out, ins, torch.from_numpy(g))


CASES = [(k, n) for k in SHAPES for n in (3, 6)]
CASE_IDS = [f"{k}-N{n}" for k, n in CASES]


def test_exact_integer_and_halfway_frames():
    """The inputs really hold the frame coordinates the tests claim."""
    _, loc, _ = _op_inputs(SHAPES_TINY, n=6)
    f_im = torch.from_numpy(loc[..., 2]) * 6 - 0.5
    own = f_im[..., 0]
    assert torch.equal(own, torch.floor(own))  # exact integers: the query's frame
    assert torch.equal(own[:, 0, 0, 0], torch.arange(6, dtype=torch.float32))
    half = f_im[..., 1] - torch.floor(f_im[..., 1])
    assert torch.allclose(half, torch.full_like(half, 0.5), atol=1e-6)
    assert bool((f_im < -1).any()) and bool((f_im > 6).any())  # outside the frames


@pytest.mark.parametrize("shapes_key,n", CASES, ids=CASE_IDS)
def test_plain_3d_matches_jax_xla(shapes_key, n):
    shapes = SHAPES[shapes_key]
    value, loc, attn = _op_inputs(shapes, n=n)
    want = jax_ms_deform_attn_3d(jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(attn))
    got = ms_deform_attn_3d_plain(torch.from_numpy(value), shapes, torch.from_numpy(loc),
                                  torch.from_numpy(attn))
    assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shapes_key,n", CASES, ids=CASE_IDS)
def test_plain_3d_grads_match_jax_xla_vjp(shapes_key, n):
    """1e-5 of each gradient's largest magnitude (plus rtol 1e-5): the same
    f32 products summed in another order. The frame coordinate's gradient is
    live."""
    shapes = SHAPES[shapes_key]
    value, loc, attn = _op_inputs(shapes, n=n, seed=2)
    g = _cotangent(value, loc, seed=3)
    _, vjp = jax.vjp(lambda v, l, a: jax_ms_deform_attn_3d(v, shapes, l, a),
                     *(jnp.asarray(x) for x in (value, loc, attn)))
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    got = _plain_grads(value, shapes, loc, attn, g)
    for name, a, b in zip(("d_value", "d_loc", "d_attn"), got, want):
        assert_close(a, b, rtol=1e-5, atol=1e-5 * float(np.abs(b).max()), name=name)
    d_f = got[1][..., 2]
    assert float(d_f.abs().max()) > 0
    assert float(d_f[..., 0].abs().max()) > 0  # at exact-integer frames too


def test_plain_3d_matches_jax_pallas_interpret():
    value, loc, attn = _op_inputs(SHAPES_SEP, n=3, seed=1)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ms_deform_attn_pallas_3d(
            jnp.asarray(value), SHAPES_SEP, jnp.asarray(loc), jnp.asarray(attn)))
    got = ms_deform_attn_3d_plain(torch.from_numpy(value), SHAPES_SEP, torch.from_numpy(loc),
                                  torch.from_numpy(attn))
    assert_close(got, want, rtol=0.05, atol=5e-3)


def test_plain_3d_grads_match_jax_pallas_backward_interpret():
    """0.02 of each gradient's largest magnitude: the Pallas 3D backward
    rounds the value and the cotangent to bf16."""
    value, loc, attn = _op_inputs(SHAPES_SEP, n=3, seed=4)
    g = _cotangent(value, loc, seed=5)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda v, l, a: ms_deform_attn_pallas_3d(v, SHAPES_SEP, l, a),
                         *(jnp.asarray(x) for x in (value, loc, attn)))
        want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    got = _plain_grads(value, SHAPES_SEP, loc, attn, g)
    for name, a, b in zip(("d_value", "d_loc", "d_attn"), got, want):
        scale = max(float(np.abs(b).max()), 1.0)
        err = float(np.abs(a.numpy() - b).max())
        assert err < 0.02 * scale, (name, err, scale)
    assert float(np.abs(want[1][..., 2]).max()) > 0


def test_wrapper_takes_the_plain_version_on_cpu():
    value, loc, attn = (torch.from_numpy(a) for a in _op_inputs(SHAPES_TINY, d=32))
    for t in (value, loc, attn):
        t.requires_grad_(True)
    before = (ms_deform_attn_3d.launches, ms_deform_attn_3d.backward_launches,
              ms_deform_attn.launches)
    out = ms_deform_attn_3d(value, SHAPES_TINY, loc, attn)
    out.sum().backward()
    assert (ms_deform_attn_3d.launches, ms_deform_attn_3d.backward_launches,
            ms_deform_attn.launches) == before  # no kernel launch on the CPU
    torch.testing.assert_close(out, ms_deform_attn_3d_plain(value, SHAPES_TINY, loc, attn))
    assert float(loc.grad[..., 2].abs().max()) > 0


def test_check_takes_three_coordinates():
    """The kernels' argument check: the 3D op takes [..., 3] locations, the
    2D op [..., 2]."""
    value, loc, attn = (torch.from_numpy(a) for a in _op_inputs(SHAPES_TINY, d=32))
    msda_cuda._check(value, SHAPES_TINY, loc, attn, coords=3)
    with pytest.raises(ValueError, match=r"\[N, Q, M, L, P, 2\]"):
        msda_cuda._check(value, SHAPES_TINY, loc, attn)
    with pytest.raises(ValueError, match=r"\[N, Q, M, L, P, 3\]"):
        msda_cuda._check(value, SHAPES_TINY, loc[..., :2].contiguous(), attn, coords=3)


# ---- the module ------------------------------------------------------------

D_MODEL, HEADS, POINTS = 64, 2, 4  # D = 32 per head, the kernels' width
LEVELS = SHAPES_SEP
N_FRAMES = 3


def _module_case(kind: str, seed: int, n: int = N_FRAMES):
    """(query, reference_points, input_flatten, padding_mask) as numpy."""
    rng = np.random.RandomState(seed)
    s = sum(h * w for h, w in LEVELS)
    src = rng.randn(n, s, D_MODEL).astype(np.float32)
    mask = np.zeros((n, s), bool)
    mask[-1, -8:] = True  # padded pixels of the last frame
    valid = np.ones((n, len(LEVELS), 2), np.float32)
    valid[-1] = [0.9, 0.75]  # [L, (w, h)]
    if kind == "encoder":  # every pixel is a query, on its own grid point
        refs = []
        for h, w in LEVELS:
            gy, gx = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w,
                                 indexing="ij")
            refs.append(np.stack([gx.ravel(), gy.ravel()], -1))
        ref = np.concatenate(refs)[None, :, None] * valid[:, None]
        query = src
    else:
        query = rng.randn(n, 5, D_MODEL).astype(np.float32)
        dims = 4 if kind == "decoder4" else 2
        ref = rng.rand(n, 5, 1, dims).astype(np.float32) * np.concatenate(
            [valid] * (dims // 2), -1)[:, None]
    return query, ref.astype(np.float32), src, mask


def _port_state(flat):
    """JAX leaves of the layer (or gradients shaped like them) -> the port
    module's state_dict layout."""
    return sub_state_dict(
        state_dict_from_jax(prefixed(flat, "transformer/decoder_layers_0/cross_attn")),
        "transformer.decoder.layers.0.cross_attn")


def _layer_and_port(kind, seed):
    arrays = tuple(jnp.asarray(a) for a in _module_case(kind, seed=seed))
    layer = MSDeformAttnLayer(D_MODEL, len(LEVELS), HEADS, POINTS, impl="xla", is_3d=True)
    variables, flat = random_variables(
        lambda key, *a: layer.init(key, a[0], a[1], a[2], LEVELS, a[3]), *arrays,
        seed=seed + 1)
    port = MSDeformAttn(D_MODEL, len(LEVELS), HEADS, POINTS, is_3d=True)
    port.load_state_dict(_port_state(flat), strict=True)
    return layer, variables, port, arrays


def _torch(arrays):
    query, ref, src, mask = (torch.from_numpy(np.array(a)) for a in arrays)
    return query, ref, src, LEVELS, mask


KINDS = ["encoder", "decoder2", "decoder4"]


@pytest.mark.parametrize("kind", KINDS)
def test_msdeformattn_3d_module_matches_jax(kind):
    layer, variables, port, arrays = _layer_and_port(kind, seed=3)
    want = jax.jit(lambda v, *a: layer.apply(v, a[0], a[1], a[2], LEVELS, a[3]))(
        variables, *arrays)
    with torch.inference_mode():
        got = port(*_torch(arrays))
    assert got[1].shape[-1] == 2  # x, y for the consumers
    for name, g, w in zip(("out", "loc", "attn"), got, want):
        assert_close(g, w, rtol=1e-5, atol=1e-5, name=f"{kind} {name}")


@pytest.mark.parametrize("kind", KINDS)
def test_msdeformattn_3d_param_grads_match_jax(kind):
    """d(sum(out * G))/d(parameter) for every parameter, at 1e-5 of each
    gradient's largest magnitude (plus rtol 1e-5); the temporal columns of
    ``sampling_offsets`` (every third) get a gradient."""
    layer, variables, port, arrays = _layer_and_port(kind, seed=6)
    n, q = arrays[0].shape[:2]
    g = np.random.RandomState(7).randn(n, q, D_MODEL).astype(np.float32)

    def loss(params):
        out, _, _ = layer.apply({"params": params}, arrays[0], arrays[1], arrays[2], LEVELS,
                                arrays[3])
        return jnp.sum(out * jnp.asarray(g))

    jgrads = jax.jit(jax.grad(loss))(variables["params"])
    want = _port_state({f"params/{k}": np.array(v) for k, v in
                        traverse_util.flatten_dict(jgrads, sep="/").items()})
    out, _, _ = port(*_torch(arrays))
    (out * torch.from_numpy(g)).sum().backward()
    got = dict(port.named_parameters())
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        scale = float(w.abs().max())
        assert scale > 0, name
        assert_close(got[name].grad, w, rtol=1e-5, atol=1e-5 * scale, name=f"{kind} {name}")
    temporal = got["sampling_offsets.weight"].grad.reshape(-1, 3, D_MODEL)[:, 2]
    assert float(temporal.abs().max()) > 0


@pytest.mark.parametrize("ref_dims", [2, 4])
def test_zero_temporal_offsets_give_the_2d_module(ref_dims):
    """With the temporal rows of ``sampling_offsets`` zero, every tap sits
    on the query's own frame (an exact-integer f_im, lerp weight 1), so the
    3D module gives the 2D module's output on the same weights."""
    query, ref, src, _, mask = _torch(_module_case(f"decoder{ref_dims}", seed=9))
    torch.manual_seed(0)
    m2 = MSDeformAttn(D_MODEL, len(LEVELS), HEADS, POINTS)
    m3 = MSDeformAttn(D_MODEL, len(LEVELS), HEADS, POINTS, is_3d=True)
    with torch.no_grad():
        for lin in (m2.sampling_offsets, m2.attention_weights):
            lin.weight.normal_(0.0, 0.2)
            lin.bias.normal_(0.0, 0.5)
        m3.load_state_dict({k: v for k, v in m2.state_dict().items()
                            if not k.startswith("sampling_offsets")}, strict=False)
        w3 = torch.zeros_like(m3.sampling_offsets.weight).reshape(-1, 3, D_MODEL)
        w3[:, :2] = m2.sampling_offsets.weight.reshape(-1, 2, D_MODEL)
        b3 = torch.zeros_like(m3.sampling_offsets.bias).reshape(-1, 3)
        b3[:, :2] = m2.sampling_offsets.bias.reshape(-1, 2)
        m3.sampling_offsets.weight.copy_(w3.reshape(-1, D_MODEL))
        m3.sampling_offsets.bias.copy_(b3.reshape(-1))
        out2, loc2, attn2 = m2(query, ref, src, LEVELS, mask)
        out3, loc3, attn3 = m3(query, ref, src, LEVELS, mask)
    torch.testing.assert_close(out3, out2, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(loc3, loc2)
    torch.testing.assert_close(attn3, attn2)


def test_fresh_3d_module_init_matches_jax():
    """The 3D offset projection's init: a zero kernel and the 2D directional
    bias with a zero temporal coordinate per point, as the JAX package's
    ``bias3d`` makes it. The JAX package takes the head directions' cosines
    and sines in float32, the port in float64: the zero ones differ by up to
    4e-7 (cos(pi / 2) in float32 is -4.4e-8 before the scaling)."""
    arrays = tuple(jnp.asarray(a) for a in _module_case("decoder2", seed=0))
    layer = MSDeformAttnLayer(D_MODEL, len(LEVELS), HEADS, POINTS, impl="xla", is_3d=True)
    params = jax.jit(lambda key, *a: layer.init(key, a[0], a[1], a[2], LEVELS, a[3]))(
        jax.random.PRNGKey(0), *arrays)["params"]["sampling_offsets"]
    m = MSDeformAttn(D_MODEL, len(LEVELS), HEADS, POINTS, is_3d=True)
    assert_close(m.sampling_offsets.bias, params["bias"], rtol=0, atol=1e-6)
    assert float(np.abs(np.asarray(params["bias"]).reshape(-1, 3)[:, 2]).max()) == 0
    assert float(m.sampling_offsets.weight.detach().abs().max()) == 0


def test_temporal_taps_cross_clips():
    """Time is the call's whole batch axis, in the JAX package and so in the
    port: with two clips of three frames stacked on it, changing only clip
    1's features moves clip 0's output, by the same amount in both."""
    layer, variables, port, arrays = _layer_and_port("decoder2", seed=11)
    query, ref, src, mask = (np.array(a) for a in arrays)
    two = [np.concatenate([a, a]) for a in (query, ref, src, mask)]
    changed = [a.copy() for a in two]
    changed[2][N_FRAMES:] = np.random.RandomState(12).randn(*src.shape)
    apply = jax.jit(lambda v, *a: layer.apply(v, a[0], a[1], a[2], LEVELS, a[3])[0])
    outs = {}
    for which, ins in (("same", two), ("changed", changed)):
        want = np.asarray(apply(variables, *(jnp.asarray(a) for a in ins)))
        with torch.inference_mode():
            got, _, _ = port(*_torch(ins))
        assert_close(got, want, rtol=1e-5, atol=1e-5, name=which)
        outs[which] = got[:N_FRAMES]
    leak = float((outs["changed"] - outs["same"]).abs().max())
    assert leak > 1e-3 * float(outs["same"].abs().max()), leak


# ---- the CUDA kernels (skip without a card) -----------------------------------

FLAGSHIP = ((48, 80), (24, 40), (12, 20), (6, 10))  # 384x640 clip


def _cuda_cases():
    """(name, level shapes, value, loc, attn) for the 3D kernels: the
    runtime loops (two levels, 64 and 600 queries), the flagship's
    L = P = 4 (600 queries), and on that the edge cases: a ragged query
    count, shuffled queries, offsets of about 25 pixels and 6 frames,
    x = -1 or y = -1, f_im exactly -1 or N - 1, integer frames other than
    the own one and halfway frames, frames past both ends, N = 1, and L = 3
    with P = 2 at 600 and at 5 queries. N = 8, so f_im = f * N - 0.5 is
    exact at the chosen f."""
    rng = np.random.RandomState(21)
    yield ("runtime_loop_q64", SHAPES_SEP, *_op_inputs(SHAPES_SEP, n=6, q=64, m=8, d=32, p=4))
    yield ("runtime_loop_q600", SHAPES_SEP,
           *_op_inputs(SHAPES_SEP, n=6, q=600, m=8, d=32, p=3))
    n, q = 8, 600
    value, loc, attn = _op_inputs(FLAGSHIP, n=n, q=q, m=8, d=32, p=4, seed=1)
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
    yield ("L3_P2_q600", shapes3, *_op_inputs(shapes3, n=n, q=q, m=8, d=32, p=2, seed=2))
    yield ("L3_P2_q5", shapes3, *_op_inputs(shapes3, n=n, q=5, m=8, d=32, p=2, seed=3))


@pytest.mark.cuda
def test_cuda_3d_kernel_matches_plain():
    """The 3D forward kernel against the plain version on the card, f32
    (rtol = atol = 1e-5) and bf16 value (both round one f32 sum to bf16: at
    most one bf16 step apart), on the cases of ``_cuda_cases``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this comparison on the GPU")
    for name, shapes, *arrays in _cuda_cases():
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
    ``_cuda_cases``, with the 2D backward's tolerances: d_loc and d_attn
    rtol 1e-4 plus 1e-5 of the largest magnitude; d_value (atomics, then a
    cast) the same in f32 and rtol 1e-2 plus 1e-3 of it in bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this comparison on the GPU")
    for name, shapes, *arrays in _cuda_cases():
        arrays = [np.ascontiguousarray(a) for a in arrays]
        g = torch.from_numpy(_cotangent(arrays[0], arrays[1], seed=8)).cuda()
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

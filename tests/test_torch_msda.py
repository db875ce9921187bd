"""The port's MSDA against the JAX package's, on the CPU.

* ``ms_deform_attn_plain`` against the XLA op ``tce_rvos_tpu/ops/msda.py``
  (f32, rtol = atol = 1e-5) and against the Pallas forward
  ``ms_deform_attn_pallas`` in TPU interpret mode (rtol 0.05, atol 5e-3:
  the Pallas kernel rounds its taps to bf16), at shapes with a level above
  1024 pixels (the Pallas separable kernel), locations outside [0, 1] and
  locations exactly on pixel centres;
* the plain version's gradients (autograd) against ``jax.vjp`` of the XLA
  op (f32, rtol = atol = 1e-5) and against the Pallas backward in TPU
  interpret mode (0.02 of each gradient's largest magnitude: the Pallas
  backward rounds the value and the cotangent to bf16), on the same
  inputs, whose pixel-centre taps check the right-derivative at integer
  sampling points;
* the ``MSDeformAttn`` module against ``MSDeformAttnLayer`` at each call
  shape of the trunk (encoder pixel queries, FTF Q = 8, decoder Q = 5 with
  2-d and 4-d reference points), on shared seeded weights: outputs, and
  the gradients of every parameter;
* what surrounds the 2D kernels on the CPU: their launch plan
  (``launch_plan``: path, queries per block, staged levels, shared-memory
  bytes) and the alignment ``_check`` demands of the pointers (of the 3D
  kernels' too);
* the port imports no JAX, Flax, ``tce_rvos_tpu`` or cv2 module: an AST
  scan of every module (the data pipeline and the trainer included) and of
  ``chip_smoke.py``, and a fresh process that imports every module.

The CUDA kernels against the plain version are in
``tests/test_torch_cuda_kernels.py``.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util
from jax.experimental.pallas import tpu as pltpu

from tce_rvos_tpu.models.transformer import MSDeformAttnLayer
from tce_rvos_tpu.ops.msda import ms_deform_attn as jax_ms_deform_attn
from tce_rvos_tpu.ops.pallas_msda import FLAT_LEVEL_MAX_PIXELS, ms_deform_attn_pallas
from tce_rvos_tpu_torch.models.transformer import MSDeformAttn
from tce_rvos_tpu_torch.ops.msda import ms_deform_attn_plain
from tce_rvos_tpu_torch.ops.msda_cuda import (
    LANES_PER_ROW,
    SMEM_BUDGET,
    THREADS_FLAT,
    THREADS_STAGED,
    _aligned,
    _check,
    launch_plan,
    ms_deform_attn,
)
from tce_rvos_tpu_torch.utils import profiling
from tce_rvos_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_cuda_kernels import FLAGSHIP
from test_torch_cuda_kernels import cotangent as _cotangent
from test_torch_cuda_kernels import op_inputs_2d as _op_inputs
from torch_parity_helpers import torch_threads  # noqa: F401 (autouse fixture)
from torch_parity_helpers import assert_close, prefixed, random_variables, sub_state_dict

REPO = Path(__file__).resolve().parent.parent
SHAPES_SEP = ((40, 64), (4, 8))       # 2560-pixel level: the Pallas sep kernel
SHAPES_FLAT = ((8, 16), (4, 8), (2, 4))
MAX_SMEM = 232_448  # the most shared memory a block may ask for on Hopper


@pytest.mark.parametrize("shapes", [SHAPES_SEP, SHAPES_FLAT], ids=["sep", "flat"])
def test_plain_matches_jax_xla(shapes):
    value, loc, attn = _op_inputs(shapes)
    want = jax_ms_deform_attn(jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(attn))
    got = ms_deform_attn_plain(torch.from_numpy(value), shapes, torch.from_numpy(loc),
                               torch.from_numpy(attn))
    assert_close(got, want, rtol=1e-5, atol=1e-5)


def _plain_grads(value, shapes, loc, attn, g):
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (value, loc, attn)]
    out = ms_deform_attn_plain(ins[0], shapes, ins[1], ins[2])
    return torch.autograd.grad(out, ins, torch.from_numpy(g))


@pytest.mark.parametrize("shapes", [SHAPES_SEP, SHAPES_FLAT], ids=["sep", "flat"])
def test_plain_grads_match_jax_xla_vjp(shapes):
    value, loc, attn = _op_inputs(shapes, seed=2)
    g = _cotangent(value, loc, seed=3)
    _, vjp = jax.vjp(lambda v, l, a: jax_ms_deform_attn(v, shapes, l, a),
                     *(jnp.asarray(x) for x in (value, loc, attn)))
    want = vjp(jnp.asarray(g))
    got = _plain_grads(value, shapes, loc, attn, g)
    for name, a, b in zip(("d_value", "d_loc", "d_attn"), got, want):
        assert_close(a, b, rtol=1e-5, atol=1e-5, name=name)


@pytest.mark.parametrize("shapes", [SHAPES_SEP, SHAPES_FLAT], ids=["sep", "flat"])
def test_plain_grads_match_jax_pallas_backward_interpret(shapes):
    value, loc, attn = _op_inputs(shapes, seed=4)
    g = _cotangent(value, loc, seed=5)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda v, l, a: ms_deform_attn_pallas(v, shapes, l, a),
                         *(jnp.asarray(x) for x in (value, loc, attn)))
        want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    got = _plain_grads(value, shapes, loc, attn, g)
    for name, a, b in zip(("d_value", "d_loc", "d_attn"), got, want):
        scale = max(float(np.abs(b).max()), 1.0)
        err = float(np.abs(a.numpy() - b).max())
        assert err < 0.02 * scale, (name, err, scale)


def test_cpu_output_carries_grad_fn():
    """On the CPU the plain version is differentiable in each input."""
    arrays = _op_inputs(SHAPES_FLAT, d=32)
    for i in range(3):
        ins = [torch.from_numpy(a).requires_grad_(j == i) for j, a in enumerate(arrays)]
        out = ms_deform_attn(ins[0], SHAPES_FLAT, ins[1], ins[2])
        assert out.grad_fn is not None, i
        (grad,) = torch.autograd.grad(out.sum(), ins[i])
        assert torch.isfinite(grad).all() and grad.abs().max() > 0, i


@pytest.mark.parametrize("shapes", [SHAPES_SEP, SHAPES_FLAT], ids=["sep", "flat"])
def test_plain_matches_jax_pallas_interpret(shapes):
    value, loc, attn = _op_inputs(shapes, seed=1)
    if shapes is SHAPES_SEP:
        assert shapes[0][0] * shapes[0][1] > FLAT_LEVEL_MAX_PIXELS
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ms_deform_attn_pallas(
            jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(attn)))
    got = ms_deform_attn_plain(torch.from_numpy(value), shapes, torch.from_numpy(loc),
                               torch.from_numpy(attn))
    assert_close(got, want, rtol=0.05, atol=5e-3)


def test_wrapper_takes_the_plain_version_on_cpu():
    value, loc, attn = (torch.from_numpy(a) for a in _op_inputs(SHAPES_FLAT, d=32))
    with profiling.tracing():
        out = ms_deform_attn(value, SHAPES_FLAT, loc, attn)
    assert profiling.collect()["counters"] == {}  # no kernel launch on the CPU
    torch.testing.assert_close(out, ms_deform_attn_plain(value, SHAPES_FLAT, loc, attn))


# ---- the module at the serving trunk's call shapes ----------------------

D_MODEL, HEADS, POINTS = 64, 2, 4  # D = 32 per head, the kernel's width
LEVELS = SHAPES_SEP


def _module_case(kind: str, seed: int):
    """(query, reference_points, input_flatten, padding_mask) as numpy."""
    rng = np.random.RandomState(seed)
    n = 2
    s = sum(h * w for h, w in LEVELS)
    src = rng.randn(n, s, D_MODEL).astype(np.float32)
    mask = np.zeros((n, s), bool)
    mask[1, -8:] = True  # padded pixels of the second clip
    valid = np.asarray([[[1.0, 1.0]] * 2, [[0.9, 0.75]] * 2], np.float32)  # [N, L, (w, h)]
    if kind == "encoder":  # every pixel is a query, on its own grid point
        refs = []
        for h, w in LEVELS:
            gy, gx = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w,
                                 indexing="ij")
            refs.append(np.stack([gx.ravel(), gy.ravel()], -1))
        ref = np.concatenate(refs)[None, :, None] * valid[:, None]
        query = src
    else:
        q = 8 if kind == "ftf" else 5
        query = rng.randn(n, q, D_MODEL).astype(np.float32)
        dims = 4 if kind == "decoder4" else 2
        ref = rng.rand(n, q, 1, dims).astype(np.float32) * np.concatenate(
            [valid] * (dims // 2), -1)[:, None]
    return query, ref.astype(np.float32), src, mask


def _layer_and_port(kind, seed):
    query, ref, src, mask = (jnp.asarray(a) for a in _module_case(kind, seed=seed))
    layer = MSDeformAttnLayer(D_MODEL, len(LEVELS), HEADS, POINTS, impl="xla")
    variables, flat = random_variables(
        lambda key, *a: layer.init(key, a[0], a[1], a[2], LEVELS, a[3]),
        query, ref, src, mask, seed=seed + 1)
    port = MSDeformAttn(D_MODEL, len(LEVELS), HEADS, POINTS)
    port.load_state_dict(_port_state(flat), strict=True)
    return layer, variables, port, (query, ref, src, mask)


def _port_state(flat):
    """JAX leaves of the layer (or gradients shaped like them) -> the port
    module's state_dict layout."""
    return sub_state_dict(
        state_dict_from_jax(prefixed(flat, "transformer/decoder_layers_0/cross_attn")),
        "transformer.decoder.layers.0.cross_attn")


@pytest.mark.parametrize("kind", ["encoder", "ftf", "decoder2", "decoder4"])
def test_msdeformattn_param_grads_match_jax(kind):
    """d(sum(out * G))/d(parameter) for every parameter of the module.
    Tolerance 1e-5 of each gradient's largest magnitude (plus rtol 1e-5):
    the frameworks sum the same f32 products in other orders."""
    layer, variables, port, (query, ref, src, mask) = _layer_and_port(kind, seed=6)
    n, q = query.shape[:2]
    g = np.random.RandomState(7).randn(n, q, D_MODEL).astype(np.float32)

    def loss(params):
        out, _, _ = layer.apply({"params": params}, query, ref, src, LEVELS, mask)
        return jnp.sum(out * jnp.asarray(g))

    jgrads = jax.jit(jax.grad(loss))(variables["params"])
    want = _port_state({f"params/{k}": np.array(v) for k, v in
                        traverse_util.flatten_dict(jgrads, sep="/").items()})
    out, _, _ = port(*(torch.from_numpy(np.array(a)) for a in (query, ref, src)), LEVELS,
                     torch.from_numpy(np.array(mask)))
    (out * torch.from_numpy(g)).sum().backward()
    got = dict(port.named_parameters())
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        scale = float(w.abs().max())
        assert scale > 0, name
        assert_close(got[name].grad, w, rtol=1e-5, atol=1e-5 * scale, name=f"{kind} {name}")


@pytest.mark.parametrize("kind", ["encoder", "ftf", "decoder2", "decoder4"])
def test_msdeformattn_module_matches_jax(kind):
    layer, variables, port, (query, ref, src, mask) = _layer_and_port(kind, seed=3)
    want = jax.jit(lambda v, *a: layer.apply(v, a[0], a[1], a[2], LEVELS, a[3]))(
        variables, query, ref, src, mask)
    with torch.inference_mode():
        got = port(*(torch.from_numpy(np.array(a)) for a in (query, ref, src)), LEVELS,
                   torch.from_numpy(np.array(mask)))
    for name, g, w in zip(("out", "loc", "attn"), got, want):
        assert_close(g, w, rtol=1e-5, atol=1e-5, name=f"{kind} {name}")


# ---- what surrounds the 2D kernels: launch plan and alignment ----------


def _level_bytes(shapes, first, pix_bytes):
    return sum(h * w for h, w in shapes[first:]) * pix_bytes


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_launch_plan_at_the_flagship_call_shapes(backward, dtype):
    """The encoder's pixel queries (Q = 5100; serving N = 20, training
    N = 5) take the staged path with whole small levels in shared memory
    (bf16: levels 1-3, 1,260 pixels; f32: levels 2-3), 512 threads a block
    forward and 256 backward; the FTF (Q = 8) and decoder (Q = 5) calls
    take the flat path, 16 rows to a block of 256 threads."""
    elt = 4 if dtype == torch.float32 else 2
    threads = THREADS_STAGED[backward]
    for n in (20, 5):
        enc = launch_plan(backward, dtype, FLAGSHIP, n, 5100, 8)
        value_from = 1 if elt == 2 else 2
        assert enc["staged"] == 1 and enc["value_from"] == value_from
        assert enc["threads"] == threads == (256 if backward else 512)
        assert enc["smem"] == _level_bytes(FLAGSHIP, value_from, elt * 32)
        assert enc["run"] % (threads // LANES_PER_ROW) == 0 and enc["run"] < 5100
        assert enc["blocks"] == n * 8 * -(-5100 // enc["run"])
        for q in (8, 5):
            small = launch_plan(backward, dtype, FLAGSHIP, n, q, 8)
            assert small == dict(staged=0, threads=THREADS_FLAT, run=0,
                                 blocks=-(-n * 8 * q // 16), value_from=4, smem=0)
    bf16_fwd = launch_plan(False, torch.bfloat16, FLAGSHIP, 20, 5100, 8)
    assert bf16_fwd["smem"] == 80_640 and bf16_fwd["blocks"] == 640  # levels 1-3: 1,260 pixels


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
def test_launch_plan_stages_whole_levels_within_budget(backward):
    """Over seeded random level shapes and call sizes: the staged levels
    are whole trailing levels, as many as fit (one more would not), no plan
    asks for more shared memory than a block may have, and the blocks cover
    every row."""
    rng = np.random.RandomState(0)
    for _ in range(200):
        shapes = tuple((int(rng.randint(1, 60)), int(rng.randint(1, 90)))
                       for _ in range(rng.randint(1, 9)))
        n_levels = len(shapes)
        dtype = (torch.float32, torch.bfloat16)[rng.randint(2)]
        elt = 4 if dtype == torch.float32 else 2
        n, q = int(rng.randint(1, 40)), int(rng.choice([5, 8, 511, 512, 3000, 5100]))
        plan = launch_plan(backward, dtype, shapes, n, q, 8)
        assert plan["smem"] <= SMEM_BUDGET <= MAX_SMEM // 2
        rows = plan["threads"] // LANES_PER_ROW
        if not plan["staged"]:
            assert plan["smem"] == 0 and plan["threads"] == THREADS_FLAT
            assert (plan["blocks"] - 1) * rows < n * 8 * q <= plan["blocks"] * rows
            continue
        assert q >= 512 and plan["value_from"] < n_levels and plan["run"] % rows == 0
        assert plan["smem"] == _level_bytes(shapes, plan["value_from"], elt * 32)
        if plan["value_from"] > 0:
            assert _level_bytes(shapes, plan["value_from"] - 1, elt * 32) > SMEM_BUDGET
        assert plan["blocks"] * plan["run"] >= n * 8 * q


@pytest.mark.parametrize("coords", [2, 3], ids=["2d", "3d"])
def test_check_rejects_misaligned_pointers(coords):
    """The kernels read value rows in 16 bytes, and the 2D ones locations
    in 8: a view that starts elsewhere is refused, never sent to the plain
    version (a 3D location, read a float at a time, may start on any
    float); a misaligned upstream gradient is copied to an aligned one."""
    shapes = SHAPES_FLAT
    value, loc, attn = (torch.from_numpy(a) for a in _op_inputs(shapes, d=32))
    if coords == 3:
        loc = torch.cat([loc, torch.rand(*loc.shape[:-1], 1)], -1)
    _check(value, shapes, loc, attn, coords)
    off_value = torch.cat([torch.zeros(1), value.reshape(-1)])[1:].view(value.shape)  # 4 B off
    assert off_value.is_contiguous() and off_value.data_ptr() % 16 != 0
    with pytest.raises(ValueError, match="16-byte"):
        _check(off_value, shapes, loc, attn, coords)
    bf16 = value.to(torch.bfloat16)
    off_bf16 = torch.cat([torch.zeros(1, dtype=torch.bfloat16), bf16.reshape(-1)])[1:].view(
        value.shape)
    with pytest.raises(ValueError, match="16-byte"):
        _check(off_bf16, shapes, loc, attn, coords)
    off_loc = torch.cat([torch.zeros(1), loc.reshape(-1)])[1:].view(loc.shape)  # 4 B off
    if coords == 2:
        with pytest.raises(ValueError, match="8-byte"):
            _check(value, shapes, off_loc, attn, coords)
    else:
        _check(value, shapes, off_loc, attn, coords)
    g = torch.randn(value.shape[0], loc.shape[1], 2 * 32)
    off_g = torch.cat([torch.zeros(2), g.reshape(-1)])[2:].view(g.shape)
    fixed = _aligned(off_g, 16)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, g)
    assert _aligned(g, 16) is g


# ---- import rule ---------------------------------------------------------

# cv2, pandas, pycocotools, skimage and h5py too: the port's data pipeline
# and evaluation must run on hosts that do not have them
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tce_rvos_tpu", "cv2", "pandas",
             "pycocotools", "skimage", "h5py")
# the evaluation slice's modules, each scanned and imported
EVAL_MODULES = ("eval/a2d_eval.py", "eval/coco_eval.py", "eval/davis_eval.py",
                "eval/refexp_eval.py", "eval_davis.py", "models/postprocessors.py",
                "utils/rle.py", "data/a2d.py", "data/refexp.py", "data/mevis.py",
                "train_joint.py")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_no_jax_or_jax_package():
    files = sorted((REPO / "tce_rvos_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    assert {"train.py", "native_ckpt.py", "nested.py", "transforms.py", "ytvos.py",
            "registry.py", "loader.py", "categories.py"} <= {f.name for f in files}
    scanned = {f.relative_to(REPO / "tce_rvos_tpu_torch").as_posix() for f in files
               if f.is_relative_to(REPO / "tce_rvos_tpu_torch")}
    assert set(EVAL_MODULES) <= scanned
    bad = [(str(f.relative_to(REPO)), name) for f in files for name in _imported_roots(f)
           if name.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_importing_the_port_loads_no_jax():
    # every module of the package (the command line, the tools and the
    # checkpoint reader included); only modules that importing the port
    # adds count (an interpreter's start-up hooks may load others first)
    package = REPO / "tce_rvos_tpu_torch"
    modules = sorted(".".join(f.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
                     for f in package.rglob("*.py"))
    assert {"tce_rvos_tpu_torch.cli", "tce_rvos_tpu_torch.tools.colormap",
            "tce_rvos_tpu_torch.utils.checkpoint", "tce_rvos_tpu_torch.train",
            "tce_rvos_tpu_torch.utils.native_ckpt", "tce_rvos_tpu_torch.utils.nested",
            "tce_rvos_tpu_torch.data.categories", "tce_rvos_tpu_torch.data.transforms",
            "tce_rvos_tpu_torch.data.ytvos", "tce_rvos_tpu_torch.data.registry",
            "tce_rvos_tpu_torch.data.loader"} <= set(modules)
    assert {"tce_rvos_tpu_torch." + m.removesuffix(".py").replace("/", ".")
            for m in EVAL_MODULES} <= set(modules)
    code = ("import importlib, sys; before = set(sys.modules);"
            f"[importlib.import_module(m) for m in {modules!r}];"
            "bad = sorted(m for m in set(sys.modules) - before if m.split('.')[0] in "
            f"{FORBIDDEN!r});"
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr

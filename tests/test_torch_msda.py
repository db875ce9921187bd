"""The port's MSDA against the JAX package's, on the CPU.

* ``ms_deform_attn_plain`` against the XLA op ``tce_rvos_tpu/ops/msda.py``
  (f32, rtol = atol = 1e-5) and against the Pallas forward
  ``ms_deform_attn_pallas`` in TPU interpret mode (rtol 0.05, atol 5e-3:
  the Pallas kernel rounds its taps to bf16), at shapes with a level above
  1024 pixels (the Pallas separable kernel), locations outside [0, 1] and
  locations exactly on pixel centres;
* the ``MSDeformAttn`` module against ``MSDeformAttnLayer`` at each call
  shape of the serving trunk (encoder pixel queries, FTF Q = 8, decoder
  Q = 5 with 2-d and 4-d reference points), on shared seeded weights;
* the CUDA kernel against the plain version (skips without a card;
  ``chip_smoke.py`` runs that comparison on the GPU);
* the port imports no JAX, Flax or ``tce_rvos_tpu`` module.
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
from jax.experimental.pallas import tpu as pltpu

from tce_rvos_tpu.models.transformer import MSDeformAttnLayer
from tce_rvos_tpu.ops.msda import ms_deform_attn as jax_ms_deform_attn
from tce_rvos_tpu.ops.pallas_msda import FLAT_LEVEL_MAX_PIXELS, ms_deform_attn_pallas
from tce_rvos_tpu_torch.models.transformer import MSDeformAttn
from tce_rvos_tpu_torch.ops.msda import ms_deform_attn_plain
from tce_rvos_tpu_torch.ops.msda_cuda import ms_deform_attn
from tce_rvos_tpu_torch.utils.convert import state_dict_from_jax
from torch_parity_helpers import assert_close, prefixed, random_variables, sub_state_dict

REPO = Path(__file__).resolve().parent.parent
SHAPES_SEP = ((40, 64), (4, 8))       # 2560-pixel level: the Pallas sep kernel
SHAPES_FLAT = ((8, 16), (4, 8), (2, 4))


def _op_inputs(shapes, n=2, q=12, m=2, d=8, p=3, seed=0):
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


@pytest.mark.parametrize("shapes", [SHAPES_SEP, SHAPES_FLAT], ids=["sep", "flat"])
def test_plain_matches_jax_xla(shapes):
    value, loc, attn = _op_inputs(shapes)
    want = jax_ms_deform_attn(jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(attn))
    got = ms_deform_attn_plain(torch.from_numpy(value), shapes, torch.from_numpy(loc),
                               torch.from_numpy(attn))
    assert_close(got, want, rtol=1e-5, atol=1e-5)


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
    before = ms_deform_attn.launches
    out = ms_deform_attn(value, SHAPES_FLAT, loc, attn)
    assert ms_deform_attn.launches == before  # no kernel launch on the CPU
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


@pytest.mark.parametrize("kind", ["encoder", "ftf", "decoder2", "decoder4"])
def test_msdeformattn_module_matches_jax(kind):
    query, ref, src, mask = (jnp.asarray(a) for a in _module_case(kind, seed=3))
    layer = MSDeformAttnLayer(D_MODEL, len(LEVELS), HEADS, POINTS, impl="xla")
    variables, flat = random_variables(
        lambda key, *a: layer.init(key, a[0], a[1], a[2], LEVELS, a[3]),
        query, ref, src, mask, seed=4)
    want = jax.jit(lambda v, *a: layer.apply(v, a[0], a[1], a[2], LEVELS, a[3]))(
        variables, query, ref, src, mask)
    port = MSDeformAttn(D_MODEL, len(LEVELS), HEADS, POINTS)
    sd = sub_state_dict(
        state_dict_from_jax(prefixed(flat, "transformer/decoder_layers_0/cross_attn")),
        "transformer.decoder.layers.0.cross_attn")
    port.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        got = port(*(torch.from_numpy(np.array(a)) for a in (query, ref, src)), LEVELS,
                   torch.from_numpy(np.array(mask)))
    for name, g, w in zip(("out", "loc", "attn"), got, want):
        assert_close(g, w, rtol=1e-5, atol=1e-5, name=f"{kind} {name}")


def test_cuda_kernel_matches_plain():
    """The hand-written kernel against the plain version on the card, f32
    (rtol = atol = 1e-5) and bf16 value (both round one f32 sum to bf16:
    at most one bf16 step apart)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this comparison on the GPU")
    value, loc, attn = (torch.from_numpy(a).cuda()
                        for a in _op_inputs(SHAPES_SEP, n=3, q=64, m=8, d=32, p=4))
    for dtype, rtol, atol in ((torch.float32, 1e-5, 1e-5), (torch.bfloat16, 8e-3, 1e-2)):
        v = value.to(dtype)
        got = ms_deform_attn(v, SHAPES_SEP, loc, attn)
        torch.cuda.synchronize()
        want = ms_deform_attn_plain(v, SHAPES_SEP, loc, attn)
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


# ---- import rule ---------------------------------------------------------

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tce_rvos_tpu")


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
    bad = [(str(f.relative_to(REPO)), name) for f in files for name in _imported_roots(f)
           if name.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_importing_the_port_loads_no_jax():
    # only modules that importing the port adds count (an interpreter's
    # start-up hooks may load others first)
    code = ("import sys; before = set(sys.modules);"
            "import tce_rvos_tpu_torch, tce_rvos_tpu_torch.infer;"
            "bad = sorted(m for m in set(sys.modules) - before if m.split('.')[0] in "
            f"{FORBIDDEN!r});"
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr

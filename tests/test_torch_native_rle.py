"""The port's C host loops (``tce_rvos_tpu_torch/native/rle_ext.c``, built
with the host's C compiler at first use) against the port's numpy path
(``utils/rle.py`` with ``USE_NATIVE = False``, ``eval/davis_eval.py``'s
numpy boundary map) and the JAX package's ``utils/rle.py`` and
``seg2bmap``, bitwise, on random masks and edge cases: empty, full, 1x1,
odd sizes, one row, one column, and runs longer than 2^16."""

import shutil

import numpy as np
import pytest

from tce_rvos_tpu.eval import davis_eval as jax_davis
from tce_rvos_tpu.utils import rle as jax_rle
from tce_rvos_tpu_torch import native
from tce_rvos_tpu_torch.eval import davis_eval
from tce_rvos_tpu_torch.utils import rle

SHAPES = [(1, 1), (1, 9), (9, 1), (3, 7), (17, 5), (31, 33), (240, 320), (300, 400)]
KINDS = ["random", "empty", "full", "blob", "stripes"]


def _mask(kind: str, shape, seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    h, w = shape
    if kind == "random":
        return (rng.rand(h, w) > 0.5).astype(np.uint8)
    if kind == "empty":
        return np.zeros((h, w), np.uint8)
    if kind == "full":
        return np.ones((h, w), np.uint8)
    if kind == "blob":
        m = np.zeros((h, w), np.uint8)
        m[h // 4: h // 4 + max(h // 2, 1), w // 3: w // 3 + max(w // 3, 1)] = 1
        return m
    return (np.arange(h * w).reshape(h, w) // 7 % 2).astype(np.uint8)


@pytest.fixture(autouse=True)
def _native_on(monkeypatch):
    if shutil.which("cc") is None:
        pytest.skip("no C compiler on this host: the port takes its numpy path")
    monkeypatch.setattr(rle, "USE_NATIVE", True)


def _both(fn, *args):
    """``fn(*args)`` through the C library and through numpy."""
    before = native.CALLS["native"]
    got = fn(*args)
    assert native.CALLS["native"] > before, "the C path was not taken"
    rle.USE_NATIVE = False
    try:
        return got, fn(*args)
    finally:
        rle.USE_NATIVE = True


def test_the_library_builds_and_loads():
    assert native.lib() is not None
    assert native.library_path().exists()


@pytest.mark.parametrize("kind", KINDS)
def test_encode_decode_match_numpy_and_jax(kind):
    for shape in SHAPES:
        m = _mask(kind, shape, seed=shape[0])
        got, numpy_path = _both(rle.encode, m)
        assert got == numpy_path == jax_rle.encode(m), (kind, shape)
        dec, numpy_dec = _both(rle.decode, got)
        np.testing.assert_array_equal(dec, m)
        np.testing.assert_array_equal(numpy_dec, m)
        np.testing.assert_array_equal(dec, jax_rle.decode(got))
        counts, numpy_counts = _both(rle.encode_counts, m)
        assert counts == numpy_counts == jax_rle.encode_counts(m)
        assert _both(rle.area, got)[0] == int(m.sum()) == jax_rle.area(got)


def test_string_codec_on_long_runs_and_large_deltas():
    counts = [0, 70000, 3, 1, 123456, 2, 65536, 65535, 7, 1 << 20]
    s, numpy_s = _both(rle._compress_counts, counts)
    assert s == numpy_s == jax_rle._compress_counts(counts)
    back, numpy_back = _both(rle._decompress_counts, s)
    assert back == numpy_back == counts == jax_rle._decompress_counts(s)


def test_a_truncated_string_raises():
    s = rle._compress_counts([5, 70000])
    with pytest.raises(ValueError, match="bad rle string"):
        native.rle_string_to_counts(s[:-1])


def test_decode_cuts_runs_past_the_end():
    got, numpy_path = _both(rle.decode_counts, [2, 10, 5], 3, 3)
    np.testing.assert_array_equal(got, numpy_path)
    assert got.sum() == 7


@pytest.mark.parametrize("kind", KINDS)
def test_boundary_map_matches_numpy_and_jax(kind):
    for shape in SHAPES:
        m = _mask(kind, shape, seed=shape[1])
        got, numpy_path = _both(davis_eval.seg2bmap, m)
        assert got.dtype == numpy_path.dtype == bool
        np.testing.assert_array_equal(got, numpy_path, err_msg=f"{kind} {shape}")
        np.testing.assert_array_equal(got, jax_davis.seg2bmap(m), err_msg=f"{kind} {shape}")


def test_iou_and_j_and_f_through_the_library_match_numpy():
    a, b = _mask("blob", (64, 80)), _mask("random", (64, 80), seed=3)
    ra, rb = rle.encode(a), rle.encode(b)
    assert _both(rle.iou, ra, rb)[0] == _both(rle.iou, ra, rb)[1] == jax_rle.iou(ra, rb)
    f, numpy_f = _both(davis_eval.db_eval_boundary, a, b)
    np.testing.assert_array_equal(f, numpy_f)

"""The port's inference protocols against the JAX package's, on the CPU: the
tiny flagship-shaped model on shared seeded weights (``state_dict_from_jax``),
the same synthetic datasets on disk (``tests/test_torch_infer_main.py``),
engines at size 64 / max_size 96, 48x72 frames upscaled to 64x96.

* ``run_ytvos`` (whole-video with a t_bucket of 5, and windows of 3 with
  ``f_extra = 1``), ``run_davis`` and ``run_mevis`` (windows of 5, two
  expressions a trunk dispatch) write the same PNG paths as the JAX protocols; a pixel may differ
  only where a score that decides it lies within ``SLICE_TOL`` of what it
  is compared with: the threshold, the 0.1 background, or another object's
  score. The JAX scores are read from
  ``tce_rvos_tpu.infer.masks_to_original``, wrapped here.
* ``davis_palette``, ``ytvos_video_list``, ``colormap`` and
  ``save_visualization`` against the JAX functions, bitwise.

Every trunk dispatch is 5 frames x 2 expressions, so that the JAX engine
compiles one backbone and one trunk program.
``tests/test_torch_windows.py`` holds ``run_video`` and ``run_video_batch``
with context frames, whole-video windows and ``t_bucket``.
"""

import numpy as np
import pytest

from tce_rvos_tpu import infer as jax_infer
from tce_rvos_tpu.tools.colormap import colormap as jax_colormap
from tce_rvos_tpu_torch import infer
from tce_rvos_tpu_torch.tools.colormap import colormap
from test_torch_infer_main import (
    FRAME_HW,
    davis_pngs,
    write_davis_tree,
    write_mevis_tree,
    write_ytvos_tree,
    ytvos_pngs,
)
from torch_parity_helpers import torch_threads  # noqa: F401 (autouse fixture)
from torch_parity_helpers import SLICE_TOL, engine_pair

THRESHOLD = 0.5


@pytest.fixture(scope="module")
def engines():
    return engine_pair(size=64, max_size=96, window=3, t_bucket=5)


@pytest.fixture
def window5(engines):
    """Windows of 5 frames: the clips of windows of 3 with a context frame
    a side, so that the JAX engine reuses those programs."""
    for eng in engines:
        eng.window = 5
    yield engines
    for eng in engines:
        eng.window = 3


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    return {"ytvos": write_ytvos_tree(root / "ytvos"), "davis": write_davis_tree(root / "davis"),
            "mevis": write_mevis_tree(root / "mevis")}


def _run_both(monkeypatch, engines, tmp_path, protocol, root, **kw):
    """Run the JAX and the port's ``protocol`` on the tree at ``root``;
    returns the two output directories and the JAX scores in the order the
    protocol asked for them."""
    scores = []
    jax_mto = jax_infer.masks_to_original

    def recording(*a, **k):
        scores.append(jax_mto(*a, **k))
        return scores[-1]

    monkeypatch.setattr(jax_infer, "masks_to_original", recording)
    out = {}
    for name, mod, eng in (("jax", jax_infer, engines[0]), ("port", infer, engines[1])):
        out[name] = str(tmp_path / name)
        getattr(mod, protocol)(eng, root, out[name], **kw)
    return out, scores


def _assert_binary_pngs_agree(out, scores, videos):
    """ytvos/mevis trees: the same files; where a pixel differs, the JAX
    score lies within SLICE_TOL of the threshold. ``videos``: (video, exp
    ids, frame names) in the protocol's order."""
    got, want = ytvos_pngs(out["port"]), ytvos_pngs(out["jax"])
    assert sorted(got) == sorted(want)
    it = iter(scores)
    for video, exp_ids, frames in videos:
        for exp_id in exp_ids:
            s = next(it)
            for i, f in enumerate(frames):
                (gm, g), (wm, w) = got[(video, exp_id, f)], want[(video, exp_id, f)]
                assert gm == wm == "L" and g.shape == w.shape == FRAME_HW
                near = np.abs(s[i] - THRESHOLD) <= SLICE_TOL
                assert not ((g != w) & ~near).any(), (video, exp_id, f)
    assert next(it, None) is None


def _ytvos_order(trees):
    videos, data = jax_infer.ytvos_video_list(str(trees["ytvos"]))
    return [(v, list(data[v]["expressions"]), data[v]["frames"]) for v in videos]


@pytest.mark.parametrize("mode", ["whole_video", "windowed_f_extra1"])
def test_run_ytvos_matches_jax(engines, trees, tmp_path, monkeypatch, mode):
    kw = dict(whole_video=True) if mode == "whole_video" else dict(whole_video=False, f_extra=1)
    out, scores = _run_both(monkeypatch, engines, tmp_path, "run_ytvos", str(trees["ytvos"]),
                            **kw)
    order = _ytvos_order(trees)
    assert [v for v, _, _ in order] == ["goat", "lion"]  # zebra: test split
    _assert_binary_pngs_agree(out, scores, order)


def test_run_mevis_matches_jax(window5, trees, tmp_path, monkeypatch):
    out, scores = _run_both(monkeypatch, window5, tmp_path, "run_mevis", str(trees["mevis"]),
                            exp_batch=2)
    frames = [f"{i:05d}" for i in range(5)]
    _assert_binary_pngs_agree(out, scores, [("birds", ["0", "1", "2", "3"], frames)])


def test_run_davis_matches_jax(window5, trees, tmp_path, monkeypatch):
    out, scores = _run_both(monkeypatch, window5, tmp_path, "run_davis", str(trees["davis"]),
                            exp_batch=2)
    got, want = davis_pngs(out["port"]), davis_pngs(out["jax"])
    assert sorted(got) == sorted(want)
    assert len(want) == 4 * 5
    # run_davis asks per annotator for object 0's scores, then object 1's
    per_anno = [np.stack(scores[2 * a:2 * a + 2]) for a in range(4)]  # [obj, T, H, W]
    assert len(scores) == 8
    for a, s in enumerate(per_anno):
        for i in range(5):
            (gm, g), (wm, w) = got[(f"anno_{a}", "dogs", f"{i:05d}")], \
                want[(f"anno_{a}", "dogs", f"{i:05d}")]
            assert gm == wm == "P" and g.shape == w.shape == FRAME_HW
            si = s[:, i]
            near = (np.abs(si - THRESHOLD) <= SLICE_TOL).any(0)
            near |= (np.abs(si - 0.1) <= SLICE_TOL).any(0)
            near |= np.abs(si[0] - si[1]) <= SLICE_TOL
            assert not ((g != w) & ~near).any(), (a, i)


def test_palette_video_list_and_colormap_match_jax(trees):
    assert infer.davis_palette() == jax_infer.davis_palette()
    assert infer.ytvos_video_list(str(trees["ytvos"])) == \
        jax_infer.ytvos_video_list(str(trees["ytvos"]))
    for rgb in (False, True):
        np.testing.assert_array_equal(colormap(rgb=rgb), jax_colormap(rgb=rgb))


def test_save_visualization_matches_jax(tmp_path):
    rng = np.random.RandomState(6)
    t, (h, w) = 3, FRAME_HW
    args = ([rng.rand(h, w, 3).astype(np.float32) for _ in range(t)], ["a", "b", "c"],
            rng.rand(t, h, w).astype(np.float32), rng.rand(t, 4).astype(np.float32) * 0.5 + 0.2,
            rng.rand(t, 2).astype(np.float32), rng.rand(t, 30, 2).astype(np.float32))
    color = tuple(int(c) for c in colormap(rgb=True)[5])
    jax_infer.save_visualization(*args, str(tmp_path / "jax"), color=color)
    infer.save_visualization(*args, str(tmp_path / "port"), color=color)
    for name in args[1]:
        assert (tmp_path / "port" / f"{name}.png").read_bytes() == \
            (tmp_path / "jax" / f"{name}.png").read_bytes(), name

"""The port's JHMDB-Sentences, RefCOCO and MeViS data against the JAX
package's, on the CPU.

  * ``poly_to_mask`` bitwise against the JAX package's (cv2.fillPoly), on
    seeded convex, concave, self-intersecting and out-of-frame polygons,
    and on RLE segmentations;
  * the pseudo-video augmenter (cv2.getPerspectiveTransform,
    getRotationMatrix2D and warpPerspective in the JAX package): matrices
    within 1e-6, warped frames within 1e-5, warped masks bitwise, at the
    same seed;
  * each dataset's samples after the train and the val transforms, one
    ``random.Random(seed)`` per side: frames within FRAME_TOL (1e-3) after
    Normalize, the rest exact, the generators' states equal afterwards;
    the refexp ground truth for the evaluators;
  * ``collate_batch``'s evaluation keys; ``build_dataset``'s names;
    ``train_joint``'s argv rewriting.
"""

import random

import numpy as np
import pytest

from tce_rvos_tpu import train_joint as jax_train_joint
from tce_rvos_tpu.config import DataConfig as JaxDataConfig
from tce_rvos_tpu.config import ModelConfig as JaxModelConfig
from tce_rvos_tpu.data import a2d as jax_a2d
from tce_rvos_tpu.data import mevis as jax_mevis
from tce_rvos_tpu.data import refexp as jax_refexp
from tce_rvos_tpu.data import registry as jax_registry
from tce_rvos_tpu.data import transforms as jax_tf
from tce_rvos_tpu_torch import train_joint
from tce_rvos_tpu_torch.config import DataConfig, ModelConfig
from tce_rvos_tpu_torch.data import a2d, mevis, refexp, registry
from tce_rvos_tpu_torch.data import transforms as tf
from torch_parity_helpers import torch_threads  # noqa: F401 (autouse fixture)
from torch_parity_helpers import (
    write_jhmdb_tree,
    write_mevis_tree,
    write_refexp_tree,
    write_ytvos_tree,
)

FRAME_TOL = 1e-3  # after Normalize (tests/test_torch_data.py)
EXACT = ("masks", "boxes", "labels", "valid", "size", "orig_size", "frames_idx", "caption",
         "valid_indices", "image_id", "orig_masks")


def assert_sample_equal(got, want, where: str):
    (g_frames, g_target), (w_frames, w_target) = got, want
    assert g_frames.shape == w_frames.shape, where
    np.testing.assert_allclose(g_frames, w_frames, rtol=0, atol=FRAME_TOL, err_msg=where)
    assert sorted(g_target) == sorted(w_target), where
    for k in EXACT:
        if k in w_target:
            np.testing.assert_array_equal(np.asarray(g_target[k]), np.asarray(w_target[k]),
                                          err_msg=f"{where} {k}")


# ---- polygons --------------------------------------------------------------------------


def _polygons(seed: int):
    """(kind, h, w, [polygon...]) cases: convex, concave (star),
    self-intersecting, out-of-frame, on the frame's far edges, and
    multi-polygon segmentations; float vertices rounded by poly_to_mask."""
    rng = np.random.RandomState(seed)
    cases = []
    for k in range(40):
        h, w = rng.randint(8, 90), rng.randint(8, 120)
        n = rng.randint(3, 14)
        ang = np.sort(rng.uniform(0, 2 * np.pi, n))
        centre = rng.uniform(0.2, 0.8, 2) * [w, h]
        if k % 5 == 0:    # convex
            r = np.full(n, 0.4)
        elif k % 5 == 1:  # concave: a star
            r = np.where(np.arange(n) % 2, 0.15, 0.45)
        else:
            r = rng.uniform(0.1, 0.6, n)
        pts = centre + np.stack([np.cos(ang), np.sin(ang)], 1) * r[:, None] * [w, h]
        if k % 5 == 2:    # self-intersecting: vertices in random order
            pts = pts[rng.permutation(n)]
        if k % 5 == 3:    # out of frame on any side
            pts = pts * rng.uniform(1.2, 2.5) - rng.uniform(0.3, 0.8, 2) * [w, h]
        if k % 5 == 4:    # on the far edges: x = W, y = H after rounding
            pts = np.clip(pts * 1.5 - 0.25 * np.array([w, h]), 0, [w, h])
        polys = [pts.ravel().tolist()]
        if k % 7 == 0:
            polys.append((pts[::-1] * 0.5 + 2).ravel().tolist())
        cases.append((k % 5, h, w, polys))
    return cases


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_poly_to_mask_bitwise_cv2(seed):
    kinds = set()
    for kind, h, w, polys in _polygons(seed):
        got = refexp.poly_to_mask(polys, h, w)
        want = jax_refexp.poly_to_mask(polys, h, w)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=f"kind {kind} {h}x{w} {polys}")
        kinds.add(kind)
    assert kinds == {0, 1, 2, 3, 4}


def test_poly_to_mask_degenerate_and_rle():
    for polys in ([[3, 3]], [[3, 3, 9, 9]], [[0, 0, 5, 0, 5, 0]], [[-5, -5, -1, -9, -3, -2]],
                  [[2, 2, 30, 2, 30, 2, 2, 2]]):
        np.testing.assert_array_equal(refexp.poly_to_mask(polys, 12, 16),
                                      jax_refexp.poly_to_mask(polys, 12, 16), err_msg=str(polys))
    m = (np.random.RandomState(0).rand(12, 16) > 0.5).astype(np.uint8)
    from tce_rvos_tpu.utils import rle as jax_rle

    for seg in (jax_rle.encode(m), {"size": [12, 16], "counts": jax_rle.encode_counts(m)}):
        np.testing.assert_array_equal(refexp.poly_to_mask(seg, 12, 16),
                                      jax_refexp.poly_to_mask(seg, 12, 16))


# ---- the augmenter ---------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(48, 64), (61, 93), (480, 640)])
def test_augmenter_matches_cv2(hw):
    h, w = hw
    rng = np.random.RandomState(h)
    img = rng.rand(h, w, 3).astype(np.float32)
    mask = np.zeros((h, w), np.float32)
    mask[h // 4: 3 * h // 4, w // 5: w // 2] = 1
    mask[rng.rand(h, w) > 0.97] = 1
    for seed in range(3):
        port = refexp.ImageToSeqAugmenter(rng=random.Random(seed))
        jax_aug = jax_refexp.ImageToSeqAugmenter(rng=random.Random(seed))
        np.testing.assert_allclose(port._warp_matrix(h, w), jax_aug._warp_matrix(h, w),
                                   rtol=0, atol=1e-6)
        got_img, got_mask = port(img, mask)
        want_img, want_mask = jax_aug(img, mask)
        assert got_img.dtype == want_img.dtype == np.float32
        np.testing.assert_allclose(got_img, want_img, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got_mask, want_mask)
        assert port.rng.getstate() == jax_aug.rng.getstate()


# ---- datasets --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_data")
    return {"jhmdb": write_jhmdb_tree(str(root / "jhmdb")),
            "coco": write_refexp_tree(str(root / "coco"), names=("refcoco", "refcoco+",
                                                                 "refcocog")),
            "mevis": write_mevis_tree(str(root / "mevis")),
            "ytvos": write_ytvos_tree(str(root / "ytvos"), n_frames=4)}


def _transform(mod, split, rng):
    return mod.make_train_transform(96, rng=rng) if split == "train" else mod.make_val_transform()


def _refexp_pair(trees, split, seed, num_frames=3, f_extra=0):
    r_port, r_jax = random.Random(seed), random.Random(seed)
    kw = dict(num_frames=num_frames, f_extra=f_extra)
    root, ann = trees["coco"] + "/train2014", f"{trees['coco']}/instances_refcoco_{split}.json"
    return (refexp.RefExpDataset(root, ann, _transform(tf, split, r_port), rng=r_port, **kw),
            jax_refexp.RefExpDataset(root, ann, _transform(jax_tf, split, r_jax), rng=r_jax,
                                     **kw), r_port, r_jax)


@pytest.mark.parametrize("split,kw", [("train", {}), ("val", {}), ("train", {"f_extra": 1}),
                                      ("val", {"num_frames": 1})],
                         ids=["train", "val", "train_f_extra", "val_one_frame"])
def test_refexp_samples_match_jax(trees, split, kw):
    for seed in (0, 1):
        port, jax_ds, r_port, r_jax = _refexp_pair(trees, split, seed, **kw)
        assert len(port) == len(jax_ds) == 3
        for idx in range(len(port)):
            assert_sample_equal(port[idx], jax_ds[idx], f"{split} {kw} seed {seed} idx {idx}")
        assert r_port.getstate() == r_jax.getstate()


def test_refexp_ground_truth_matches_jax(trees):
    port, jax_ds, _, _ = _refexp_pair(trees, "val", 0)
    got, want = port.gt_boxes_by_image(), jax_ds.gt_boxes_by_image()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert port.coco_gt_by_image() == jax_ds.coco_gt_by_image()


def test_jhmdb_samples_match_jax(trees):
    root = trees["jhmdb"]
    ann = f"{root}/jhmdb_sentences_samples_metadata.json"
    for nf in (5, 1):
        port = a2d.JHMDBSentencesDataset(root, ann, tf.make_val_transform(), num_frames=nf)
        jax_ds = jax_a2d.JHMDBSentencesDataset(root, ann, jax_tf.make_val_transform(),
                                               num_frames=nf)
        assert len(port) == len(jax_ds) == 4
        for idx in range(len(port)):
            got, want = port[idx], jax_ds[idx]
            assert_sample_equal(got, want, f"num_frames {nf} idx {idx}")
            assert got[1]["orig_masks"].shape == (1, 48, 64)
        if nf == 5:  # frame 2's window, edge-padded at the 1-based start
            assert port[0][1]["frames_idx"].tolist() == [1, 1, 2, 3, 4]


def test_a2d_windows_match_jax():
    for seed in range(4):
        r1, r2 = random.Random(seed), random.Random(seed)
        for frame_id, vid_len, nf in ((0, 10, 5), (9, 10, 5), (4, 6, 8), (2, 3, 3), (1, 2, 6)):
            assert (a2d._train_window(frame_id, vid_len, nf, r1)
                    == jax_a2d._train_window(frame_id, vid_len, nf, r2))
            assert a2d._val_window(frame_id, vid_len, nf) == jax_a2d._val_window(
                frame_id, vid_len, nf)
        assert r1.getstate() == r2.getstate()


@pytest.mark.parametrize("split", ["train", "val"])
def test_mevis_samples_match_jax(trees, split):
    root = trees["mevis"] + "/train"
    for seed in (0, 1):
        r_port, r_jax = random.Random(seed), random.Random(seed)
        port = mevis.MeViSDataset(root, root + "/meta_expressions.json",
                                  _transform(tf, split, r_port), num_frames=3, rng=r_port)
        jax_ds = jax_mevis.MeViSDataset(root, root + "/meta_expressions.json",
                                        _transform(jax_tf, split, r_jax), num_frames=3,
                                        rng=r_jax)
        assert port.metas == jax_ds.metas and len(port) == 2 * 3 * 2
        for idx in range(len(port)):
            assert_sample_equal(port[idx], jax_ds[idx], f"{split} seed {seed} idx {idx}")
        assert r_port.getstate() == r_jax.getstate()


def test_collate_eval_keys_match_jax(trees):
    root = trees["jhmdb"]
    ann = f"{root}/jhmdb_sentences_samples_metadata.json"
    port = a2d.JHMDBSentencesDataset(root, ann, tf.make_val_transform(), num_frames=3)
    jax_ds = jax_a2d.JHMDBSentencesDataset(root, ann, jax_tf.make_val_transform(), num_frames=3)
    got = registry.collate_batch([port[i] for i in (0, 3)])
    want = jax_registry.collate_batch([jax_ds[i] for i in (0, 3)])
    assert sorted(got) == sorted(want)
    for k in ("valid_indices", "orig_sizes", "sizes", "text_ids", "text_attn_mask"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["image_ids"] == want["image_ids"] == ["v_v0_f_2", "v_v1_f_6"]
    for g, w in zip(got["orig_masks"], want["orig_masks"]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got["video"], want["video"], rtol=0, atol=FRAME_TOL)
    # refexp: image ids, no valid_indices; a joint batch mixing refexp and
    # ytvos samples keeps only the keys every sample has
    ref, _, _, _ = _refexp_pair(trees, "val", 0)
    batch = registry.collate_batch([ref[0], ref[1]])
    assert "valid_indices" not in batch and batch["image_ids"] == [ref.ids[0], ref.ids[1]]
    ytvos = registry.build_dataset("ytvos", "train", DataConfig(ytvos_path=trees["ytvos"],
                                                                max_size=96),
                                   ModelConfig(num_frames=3))
    mixed = registry.collate_batch([ref[0], ytvos[0]])
    assert "image_ids" not in mixed and mixed["orig_sizes"].shape == (2, 2)


def test_build_dataset_names(trees):
    mcfg, jmcfg = ModelConfig(num_frames=3), JaxModelConfig(num_frames=3)
    dcfg = DataConfig(coco_path=trees["coco"], jhmdb_path=trees["jhmdb"],
                      mevis_path=trees["mevis"], ytvos_path=trees["ytvos"], max_size=96)
    jdcfg = JaxDataConfig(coco_path=trees["coco"], jhmdb_path=trees["jhmdb"],
                          mevis_path=trees["mevis"], ytvos_path=trees["ytvos"], max_size=96)
    for name, split in (("jhmdb", "val"), ("mevis", "train"), ("refcoco", "train"),
                        ("refcoco+", "val"), ("refcocog", "train"), ("joint", "train")):
        got = registry.build_dataset(name, split, dcfg, mcfg)
        want = jax_registry.build_dataset(name, split, jdcfg, jmcfg)
        assert type(got).__name__ == type(want).__name__ and len(got) == len(want) > 0, name
    joint = registry.build_dataset("joint", "train", dcfg, mcfg)
    assert [type(d).__name__ for d in joint.datasets] == ["RefExpDataset"] * 3 + ["YTVOSDataset"]
    coco_only = registry.build_dataset("joint", "train",
                                       DataConfig(coco_path=trees["coco"], pretrain_coco=True),
                                       mcfg)
    assert len(coco_only.datasets) == 3 and len(coco_only) == 9
    # no A2D-Sentences tree here: both packages look for its annotations
    for build, cfgs in ((registry.build_dataset, (dcfg, mcfg)),
                        (jax_registry.build_dataset, (jdcfg, jmcfg))):
        with pytest.raises(FileNotFoundError, match="a2d_sentences_single_frame_test"):
            build("a2d", "val", *cfgs)


@pytest.mark.parametrize("argv", [
    [], ["--dataset_file", "ytvos", "--lr", "1e-5"], ["--binary", "--dataset_file", "a2d"],
    ["--dataset_file", "x", "--epochs", "2", "--dataset_file", "y"]])
def test_train_joint_argv_like_jax(monkeypatch, argv):
    import tce_rvos_tpu.train
    import tce_rvos_tpu_torch.train

    seen = {}
    monkeypatch.setattr(tce_rvos_tpu.train, "main", lambda a: seen.setdefault("jax", a))
    monkeypatch.setattr(tce_rvos_tpu_torch.train, "main", lambda a: seen.setdefault("port", a))
    jax_train_joint.main(list(argv))
    train_joint.main(list(argv))
    got = seen["port"]
    assert got == seen["jax"] == train_joint.joint_argv(argv)
    assert got.count("--dataset_file") == 1 and got[got.index("--dataset_file") + 1] == "joint"
    assert got.count("--binary") == 1

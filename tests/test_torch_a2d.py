"""The A2D-Sentences reader of the port (``data/a2d.py``) against the JAX
package's on a tiny tree written here with cv2 (.mp4 clips) and h5py (.h5
instance masks), and ``train.main --dataset_file a2d``: one epoch with
the per-epoch evaluation of the val split.

Each side gets its own ``random.Random(seed)`` for the dataset's windows
and its own for the train transform's draws. Frames agree within 1e-3
after Normalize (the port's bilinear resize is within 2e-7 of cv2's, as
tests/test_torch_data.py holds), the targets exactly.
"""

import dataclasses
import json
import math
import os
import random
import sys

import numpy as np
import pytest

from tce_rvos_tpu.data import a2d as jax_a2d
from tce_rvos_tpu.data import transforms as jax_tf
from tce_rvos_tpu_torch import cli, train
from tce_rvos_tpu_torch.data import a2d
from tce_rvos_tpu_torch.data import transforms as tf
from torch_parity_helpers import torch_threads  # noqa: F401 (autouse fixture)

FRAME_TOL = 1e-3
VIDEOS = {"vA": (12, (0, 5)), "vB": (9, (2,))}  # frames, annotated frames (0-based)
TINY_TEXT = dict(text_encoder_layers=1, text_encoder_hidden=32, text_encoder_heads=2,
                 text_encoder_intermediate=64)
TINY_FLAGS = ["--binary", "--with_box_refine", "--f_token", "2", "--qtrans", "--num_frames", "3",
              "--enc_layers", "1", "--dec_layers", "1", "--dim_feedforward", "32",
              "--hidden_dim", "64", "--nheads", "2", "--mask_dim", "8", "--num_workers", "1",
              "--device", "cpu"]


def write_a2d_tree(root, hw=(48, 64), seed: int = 0):
    """Release/clips320H/<video>.mp4, text_annotations/
    a2d_annotation_with_instances/<video>/<frame:05d>.h5 (two instances
    where a frame has them: 'instance' ids and 'reMask' [n, W, H]; one
    instance: [W, H]) and the single-frame train and test annotation
    lists. Instance 2 of vA's frame 6 is empty (a clip that the train split
    resamples). Returns ``root``."""
    import cv2
    import h5py

    rng = np.random.RandomState(seed)
    h, w = hw
    clips = os.path.join(root, "Release", "clips320H")
    os.makedirs(clips)
    anns = []
    for vid, (n, annotated) in VIDEOS.items():
        writer = cv2.VideoWriter(os.path.join(clips, f"{vid}.mp4"),
                                 cv2.VideoWriter_fourcc(*"mp4v"), 10, (w, h))
        yy, xx = np.mgrid[0:h, 0:w]
        for i in range(n):
            img = np.stack([(xx * 4 + 9 * i) % 256, (yy * 5 + 3 * i) % 256,
                            np.full((h, w), 40 * (i % 6))], -1).astype(np.uint8)
            writer.write(img)
        writer.release()
        mdir = os.path.join(root, "text_annotations", "a2d_annotation_with_instances", vid)
        os.makedirs(mdir)
        for f in annotated:
            frame_idx = f + 1  # a2d frames are 1-based
            m1 = np.zeros((h, w), np.uint8)
            m1[8 + f: 30 + f, 10 + 2 * f: 40 + 2 * f] = 1
            ids = [1]
            masks = [m1]
            if vid == "vA":
                m2 = np.zeros((h, w), np.uint8)
                if f == 0:
                    m2[30:44, 40:60] = 1
                ids.append(2)
                masks.append(m2)
            with h5py.File(os.path.join(mdir, f"{frame_idx:05d}.h5"), "w") as fh:
                fh["instance"] = np.asarray(ids, np.float64)
                re = np.stack([m.T for m in masks]) if len(masks) > 1 else masks[0].T
                fh["reMask"] = re.astype(np.float64)
            for inst in ids:
                anns.append([f"the Thing  {inst} in {vid}", vid, frame_idx, inst])
    rng.shuffle(anns)
    for split in ("train", "test"):
        with open(os.path.join(root, f"a2d_sentences_single_frame_{split}_annotations.json"),
                  "w") as fh:
            json.dump(anns, fh)
    return root


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_a2d_tree(str(tmp_path_factory.mktemp("a2d")))


def _pairs(tree, split: str, seed: int):
    ann = os.path.join(tree, f"a2d_sentences_single_frame_{'train' if split == 'train' else 'test'}"
                             "_annotations.json")
    if split == "train":
        tfs = (tf.make_train_transform(96, rng=random.Random(seed)),
               jax_tf.make_train_transform(96, rng=random.Random(seed)))
    else:
        tfs = (tf.make_val_transform(), jax_tf.make_val_transform())
    port = a2d.A2DSentencesDataset(tree, ann, tfs[0], num_frames=3, subset=split,
                                   rng=random.Random(seed + 100))
    want = jax_a2d.A2DSentencesDataset(tree, ann, tfs[1], num_frames=3, subset=split,
                                       rng=random.Random(seed + 100))
    return port, want


@pytest.mark.parametrize("split,seed", [("train", 0), ("train", 1), ("val", 0)])
def test_samples_match_jax(tree, split, seed):
    port, want = _pairs(tree, split, seed)
    assert len(port) == len(want) == 5
    for i in range(len(port)):
        (g_frames, g_t), (w_frames, w_t) = port[i], want[i]
        np.testing.assert_allclose(g_frames, w_frames, rtol=0, atol=FRAME_TOL,
                                   err_msg=f"{split} {i}")
        assert sorted(g_t) == sorted(w_t), i
        for k, v in w_t.items():
            if k == "caption" or k == "image_id":
                assert g_t[k] == v, k
            else:
                np.testing.assert_array_equal(np.asarray(g_t[k]), np.asarray(v),
                                              err_msg=f"{split} {i} {k}")
        assert port.rng.getstate() == want.rng.getstate()


def test_read_video_matches_jax(tree):
    path = os.path.join(tree, "Release", "clips320H", "vA.mp4")
    got, want = a2d.read_video_cv2(path), jax_a2d.read_video_cv2(path)
    assert got.shape == (12, 48, 64, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("module,package", [("cv2", "opencv-python"), ("h5py", "h5py")])
def test_a_missing_package_is_named(tree, monkeypatch, module, package):
    port, _ = _pairs(tree, "val", 0)
    monkeypatch.setitem(sys.modules, module, None)  # import raises ImportError
    with pytest.raises(ImportError, match=f"install {package}"):
        port[0]


def test_main_trains_an_epoch_and_evaluates(tree, tmp_path, monkeypatch):
    """Without ``--masks``, as the JAX command line defaults: with it both
    packages' matchers fail on A2D batches, whose one-frame target masks
    the collate pads to the clip's frames (ROADMAP C9)."""
    orig = cli.model_config_from_args
    monkeypatch.setattr(cli, "model_config_from_args",
                        lambda args: dataclasses.replace(orig(args), **TINY_TEXT))
    state = train.main(["--dataset_file", "a2d", "--a2d_path", tree, "--output_dir",
                        str(tmp_path), "--epochs", "1", "--batch_size", "2", "--max_size", "96",
                        *TINY_FLAGS])
    assert state.step == 5 // 2
    with open(tmp_path / "log.txt") as fh:
        log = json.loads(fh.readline())
    assert math.isfinite(log["train_loss"]) and log["epoch"] == 0
    for k in ("mAP 0.5:0.95", "AP 0.5", "P@0.5", "overall_iou", "mean_iou"):
        assert 0.0 <= log[k] <= 1.0, k
    assert os.path.exists(tmp_path / "checkpoint" / "model.pt")

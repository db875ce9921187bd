"""The port's evaluation path end to end on the CPU.

  * the ``valid_indices`` forward (JHMDB: the transformer sees only each
    clip's annotated frame) against the JAX model on the tiny flagship's
    shared weights, at the model-level tolerance of test_torch_slice.py;
  * ``evaluate_a2d``, ``evaluate_coco_pretrain`` and ``evaluate_yvos``
    against the JAX package's on tiny synthetic JHMDB, RefCOCO and
    Ref-YouTube-VOS trees, given predictions
    that match (outputs made from each batch's ground truth on the port's
    side, replayed batch by batch to the JAX evaluator): the same metric
    dict within 1e-6;
  * the command line, port only, with few layers, narrow widths and a tiny
    text encoder: ``train.main(["--eval", ...])`` for jhmdb and refcoco
    (the metric dict; with the forward replaced by each batch's ground
    truth, the P@K of a perfect prediction),
    the ``ValueError`` of ytvos/davis/mevis/a2d, a few training steps on
    MeViS and one ``train_joint`` epoch on RefCOCO/+/g plus Ref-YouTube-VOS.
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tce_rvos_tpu import engine as jax_engine
from tce_rvos_tpu.data import refexp as jax_refexp
from tce_rvos_tpu.data.loader import PrefetchLoader as JaxPrefetchLoader
from tce_rvos_tpu.data.loader import ShardedSampler as JaxShardedSampler
from tce_rvos_tpu.data.registry import collate_batch as jax_collate_batch
from tce_rvos_tpu_torch import cli, engine, train, train_joint
from tce_rvos_tpu_torch.config import DataConfig, ModelConfig
from tce_rvos_tpu_torch.data import registry
from tce_rvos_tpu_torch.data.loader import PrefetchLoader, ShardedSampler
from tce_rvos_tpu_torch.models.referformer import ReferFormer
from tce_rvos_tpu_torch.utils.convert import state_dict_from_jax
from torch_parity_helpers import torch_threads  # noqa: F401 (autouse fixture)
from torch_parity_helpers import (
    FLAGSHIP_TINY,
    SLICE_TOL,
    assert_close,
    tiny_model,
    write_jhmdb_tree,
    write_mevis_tree,
    write_refexp_tree,
    write_ytvos_tree,
)

METRIC_TOL = 1e-6
A2D_KEYS = ["AP 0.5", "AP 0.75", "P@0.5", "P@0.6", "P@0.7", "P@0.8", "P@0.9", "mAP 0.5:0.95",
            "mean_iou", "overall_iou"]
TINY_TEXT = dict(text_encoder_layers=1, text_encoder_hidden=32, text_encoder_heads=2,
                 text_encoder_intermediate=64)
TINY_FLAGS = ["--binary", "--with_box_refine", "--f_token", "2", "--qtrans", "--num_frames", "3",
              "--enc_layers", "1", "--dec_layers", "1", "--dim_feedforward", "32",
              "--hidden_dim", "64", "--nheads", "2", "--mask_dim", "8", "--num_workers", "1",
              "--device", "cpu"]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_e2e")
    return {"jhmdb": write_jhmdb_tree(str(root / "jhmdb")),
            "coco": write_refexp_tree(str(root / "coco"),
                                      names=("refcoco", "refcoco+", "refcocog")),
            "mevis": write_mevis_tree(str(root / "mevis")),
            "ytvos": write_ytvos_tree(str(root / "ytvos"), n_frames=4)}


@pytest.fixture()
def tiny_text(monkeypatch):
    orig = cli.model_config_from_args
    monkeypatch.setattr(cli, "model_config_from_args",
                        lambda args: dataclasses.replace(orig(args), **TINY_TEXT))


# ---- the valid_indices forward -------------------------------------------------------


def test_valid_indices_forward_matches_jax():
    _, model, variables, flat, inputs = tiny_model("flagship")
    valid = np.array([2, 0], np.int32)  # the annotated frame of each of the 2 clips
    want = jax.jit(model.apply)(variables, **{k: jnp.asarray(v) for k, v in inputs.items()},
                                valid_indices=jnp.asarray(valid))
    port = ReferFormer(ModelConfig(**FLAGSHIP_TINY))
    port.load_state_dict(state_dict_from_jax(flat), strict=True)
    port.eval()
    fwd = engine.model_forward(port)
    got = fwd(dict(inputs, valid_indices=valid), valid_indices=True)
    b = inputs["video"].shape[0]
    assert got["pred_masks"].shape[:3] == (b, 1, 5)
    for k in ("pred_logits", "pred_boxes", "pred_masks", "reference_points"):
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert_close(got[k], np.asarray(want[k]), rtol=SLICE_TOL, atol=SLICE_TOL, name=k)
    # one annotated frame through the transformer is not the clip's frame of
    # a full forward: the time axis is 1 from the fusion on
    full = fwd(inputs)
    assert full["pred_masks"].shape[1] == inputs["video"].shape[1]


# ---- the evaluators against the JAX package's -------------------------------------------


def _fake_outputs(batch, t: int, q: int = 5, seed: int = 0):
    """Outputs whose query 0 is the batch's ground truth (mask logits +-4
    at stride 4, its box), query 1 the ground truth shifted, the rest
    seeded noise: predictions that score between 0 and 1."""
    rng = np.random.RandomState(seed)
    gt = batch["targets"]["masks"][:, :t, 2::4, 2::4]          # [b, t, h, w]
    b, _, h, w = gt.shape
    masks = rng.randn(b, t, q, h, w).astype(np.float32) * 4
    masks[:, :, 0] = 8 * (gt - 0.5)
    masks[:, :, 1] = np.roll(8 * (gt - 0.5), 3, axis=-1)
    boxes = (rng.rand(b, t, q, 4) * 0.4 + 0.2).astype(np.float32)
    boxes[:, :, 0] = batch["targets"]["boxes"][:, :t]
    logits = rng.randn(b, t, q, 1).astype(np.float32)
    return {"pred_logits": logits, "pred_boxes": boxes, "pred_masks": masks}


def _loaders(dataset_port, dataset_jax, batch_size=2):
    return (PrefetchLoader(dataset_port, ShardedSampler(len(dataset_port), shuffle=False),
                           batch_size, registry.collate_batch, num_workers=1, drop_last=False),
            JaxPrefetchLoader(dataset_jax, JaxShardedSampler(len(dataset_jax), shuffle=False),
                              batch_size, jax_collate_batch, num_workers=1, drop_last=False))


def _recording_and_replay(t):
    seen = []

    def port_fwd(batch, valid_indices=False):
        out = _fake_outputs(batch, t, seed=len(seen))
        seen.append(out)
        return {k: torch.from_numpy(v) for k, v in out.items()}

    def jax_fwd(variables, **kw):
        return {k: jnp.asarray(v) for k, v in seen.pop(0).items()}

    return port_fwd, jax_fwd


def _assert_metrics_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=METRIC_TOL, err_msg=k)


def test_evaluate_a2d_matches_jax(trees):
    from tce_rvos_tpu.config import DataConfig as JaxDataConfig
    from tce_rvos_tpu.config import ModelConfig as JaxModelConfig
    from tce_rvos_tpu.data.registry import build_dataset as jax_build_dataset

    port_ds = registry.build_dataset("jhmdb", "val", DataConfig(jhmdb_path=trees["jhmdb"]),
                                     ModelConfig(num_frames=3))
    jax_ds = jax_build_dataset("jhmdb", "val", JaxDataConfig(jhmdb_path=trees["jhmdb"]),
                               JaxModelConfig(num_frames=3))
    port_loader, jax_loader = _loaders(port_ds, jax_ds)
    port_fwd, jax_fwd = _recording_and_replay(t=1)
    got = engine.evaluate_a2d(port_fwd, port_loader)
    want = jax_engine.evaluate_a2d(jax_fwd, None, iter(jax_loader))
    assert sorted(got) == A2D_KEYS
    _assert_metrics_equal(got, want)
    assert 0 < got["mAP 0.5:0.95"] < 1 and 0 < got["mean_iou"] < 1


def test_evaluate_coco_pretrain_matches_jax(trees):
    from tce_rvos_tpu.data.transforms import make_val_transform as jax_val

    from tce_rvos_tpu_torch.data.refexp import RefExpDataset
    from tce_rvos_tpu_torch.data.transforms import make_val_transform

    root, ann = trees["coco"] + "/train2014", trees["coco"] + "/instances_refcoco_val.json"
    port_ds = RefExpDataset(root, ann, make_val_transform(), num_frames=2)
    jax_ds = jax_refexp.RefExpDataset(root, ann, jax_val(), num_frames=2)
    port_loader, jax_loader = _loaders(port_ds, jax_ds)
    port_fwd, jax_fwd = _recording_and_replay(t=2)
    got = engine.evaluate_coco_pretrain(port_fwd, port_loader, port_ds.gt_boxes_by_image(),
                                        port_ds.coco_gt_by_image(), masks=True)
    want = jax_engine.evaluate_coco_pretrain(jax_fwd, None, iter(jax_loader),
                                             jax_ds.gt_boxes_by_image(),
                                             jax_ds.coco_gt_by_image(), masks=True)
    assert sorted(got) == ["P@1", "P@10", "P@5", "coco_eval_bbox", "coco_eval_masks"]
    _assert_metrics_equal(got, want)
    assert len(got["coco_eval_bbox"]) == len(got["coco_eval_masks"]) == 12


def test_evaluate_yvos_matches_jax(trees):
    import os
    import random

    from tce_rvos_tpu.data.transforms import make_val_transform as jax_val
    from tce_rvos_tpu.data.ytvos import YTVOSDataset as JaxYTVOSDataset

    from tce_rvos_tpu_torch.data.transforms import make_val_transform
    from tce_rvos_tpu_torch.data.ytvos import YTVOSDataset

    root = trees["ytvos"]
    args = (os.path.join(root, "train"),
            os.path.join(root, "meta_expressions", "train", "meta_expressions.json"))
    port_ds = YTVOSDataset(*args, make_val_transform(), num_frames=3, rng=random.Random(0))
    jax_ds = JaxYTVOSDataset(*args, jax_val(), num_frames=3, rng=random.Random(0))
    port_loader, jax_loader = _loaders(port_ds, jax_ds)
    port_fwd, jax_fwd = _recording_and_replay(t=3)
    got = engine.evaluate_yvos(port_fwd, port_loader, max_batches=2)
    want = jax_engine.evaluate_yvos(jax_fwd, None, iter(jax_loader), max_batches=2)
    _assert_metrics_equal(got, want)
    assert sorted(got) == ["dice_loss", "focal_loss"]


# ---- the command line, port only ------------------------------------------------------


def _self_scoring(monkeypatch):
    """The model's forward replaced by each batch's ground truth at stride 4
    (query 0, the top score) and noise."""

    def forward(model, compute_dtype="float32"):
        def fwd(batch, valid_indices=False):
            gt = _fake_outputs(batch, 1 if valid_indices else batch["video"].shape[1])
            gt["pred_logits"][:, :, 0] = 10.0
            return {k: torch.from_numpy(v) for k, v in gt.items()}

        return fwd

    monkeypatch.setattr(engine, "model_forward", forward)


def test_main_eval_jhmdb(trees, tmp_path, tiny_text, monkeypatch):
    argv = ["--eval", "--dataset_file", "jhmdb", "--jhmdb_path", trees["jhmdb"],
            "--batch_size", "2", "--output_dir", str(tmp_path), *TINY_FLAGS]
    stats = train.main(argv)
    assert sorted(stats) == A2D_KEYS
    assert all(0.0 <= v <= 1.0 and math.isfinite(v) for v in stats.values())
    with open(tmp_path / "log.txt") as fh:
        assert json.loads(fh.readline()) == pytest.approx(stats)
    _self_scoring(monkeypatch)
    own = train.main(argv)
    # the stride-4 ground truth comes back through the 4x upsample and the
    # resize to the original size within a few boundary pixels: every IoU
    # above 0.8 (the metrics of the exact ground truth: test_torch_eval.py)
    assert own["P@0.8"] == own["AP 0.5"] == 1.0 and own["mean_iou"] > 0.9


def test_main_eval_refcoco(trees, tmp_path, tiny_text, monkeypatch):
    argv = ["--eval", "--dataset_file", "refcoco", "--coco_path", trees["coco"], "--masks",
            "--batch_size", "2", "--output_dir", str(tmp_path), *TINY_FLAGS]
    stats = train.main(argv)
    assert sorted(stats) == ["P@1", "P@10", "P@5", "coco_eval_bbox", "coco_eval_masks"]
    for k in ("P@1", "P@5", "P@10"):
        assert 0.0 <= stats[k] <= 1.0
    for v in stats["coco_eval_bbox"] + stats["coco_eval_masks"]:
        assert v == -1.0 or 0.0 <= v <= 1.0
    _self_scoring(monkeypatch)
    own = train.main(argv + ["--dataset_file", "refcoco+"])
    assert own["P@1"] == 1.0


@pytest.mark.parametrize("name", ["ytvos", "davis", "mevis", "a2d"])
def test_main_eval_refuses(name, tiny_text):
    if name == "a2d":  # evaluated, but no A2D-Sentences tree is at the default path
        error, match = FileNotFoundError, "a2d_sentences_single_frame_test_annotations"
    else:
        error, match = ValueError, r"no metric protocol.*tce_rvos_tpu_torch.infer"
    with pytest.raises(error, match=match):
        train.main(["--eval", "--dataset_file", name, *TINY_FLAGS])


def test_main_trains_on_mevis(trees, tmp_path, tiny_text):
    state = train.main(["--dataset_file", "mevis", "--mevis_path", trees["mevis"],
                        "--output_dir", str(tmp_path), "--epochs", "1", "--batch_size", "4",
                        "--max_size", "96", "--masks", *TINY_FLAGS])
    assert state.step == (2 * 3 * 2) // 4  # 2 videos x 3 expressions x 2 anchors
    with open(tmp_path / "log.txt") as fh:
        assert math.isfinite(json.loads(fh.readline())["train_loss"])


def test_train_joint_one_epoch(trees, tmp_path, tiny_text):
    state = train_joint.main(["--coco_path", trees["coco"], "--ytvos_path", trees["ytvos"],
                              "--dataset_file", "ytvos", "--output_dir", str(tmp_path),
                              "--epochs", "1", "--batch_size", "2", "--max_size", "96",
                              "--masks", *TINY_FLAGS])
    # 3 refexp sets x 3 images + 2 ytvos videos x 2 anchors (4 frames, windows of 3)
    assert state.step == (3 * 3 + 2 * 2) // 2
    with open(tmp_path / "log.txt") as fh:
        assert math.isfinite(json.loads(fh.readline())["train_loss"])

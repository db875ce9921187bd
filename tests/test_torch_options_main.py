"""The model options through the port's command lines on the CPU, with tiny
flags and a tiny text encoder (as ``tests/test_torch_train_main.py``):

* ``train.main`` on a synthetic Ref-YouTube-VOS train tree without
  ``--binary`` (65 class logits), with ``--f_token -1 --vis_loss
  --contrastive --vlblock --no_rel_coord`` and without ``--masks``: the
  logged losses hold ``loss_vis`` and its aux copies and no mask loss;
  then ``infer.main`` with the same flags and ``--resume`` on the saved
  weights writes every PNG; with ``--masks`` the mask losses are logged;
* ``train.main --eval`` on JHMDB-Sentences without ``--binary`` is one
  class, and scores exactly as with it.

The model options are held against the JAX package in
``tests/test_torch_options.py``, ``test_torch_slice_options.py`` and
``test_torch_train_options.py``.
"""

import dataclasses
import json

import numpy as np
import pytest

from tce_rvos_tpu_torch import cli, infer, train
from tce_rvos_tpu_torch.models import text_encoder
from test_torch_infer_main import CLI_HW, YTVOS_VIDEOS, ytvos_pngs
from test_torch_infer_main import write_ytvos_tree as write_valid_tree
from torch_parity_helpers import torch_threads  # noqa: F401 (autouse fixture)
from torch_parity_helpers import write_jhmdb_tree, write_ytvos_tree

TINY_TEXT = dict(text_encoder_layers=1, text_encoder_hidden=32, text_encoder_heads=2,
                 text_encoder_intermediate=64)
SMALL = ["--num_frames", "2", "--enc_layers", "1", "--dec_layers", "2", "--dim_feedforward",
         "32", "--hidden_dim", "64", "--nheads", "2", "--mask_dim", "8", "--device", "cpu"]
OPTIONS = ["--f_token", "-1", "--vis_loss", "--contrastive", "--vlblock", "--no_rel_coord",
           "--with_box_refine", "--qtrans"]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("options_main")
    return {"train": write_ytvos_tree(str(root / "train"), n_frames=4),
            "valid": write_valid_tree(root / "valid", hw=CLI_HW),
            "jhmdb": write_jhmdb_tree(str(root / "jhmdb"))}


@pytest.fixture()
def tiny_text(monkeypatch):
    orig = cli.model_config_from_args
    monkeypatch.setattr(cli, "model_config_from_args",
                        lambda args: dataclasses.replace(orig(args), **TINY_TEXT))


def _train(trees, out, *extra):
    return train.main(["--dataset_file", "ytvos", "--ytvos_path", trees["train"],
                       "--output_dir", str(out), "--epochs", "1", "--batch_size", "1",
                       "--max_size", "96", "--num_workers", "0", *SMALL, *OPTIONS, *extra])


def _logged(out):
    with open(out / "log.txt") as fh:
        return json.loads(fh.readline())


def test_train_then_infer_with_every_option(trees, tmp_path, tiny_text, monkeypatch):
    state = _train(trees, tmp_path / "train")
    model = state.model
    assert model.cfg.num_classes == 65 and not model.cfg.masks
    assert [h.out_features for h in model.class_embed] == [65, 65]
    assert len(model.visible_embed) == 2 and model.transformer.encoder.layers[0].inter_frame_atten
    assert not hasattr(model.pixel_decoder, "cross_attn_1")
    logged = _logged(tmp_path / "train")
    losses = {k[len("train_"):] for k in logged if k.startswith("train_loss_")}
    assert {"loss_ce", "loss_vis", "loss_vis_0", "loss_bbox", "loss_giou"} <= losses
    assert not any(k.startswith(("loss_mask", "loss_dice")) for k in losses)
    assert np.isfinite(logged["train_loss"])

    monkeypatch.setattr(text_encoder, "require_real_tokenizer", lambda context="": None)
    out = tmp_path / "infer"
    infer.main(["--dataset_file", "ytvos", "--ytvos_path", str(trees["valid"]),
                "--output_dir", str(out), "--resume",
                str(tmp_path / "train" / "checkpoint" / "model.pt"), *SMALL, *OPTIONS])
    got = ytvos_pngs(out)
    assert set(got) == {(v, str(e), f"{i:05d}") for v, (n, caps) in YTVOS_VIDEOS.items()
                        for e in range(len(caps)) for i in range(n)}
    for mode, m in got.values():
        assert mode == "L" and m.shape == CLI_HW and set(np.unique(m)) <= {0, 255}


def test_train_with_masks_logs_the_mask_losses(trees, tmp_path, tiny_text):
    _train(trees, tmp_path, "--masks", "--binary")
    logged = _logged(tmp_path)
    assert {"train_loss_mask", "train_loss_dice", "train_loss_dice_0", "train_loss_vis"} <= set(
        logged)


def test_jhmdb_without_binary_scores_as_with_it(trees, tmp_path, tiny_text):
    argv = ["--eval", "--dataset_file", "jhmdb", "--jhmdb_path", trees["jhmdb"],
            "--batch_size", "2", "--num_workers", "1", "--output_dir", str(tmp_path), *SMALL,
            "--num_frames", "3", "--with_box_refine", "--f_token", "2", "--qtrans"]
    with_binary = train.main(argv + ["--binary"])
    without = train.main(argv)
    assert without == with_binary

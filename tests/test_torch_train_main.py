"""The port's training entry point ``tce_rvos_tpu_torch.train.main`` on the
CPU, on a synthetic Ref-YouTube-VOS train tree (2 videos x 4 frames, as
tests/test_train_main_e2e.py), with that test's tiny flags and a tiny text
encoder: one epoch, then a resume that restores the saved weights and
optimizer state bitwise and trains the next epoch; the retained checkpoint
manager (``--ckpt_backend orbax``); the port's and the JAX package's
parsers give the same configs; and the flags the port refuses.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from tce_rvos_tpu import cli as jax_cli
from tce_rvos_tpu_torch import cli
from tce_rvos_tpu_torch.train import main
from tce_rvos_tpu_torch.utils.native_ckpt import load_checkpoint
from torch_parity_helpers import torch_threads  # noqa: F401 (autouse fixture)
from torch_parity_helpers import write_ytvos_tree

TINY_TEXT = dict(text_encoder_layers=1, text_encoder_hidden=32, text_encoder_heads=2,
                 text_encoder_intermediate=64)


@pytest.fixture(scope="module")
def ytvos_root(tmp_path_factory):
    return write_ytvos_tree(str(tmp_path_factory.mktemp("ytvos_main")), n_frames=4)


@pytest.fixture()
def tiny_text(monkeypatch):
    orig = cli.model_config_from_args
    monkeypatch.setattr(cli, "model_config_from_args",
                        lambda args: dataclasses.replace(orig(args), **TINY_TEXT))


def _argv(root, out):
    return ["--dataset_file", "ytvos", "--ytvos_path", str(root), "--output_dir", str(out),
            "--batch_size", "1", "--num_frames", "2", "--enc_layers", "1", "--dec_layers", "1",
            "--dim_feedforward", "32", "--hidden_dim", "64", "--nheads", "2", "--binary",
            "--max_size", "96", "--num_workers", "0", "--lr_drop", "100", "--device", "cpu"]


def _logs(out):
    with open(out / "log.txt") as fh:
        return [json.loads(line) for line in fh]


def _assert_state_is(state, path):
    sd, opt_sd, _ = load_checkpoint(str(path))
    for name, value in state.model.state_dict().items():
        assert torch.equal(value, sd[name]), name
    saved = opt_sd["state"]
    live = state.optimizer.state_dict()["state"]
    assert sorted(live) == sorted(saved) and len(saved) > 0
    for i, entry in saved.items():
        for k, v in entry.items():
            assert torch.equal(live[i][k], v), (i, k)


def test_main_one_epoch_then_resume(ytvos_root, tmp_path, tiny_text):
    out = tmp_path / "out"
    argv = _argv(ytvos_root, out)
    state = main(argv + ["--epochs", "1"])
    steps_per_epoch = 4  # 2 videos x 2 anchors, batch 1
    assert state.step == steps_per_epoch
    for name in ("checkpoint", "checkpoint0000"):
        assert sorted(p.name for p in (out / name).iterdir()) == [
            "meta.json", "model.pt", "optimizer.pt"]
    logs = _logs(out)
    assert [line["epoch"] for line in logs] == [0]
    assert np.isfinite(logs[0]["train_loss"])
    assert logs[0]["train_lr"] == pytest.approx(1e-4)
    assert 0 <= logs[0]["train_data"] <= logs[0]["train_time"]
    assert logs[0]["n_parameters"] == sum(p.numel() for p in state.model.parameters())
    with open(out / "checkpoint0000" / "meta.json") as fh:
        assert json.load(fh) == {"epoch": 0, "step": steps_per_epoch}

    # a resume that has nothing left to train: the restored state as saved
    restored = main(argv + ["--epochs", "1", "--resume", str(out / "checkpoint")])
    assert restored.step == steps_per_epoch
    _assert_state_is(restored, out / "checkpoint")
    assert len(_logs(out)) == 1

    # resume: exactly one more epoch (1), appended to the same log
    state = main(argv + ["--epochs", "2", "--resume", str(out / "checkpoint")])
    assert [line["epoch"] for line in _logs(out)] == [0, 1]
    assert _logs(out)[-1]["train_lr"] == pytest.approx(1e-4)
    with open(out / "checkpoint0001" / "meta.json") as fh:
        assert json.load(fh) == {"epoch": 1, "step": 2 * steps_per_epoch}
    _assert_state_is(state, out / "checkpoint0001")


def test_main_with_the_retained_manager(ytvos_root, tmp_path, tiny_text):
    out = tmp_path / "out"
    argv = _argv(ytvos_root, out) + ["--ckpt_backend", "orbax", "--ckpt_keep", "1",
                                     "--lr_drop", "1"]
    main(argv + ["--epochs", "2"])
    assert sorted(p.name for p in (out / "orbax").iterdir()) == ["8"]
    assert not (out / "checkpoint").exists()
    state = main(argv + ["--epochs", "3", "--resume", "latest"])
    assert state.step == 12
    assert [line["epoch"] for line in _logs(out)] == [0, 1, 2]
    assert [line["train_lr"] for line in _logs(out)] == pytest.approx([1e-4, 1e-5, 1e-5])
    assert sorted(p.name for p in (out / "orbax").iterdir()) == ["12"]


FLAGSHIP_ARGV = ["--with_box_refine", "--binary", "--f_token", "8", "--qtrans",
                 "--compute_dtype", "bfloat16", "--batch_size", "2", "--epochs", "6",
                 "--lr_drop", "3", "5", "--lr", "5e-5", "--lr_backbone_names", "backbone.0",
                 "body", "--cyclic_lr", "--cyclic_lr_boundary", "1e-6", "1e-4",
                 "--pretrain_enc", "--freeze_text_encoder", "--seed", "7", "--num_workers", "2",
                 "--dataset_file", "davis", "--davis_path", "/x/davis", "--max_size", "512",
                 "--keep_fps", "--vid_aug", "--cache_mode", "--max_skip", "5", "--no-flat_opt",
                 "--dropout_rng_impl", "threefry2x32", "--ckpt_backend", "orbax"]


@pytest.mark.parametrize("argv", [[], FLAGSHIP_ARGV], ids=["defaults", "flagship"])
def test_parser_matches_jax(argv):
    args = cli.get_args_parser().parse_args(argv)
    jargs = jax_cli.get_args_parser().parse_args(argv)
    assert set(vars(jargs)) == set(vars(args)) - {"device"}
    assert args.device == "cuda"
    for port_cfg, jax_cfg in ((cli.train_config_from_args(args),
                               jax_cli.train_config_from_args(jargs)),
                              (cli.data_config_from_args(args),
                               jax_cli.data_config_from_args(jargs))):
        port_fields = dataclasses.asdict(port_cfg)
        jax_fields = dataclasses.asdict(jax_cfg)
        # the TPU implementation choices, which the port accepts and maps
        # to torch.optim.AdamW and torch's generator
        assert set(jax_fields) - set(port_fields) <= {"flat_opt", "dropout_rng_impl"}
        assert set(port_fields) <= set(jax_fields)
        for k, v in port_fields.items():
            assert v == jax_fields[k], k


@pytest.mark.parametrize("extra,error,match", [
    (["--eval"], NotImplementedError, "evaluation is not ported"),
    (["--dataset_file", "mevis"], ValueError, "not ported"),
    (["--dataset_file", "vidstg"], NotImplementedError, "VidSTG"),
    (["--device", "cuda"], RuntimeError, "CUDA is not available"),
    (["--pretrained_weights", "weights.pth"], RuntimeError, "tokenizer"),
    (["--backbone", "swin_t"], ValueError, "--backbone"),
], ids=["eval", "dataset", "vidstg", "cuda", "pretrained", "backbone"])
def test_main_refuses(ytvos_root, tmp_path, tiny_text, monkeypatch, extra, error, match):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)  # a host without a GPU
    with pytest.raises(error, match=match):
        main(_argv(ytvos_root, tmp_path / "out") + ["--epochs", "1"] + extra)
    assert not (tmp_path / "out" / "log.txt").exists()

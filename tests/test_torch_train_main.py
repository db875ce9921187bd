"""The port's training entry point ``tce_rvos_tpu_torch.train.main`` on the
CPU, on a synthetic Ref-YouTube-VOS train tree (2 videos x 4 frames, as
tests/test_train_main_e2e.py), with that test's tiny flags and a tiny text
encoder: one epoch, then a resume that restores the saved weights and
optimizer state bitwise and trains the next epoch, with the flat AdamW (the
default) and with ``--no-flat_opt``; the retained checkpoint
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
from tce_rvos_tpu_torch.parallel.flat_adamw import FlatAdamW
from tce_rvos_tpu_torch.train import main
from tce_rvos_tpu_torch.utils import profiling
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
            "--masks", "--max_size", "96", "--num_workers", "0", "--lr_drop", "100",
            "--device", "cpu"]


def _logs(out):
    with open(out / "log.txt") as fh:
        return [json.loads(line) for line in fh]


def _assert_same(live, saved, where: str) -> None:
    """Nested state dicts equal, tensors bitwise."""
    if isinstance(saved, dict):
        assert sorted(map(str, live)) == sorted(map(str, saved)), where
        for k in saved:
            _assert_same(live[k], saved[k], f"{where}.{k}")
    elif isinstance(saved, (list, tuple)):
        assert len(live) == len(saved), where
        for i, (a, b) in enumerate(zip(live, saved)):
            _assert_same(a, b, f"{where}[{i}]")
    elif isinstance(saved, torch.Tensor):
        assert torch.equal(live, saved), where
    else:
        assert live == saved, where


def _assert_state_is(state, path):
    """The state's weights and optimizer state bitwise the checkpoint's
    (the flat AdamW's layout, counters and moments, or AdamW's
    per-parameter state with ``--no-flat_opt``), Adam's counters at the
    step count."""
    sd, opt_sd, _ = load_checkpoint(str(path))
    for name, value in state.model.state_dict().items():
        assert torch.equal(value, sd[name]), name
    _assert_same(state.optimizer.state_dict(), opt_sd, "optimizer")
    assert state.optimizer.adam_counts() == {state.step}


def test_main_one_epoch_then_resume(ytvos_root, tmp_path, tiny_text):
    check_one_epoch_then_resume(ytvos_root, tmp_path, flat_opt=True)


def test_main_one_epoch_then_resume_no_flat_opt(ytvos_root, tmp_path, tiny_text):
    check_one_epoch_then_resume(ytvos_root, tmp_path, flat_opt=False)


def check_one_epoch_then_resume(ytvos_root, tmp_path, flat_opt: bool):
    out = tmp_path / "out"
    argv = _argv(ytvos_root, out) + ([] if flat_opt else ["--no-flat_opt"])
    state = main(argv + ["--epochs", "1"])
    steps_per_epoch = 4  # 2 videos x 2 anchors, batch 1
    assert state.step == steps_per_epoch
    assert isinstance(state.optimizer, FlatAdamW) == flat_opt
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


def test_main_trace_dir_writes_the_trace_and_the_spans(ytvos_root, tmp_path, tiny_text):
    """``--trace_dir``: one epoch under the profiler with the program's
    spans on; ``trace.json`` holds the train step's phases and the model's
    stages, ``spans.json`` one ``tce.train.step`` and one
    ``tce.train.read_metrics`` a step; tracing is off again after."""
    trace_dir = tmp_path / "trace"
    state = main(_argv(ytvos_root, tmp_path / "out") + ["--epochs", "1",
                                                        "--trace_dir", str(trace_dir)])
    assert not profiling.enabled()
    with open(trace_dir / profiling.SPANS_FILE) as fh:
        names = [s["name"] for s in json.load(fh)["spans"]]
    assert names.count("tce.train.step") == names.count("tce.train.read_metrics") == state.step
    assert state.step == 4
    with open(trace_dir / profiling.TRACE_FILE) as fh:
        events = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert {"tce.train.forward", "tce.train.backward", "tce.train.update",
            "tce.model.encoder"} <= events


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
        # the TPU's dropout RNG, which the port accepts and maps to torch's
        # generator
        assert set(jax_fields) - set(port_fields) <= {"dropout_rng_impl"}
        assert set(port_fields) <= set(jax_fields)
        for k, v in port_fields.items():
            assert v == jax_fields[k], k


@pytest.mark.parametrize("argv", [
    ["--backbone", "video_swin_b_p4w7"], ["--dilation"], ["--backbone", "resnet101", "--dilation"],
    ["--backbone", "swin_l_p4w7", "--use_checkpoint"], ["--backbone", "x3d_m"]],
    ids=["video_swin_b", "dc5", "resnet101_dc5", "swin_l", "x3d_m"])
def test_backbone_flags_match_jax(argv):
    argv = argv + ["--binary", "--with_box_refine", "--f_token", "8", "--qtrans"]
    cfg = cli.model_config_from_args(cli.get_args_parser().parse_args(argv))
    jax_cfg = jax_cli.model_config_from_args(jax_cli.get_args_parser().parse_args(argv))
    for k, v in dataclasses.asdict(cfg).items():
        assert v == getattr(jax_cfg, k), k
    want = argv[argv.index("--backbone") + 1] if "--backbone" in argv else "resnet50"
    assert (cfg.backbone, cfg.dilation) == (want, "--dilation" in argv)


@pytest.mark.parametrize("extra,error,match", [
    (["--eval"], ValueError, "no metric protocol for 'ytvos'.*tce_rvos_tpu_torch.infer"),
    (["--dataset_file", "a2d"], FileNotFoundError,  # no A2D-Sentences tree at the default path
     "a2d_sentences_single_frame_train_annotations"),
    (["--dataset_file", "vidstg"], NotImplementedError, "VidSTG"),
    (["--device", "cuda"], RuntimeError, "CUDA is not available"),
    (["--pretrained_weights", "weights.pth"], RuntimeError, "tokenizer"),
    (["--backbone", "swin_t"], ValueError, "--backbone"),
    (["--backbone", "x3d_s"], ValueError,
     "^--backbone x3d_s: X3D serves and evaluates .* the JAX package cannot train it"),
], ids=["eval", "dataset", "vidstg", "cuda", "pretrained", "backbone", "x3d"])
def test_main_refuses(ytvos_root, tmp_path, tiny_text, monkeypatch, extra, error, match):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)  # a host without a GPU
    with pytest.raises(error, match=match):
        main(_argv(ytvos_root, tmp_path / "out") + ["--epochs", "1"] + extra)
    assert not (tmp_path / "out" / "log.txt").exists()

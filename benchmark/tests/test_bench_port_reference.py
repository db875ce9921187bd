"""The frozen reference against the port at tiny widths on the CPU, in
float32 from the same weights: the serving forward of every configuration
of ``BENCHMARK.json`` (the backbone, and the trunk over its features with
two expressions), and three training steps of the port's trainer (flat
AdamW, dropout drawn alike on both sides) against the reference's step."""

import copy
import time

import numpy as np
import pytest
import torch

import bench_helpers as bh
import reference
from harness import check, serve, train, weights
from reference.text_encoder import tokenize

KEYS = ("pred_logits", "pred_boxes", "pred_masks", "reference_points")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", bh.CONFIGS)
def test_forward_matches_the_port(name):
    from tce_rvos_tpu_torch.models.referformer import ReferFormer

    cfg = bh.tiny_config(name)
    sd, _ = weights.state_dict(cfg, 5, "cpu")
    port = ReferFormer(serve._program_config(cfg))
    port.load_state_dict(sd, strict=True)
    ref = reference.build(cfg, "cpu")
    ref.load_state_dict(sd, strict=True)
    g = torch.Generator().manual_seed(1)
    video = torch.randn(1, 3, 64, 96, 3, generator=g)
    mask = torch.zeros(1, 3, 64, 96, dtype=torch.bool)
    mask[..., 90:] = True
    ids, attn = (torch.as_tensor(x).long() for x in tokenize(["a dog on the left", "the car"]))
    sizes = torch.tensor([[64, 90]])
    with torch.no_grad():
        outs = []
        for m in (port.eval(), ref.eval()):
            feats = m(video, mask, backbone_only=True)
            outs.append(m(None, mask, ids, attn, sizes, precomputed_feats=feats))
    for k in KEYS:
        assert check.rel_gap(outs[0][k].numpy(), outs[1][k].numpy()) < 1e-5, k


def test_three_train_steps_match_the_port():
    cell = bh.tiny_cell("tce_r50_ftf8_iqt.train_b1")
    res = train.run(cell, 11, 0.5, False, "cpu", time.perf_counter())
    assert res["notes"]["dropout_calls"] > 0
    assert check.BROKEN not in res["numbers"]
    # float32 on both sides: the losses agree to rounding; the gradients'
    # and changes' norms by leaf to far below any bf16 limit
    assert res["numbers"]["loss_gap"] < 1e-5
    assert res["numbers"]["grad_gap"] < 1e-4
    assert res["numbers"]["change_gap"] < 1e-2
    assert res["notes"]["left_out"]  # the key biases: zero gradient in exact arithmetic


def test_the_windows_are_the_engines():
    from tce_rvos_tpu_torch.infer import InferenceEngine

    for mix in (dict(whole_video=True, t_bucket=8, window=5, f_extra=0),
                dict(whole_video=False, t_bucket=8, window=5, f_extra=0),
                dict(whole_video=False, t_bucket=8, window=5, f_extra=1)):
        eng = InferenceEngine.__new__(InferenceEngine)
        eng.window, eng.t_bucket = mix["window"], mix["t_bucket"]
        for t in (3, 5, 12, 13, 36):
            assert check.windows(t, mix) == list(eng.windows(t, mix["f_extra"],
                                                             mix["whole_video"]))

"""The benchmark's FLOP count (``harness/counts.py``) against
``torch.utils.flop_counter`` over the frozen reference, at full width and
depth on two 224x224 frames (every Video-Swin window whole, so that no
window padding is counted by one side only) with two 6-word captions (8
tokens, no text padding): the serving forward of every configuration of
``BENCHMARK.json`` and the training forward and backward."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import bench_helpers as bh
import reference
from harness import counts
from reference.text_encoder import tokenize

T, HW = 2, (224, 224)
CAPTIONS = ["a b c d e f", "g h i j k l"]


def model_and_inputs(name):
    cfg = bh.config(name)
    cfg["compute_dtype"] = "float32"
    model = reference.build(cfg, "cpu")
    g = torch.Generator().manual_seed(0)
    reference.init_weights(model, g)
    ids, attn = (torch.as_tensor(x).long() for x in tokenize(CAPTIONS))
    video = torch.randn(1, T, *HW, 3, generator=g)
    mask = torch.zeros(1, T, *HW, dtype=torch.bool)
    return cfg, model, video, mask, ids, attn, torch.tensor([list(HW)])


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", bh.CONFIGS)
def test_serving_forward(name):
    cfg, model, video, mask, ids, attn, sizes = model_and_inputs(name)
    model.requires_grad_(False)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        feats = model(video, mask, backbone_only=True)
        model(None, mask, ids, attn, sizes, precomputed_feats=feats)
    tokens = [int(a.sum()) for a in attn]
    assert tokens == [8, 8] and ids.shape[1] == 8
    assert counts.forward_flops(cfg, T, HW, tokens) == fc.get_total_flops()


def test_training_forward_and_backward():
    cfg, model, video, mask, ids, attn, sizes = model_and_inputs("tce_r50_ftf8_iqt")
    model.train()
    with FlopCounterMode(display=False) as fc:
        out = model(video, mask, ids[:1], attn[:1], sizes, aux_outputs=True)
        heads = [out] + out["aux_outputs"]
        loss = sum(h[k].float().mean() for h in heads for k in ("pred_masks", "pred_logits",
                                                               "pred_boxes"))
        loss.backward()
    assert counts.train_flops(cfg, T, HW, [int(attn[0].sum())]) == fc.get_total_flops()


def test_padding_is_not_useful_work():
    cfg = json.loads((bh.ROOT / "benchmark" / "configs" / "tce_r50_ftf8_iqt.json").read_text())
    hw = (384, 640)
    one = counts.forward_flops(cfg, 12, hw, [12])
    assert counts.forward_flops(cfg, 12, hw, [12, 12]) > one
    assert counts.forward_flops(cfg, 16, hw, [12]) > one
    # a whole-video request counts its own frames, not the bucket's
    assert counts.forward_flops(cfg, 12, hw, [12]) < counts.forward_flops(cfg, 16, hw, [12])


def test_msda_bounds_are_a_lower_bound_of_the_calls():
    cfg = json.loads((bh.ROOT / "benchmark" / "configs" / "tce_r50_ftf8_iqt.json").read_text())
    calls = counts.trunk_msda_calls(cfg, 20, [(96, 160), (48, 80), (24, 40), (12, 20)])
    assert len(calls) == 12 and sum(own for _, _, own in calls) == 4
    assert {q for _, q, _ in calls} == {5100, 8, 5}
    # an encoder call at N = 20: its bf16 value alone, 20 x 5100 x 256 x 2 bytes
    t = counts.msda_bound_s(20, 5100, 5100, 8, 32, 4, 4, 2, True, False)
    assert t >= 20 * 5100 * 256 * 2 / counts.PEAK_HBM_BYTES
    assert counts.msda_bound_s(20, 5100, 5100, 8, 32, 4, 4, 2, True, True) > t

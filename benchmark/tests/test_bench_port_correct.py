"""``correct`` comes out false for the control (the reference one
precision below the configuration's, float8 products, in the port's place)
and for each fault the cells can have, planted in the port underneath a
run that skips the look for a card: an answer altered where it is made,
half of a batch left out (the rest taken for the whole), and in training
a step that leaves the state unchanged and a matcher that picks the wrong
query (which the reference follows, so that only the matcher's own check
can see it). The cells run here at full width
and depth with small frames, in float32 on the CPU, against the cells' own
limits."""

import contextlib
import time

import pytest
import torch

import bench_helpers as bh
from harness import check, core, serve, train

SERVE = "tce_r50_ftf8_iqt.ytvos_whole"
TRAIN = "tce_r50_ftf8_iqt.train_b1"


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def correct(cell, **kw) -> bool:
    res = core.run_cell(cell, 2**31 + 99, 0.5, False, "cpu", time.perf_counter())
    return res["correct"]


@contextlib.contextmanager
def patched(obj, name, make):
    saved = getattr(obj, name)
    setattr(obj, name, make(saved))
    try:
        yield
    finally:
        setattr(obj, name, saved)


@pytest.fixture(scope="module")
def serve_cell():
    return bh.small_cell(SERVE)


@pytest.fixture(scope="module")
def train_cell():
    return bh.small_cell(TRAIN)


def test_sound_runs_are_correct(serve_cell, train_cell):
    assert correct(serve_cell)
    assert correct(train_cell)


def test_the_serving_control_is_not_correct(serve_cell):
    res = serve.run(serve_cell, 5, 0.5, False, "cpu", time.perf_counter(), control=True)
    assert check.judge(res["numbers"], serve_cell.limits)[0]
    assert not check.judge(res["control"], serve_cell.limits)[0], res["control"]


def test_the_training_control_is_not_correct(train_cell):
    res = train.run(train_cell, 5, 0.5, False, "cpu", time.perf_counter(), control=True)
    assert check.judge(res["numbers"], train_cell.limits)[0]
    assert not check.judge(res["control"], train_cell.limits)[0], res["control"]
    assert not check.judge(res["half_frames"], train_cell.limits)[0], res["half_frames"]


def test_an_altered_answer_is_not_correct(serve_cell):
    from tce_rvos_tpu_torch.infer import InferenceEngine

    def make(run_video_batch):
        def altered(self, *a, **k):
            outs = run_video_batch(self, *a, **k)
            for o in outs:  # every box moved right by a twentieth of the frame
                o["pred_boxes"] = o["pred_boxes"] + [0.05, 0.0, 0.0, 0.0]
            return outs
        return altered

    with patched(InferenceEngine, "run_video_batch", make):
        assert not correct(serve_cell)


def test_half_the_expressions_left_out_is_not_correct(serve_cell):
    from tce_rvos_tpu_torch.infer import InferenceEngine

    def make(trunk):
        def half(self, feats, mask, ids, attn, sizes):
            n = ids.shape[0]
            if n < 2:
                return trunk(self, feats, mask, ids, attn, sizes)
            out = trunk(self, feats, mask, ids[:n // 2], attn[:n // 2], sizes)
            return {k: torch.cat([v] * (n // (n // 2)), 0 if k != "inter_samples" else 1)
                    for k, v in out.items()}
        return half

    with patched(InferenceEngine, "trunk", make):
        assert not correct(serve_cell)


def test_an_unchanged_state_is_not_correct(train_cell):
    from tce_rvos_tpu_torch.parallel import flat_adamw

    def make(update):
        def keep(self):
            saved = self.params.clone()
            gnorm = update(self)
            self.params.copy_(saved)
            return gnorm
        return keep

    with patched(flat_adamw.FlatAdamW, "update", make):
        assert not correct(train_cell)


def test_half_the_batch_left_out_is_not_correct(train_cell):
    from tce_rvos_tpu_torch.parallel import train_step

    def make(forward_losses):
        def half(model, batch, crit_cfg, compute_dtype=None):
            return forward_losses(model, check.half_frames(batch), crit_cfg, compute_dtype)
        return half

    with patched(train_step, "forward_losses", make):
        assert not correct(train_cell)


def test_an_altered_loss_is_not_correct(train_cell):
    from tce_rvos_tpu_torch.parallel import train_step

    def make(forward_losses):
        def altered(*a, **k):
            total, losses = forward_losses(*a, **k)
            return total * 1.5, losses
        return altered

    with patched(train_step, "forward_losses", make):
        assert not correct(train_cell)


def test_a_wrong_matcher_pick_is_not_correct(train_cell):
    from reference.matcher import match_costs
    from tce_rvos_tpu_torch.models import criterion as port_criterion

    def make(match):
        def costliest(*a, **k):
            return match_costs(*a, **k).argmax(1)
        return costliest

    with patched(port_criterion, "match", make):
        assert not correct(train_cell)

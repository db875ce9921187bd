"""The port's data-parallel train step on the CPU: two processes over gloo
(``parallel/dryrun.py::run_processes``), each training on one clip of the
tiny model of configuration (A) (``torch_parity_helpers.OPTIONS_A``: the
visibility loss, 65 classes, LastLayerAsToken, IQT, box refinement; f32,
dropout off), against the one-process step on both clips and against the
JAX package's step on the global batch.

The port's recipe (``parallel/train_step.py``): each rank divides its
losses by the global count of valid frames and the gradients are summed.
The visibility loss is divided by ``t`` on every rank, so averaging the
gradients over the ranks, as DistributedDataParallel does, with the
reference's ``num_boxes`` divided by the world size, weakens it by the
world size; ``test_averaged_gradients_weaken_the_visibility_loss`` holds
that this recipe misses the one-process step where the port's holds it.

Each case trains with the flat AdamW (the default: the all-reduce is one
call on its gradient buffer), and the ``summed`` batch also with
``--no-flat_opt`` (``summed_no_flat_opt``: the concatenated gradients),
held against JAX with the optimizer of the same ``flat_opt``.

The ranks run in one module-scoped spawn (tests/torch_dist_cases.py); the
tolerances are the JAX package's DP test's (tests/test_dp_invariance.py:
loss rtol 1e-5, grad norm 1e-4, parameters atol 1e-4 / rtol 1e-3) between
the ranks and one process, and ``check_two_train_steps``' against JAX.
"""

import numpy as np
import pytest
import torch

from tce_rvos_tpu.config import TrainConfig as JaxTrainConfig
from tce_rvos_tpu_torch.config import TrainConfig
from tce_rvos_tpu_torch.parallel import dryrun
from tce_rvos_tpu_torch.utils.convert import state_dict_from_jax
from torch_parity_helpers import torch_threads  # noqa: F401 (autouse fixture)
from torch_parity_helpers import (
    OPTIONS_A,
    OPTIONS_STEP_SEED,
    check_step_against_jax,
    jax_train_runs,
    model_inputs,
    tiny_model,
    train_targets,
)

TRAIN = dict(lr_drop=(1,))  # check_two_train_steps' configuration
NO_FLAT = dict(TRAIN, flat_opt=False)


def _batch(targets):
    inputs = model_inputs(seed=OPTIONS_STEP_SEED)
    return dict(inputs, targets=targets)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The specs, the one-process steps and the two ranks' results of every
    case: ``summed`` (the port's step), ``summed_no_flat_opt`` (the same with
    ``--no-flat_opt``), ``clamp`` (clip 1 has no valid frame) and
    ``averaged`` (the DDP recipe on ``summed``'s batch)."""
    import torch_dist_cases

    tmp = tmp_path_factory.mktemp("dp")
    _, _, _, flat, _ = tiny_model("options_a")
    torch.save(state_dict_from_jax(flat), tmp / "weights.pt")
    targets = train_targets(num_classes=65)
    no_valid = {k: v.copy() for k, v in targets.items()}
    no_valid["valid"][1] = 0
    specs = {}
    for name, tg in (("summed", targets), ("clamp", no_valid)):
        torch.save(_batch(tg), tmp / f"{name}.pt")
        specs[name] = {"model": OPTIONS_A, "train": TRAIN, "device": "cpu",
                       "weights": str(tmp / "weights.pt"), "batch": str(tmp / f"{name}.pt")}
    specs["summed_no_flat_opt"] = dict(specs["summed"], train=NO_FLAT)
    one = {name: dryrun.train_step_on_shard(0, spec) for name, spec in specs.items()}
    ranks = dryrun.run_processes(2, torch_dist_cases.dp_cases, (specs,))
    return {"targets": targets, "one": one, "ranks": ranks}


@pytest.mark.parametrize("case", ["summed", "clamp", "summed_no_flat_opt"])
def test_two_ranks_step_like_one_process_on_both_clips(runs, case):
    want = runs["one"][case]
    for rank, got in enumerate(runs["ranks"]):
        dryrun.check_dp_step(got[case], want, f"{case} rank {rank}")
        assert got[case]["metrics"].keys() == want["metrics"].keys()
        for k, v in want["metrics"].items():  # every logged loss is the global batch's
            assert got[case]["metrics"][k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
    for name, p in runs["ranks"][0][case]["params"].items():  # the ranks stay replicas
        assert torch.equal(runs["ranks"][1][case]["params"][name], p), name


def test_a_rank_without_valid_frames_counts_none(runs):
    """Clip 1 has no valid frame: the global count is clip 0's (2 of 3
    frames), clamped only as a sum. A clamp of each rank's count to 1
    before the sum would divide by 3."""
    got = runs["ranks"][1]["clamp"]["metrics"]
    want = runs["one"]["clamp"]["metrics"]
    assert got["loss_bbox"] == pytest.approx(want["loss_bbox"], rel=1e-5)
    assert runs["one"]["clamp"]["metrics"]["loss_bbox"] != pytest.approx(
        runs["one"]["summed"]["metrics"]["loss_bbox"], rel=1e-2)


def test_averaged_gradients_weaken_the_visibility_loss(runs):
    want = runs["one"]["summed"]
    avg = runs["ranks"][0]["averaged"]
    port = runs["ranks"][0]["summed"]
    max_norm = TrainConfig(**TRAIN).clip_max_norm

    def unclipped(run, name):  # p.grad holds the clipped gradient
        return run["grads"][name] / min(1.0, max_norm / run["metrics"]["grad_norm"])

    vis = [n for n in want["grads"] if n.startswith("visible_embed.")]
    assert vis
    for name in vis:  # only the visibility loss reaches these
        g_one, g_port, g_avg = (unclipped(r, name) for r in (want, port, avg))
        scale = float(g_one.abs().max())
        assert float((g_port - g_one).abs().max()) <= 1e-4 * scale, name
        assert float((g_avg - g_one / 2).abs().max()) <= 1e-4 * scale, name
    # so the averaged step's global gradient misses the one-process one
    gn, gn_one = avg["metrics"]["grad_norm"], want["metrics"]["grad_norm"]
    assert abs(gn - gn_one) > dryrun.DP_TOL["grad_norm_rtol"] * gn_one
    # while each rank's terms normalised by num_boxes are the port's times the
    # world size, its visibility loss is the port's own
    for k in ("loss_bbox", "loss_giou", "loss_mask", "loss_dice", "loss_ce"):
        assert avg["metrics"][k] == pytest.approx(2 * want["metrics"][k], rel=1e-5), k
    assert avg["metrics"]["loss_vis"] == pytest.approx(want["metrics"]["loss_vis"], rel=1e-5)


@pytest.fixture(scope="module")
def jax_steps(runs):
    """The JAX step on the global batch with the flat AdamW and with the
    optax chain, sharing one compiled gradient."""
    tiny = tiny_model("options_a")
    batch = _batch(runs["targets"])
    inputs = {k: v for k, v in batch.items() if k != "targets"}
    steps = jax_train_runs(tiny, [JaxTrainConfig(**TRAIN), JaxTrainConfig(**NO_FLAT)],
                           runs["targets"], 1, inputs)
    return {"summed": steps[0][0], "summed_no_flat_opt": steps[1][0]}


def _check_ranks_against_jax(runs, want, case, train) -> None:
    before = {k: v.numpy() for k, v in state_dict_from_jax(tiny_model("options_a")[3]).items()}
    for rank, got in enumerate(runs["ranks"]):
        step = got[case]
        grads = step["grads"] if rank == 0 else runs["ranks"][0][case]["grads"]
        check_step_against_jax(
            0, step["metrics"], {n: g.numpy() for n, g in grads.items()},
            {n: before[n] for n in grads}, {n: p.numpy() for n, p in step["params"].items()},
            want, TrainConfig(**train))
    assert np.isfinite(runs["ranks"][0][case]["metrics"]["loss_vis"])


def test_two_ranks_step_matches_jax_on_the_global_batch(runs, jax_steps):
    _check_ranks_against_jax(runs, jax_steps["summed"], "summed", TRAIN)


def test_two_ranks_step_with_no_flat_opt_matches_jax_on_the_global_batch(runs, jax_steps):
    _check_ranks_against_jax(runs, jax_steps["summed_no_flat_opt"], "summed_no_flat_opt",
                             NO_FLAT)

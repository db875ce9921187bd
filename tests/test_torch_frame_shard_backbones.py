"""The frame-sharded forward (``parallel/mesh.py::shard_time_axis``,
``ReferFormer.forward(..., frame_shard=...)``) with the temporal backbones
and ``valid_indices``, on the CPU: two spawned gloo ranks
(``parallel/dryrun.py::run_processes``; what they run is
``tests/torch_dist_cases.py::frame_shard_backbone_cases``) whose gathered
outputs are held against the one-process port forward at ``dryrun.SP_TOL``
(float64 at ``F64_TOL``) and against the JAX model's own sharded forward
at ``SLICE_TOL``; world 1 against no shard, bitwise; Video-Swin's window
plans against one process's shifted windows; and the collectives the
backbones and ``valid_indices`` use.

The models are the tiny trunk of ``test_torch_frame_shard.py``'s
``SMALL`` on Video-Swin-T (full width: windows of (8, 7, 7) shifted by
(4, 3, 3) past 8 frames) and X3D-XS, and the tiny flagship for
``valid_indices``, with seeded random JAX variables carried over by
``state_dict_from_jax``. The JAX forwards compile in threads while the
ranks run.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from tce_rvos_tpu.config import ModelConfig as JaxModelConfig
from tce_rvos_tpu.models.build import build_model as jax_build_model
from tce_rvos_tpu_torch.models.swin import temporal_window_plan
from tce_rvos_tpu_torch.parallel import collectives, dryrun
from tce_rvos_tpu_torch.parallel.mesh import FrameShard
from tce_rvos_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_frame_shard import F64_TOL, MODELS, clip_inputs, jax_inputs, jax_sharded_forward
from torch_dist_cases import FRAME_RANGES
from torch_parity_helpers import torch_threads  # noqa: F401 (autouse fixture)
from torch_parity_helpers import SLICE_TOL, assert_close, random_variables

BACKBONE_MODELS = {"vswin": dict(MODELS["flagship"], backbone="video_swin_t_p4w7"),
                   "x3d": dict(MODELS["flagship"], backbone="x3d_xs"),
                   "flagship": MODELS["flagship"]}
CASES = {  # tag: (model, frames, dtype, valid_indices)
    "vswin_t4": ("vswin", 4, "float32", None),     # one temporal window over both ranks
    "vswin_t12": ("vswin", 12, "float32", None),   # windows of 8 shifted by 4, padded to 16
    "vswin_t16": ("vswin", 16, "float32", None),   # 8 frames a rank: the wrap reaches rank 1
    "x3d_t2": ("x3d", 2, "float32", None),         # the stem's halo runs past the clip's ends
    "x3d_t6": ("x3d", 6, "float32", None),
    "valid_rank1": ("flagship", 4, "float32", [3]),
    "valid_rank0": ("flagship", 4, "float32", [0]),
    "vswin_t12_f64": ("vswin", 12, "float64", None),
    "x3d_t6_f64": ("x3d", 6, "float64", None),
}
JAX_CASES = ("vswin_t12", "x3d_t6")
BITWISE = ("vswin_t12", "x3d_t6", "valid_rank1")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("frame_shard_backbones")
    jax_models = {}
    for name, cfg in BACKBONE_MODELS.items():
        model = jax_build_model(JaxModelConfig(**cfg, msda_impl="xla"))
        variables, flat = random_variables(model.init, **jax_inputs(clip_inputs(2)), seed=3)
        torch.save(state_dict_from_jax(flat), root / f"{name}.pt")
        jax_models[name] = (model, variables)
    specs, inputs = {}, {}
    for seed, (tag, (name, t, dtype, valid)) in enumerate(CASES.items()):
        inputs[tag] = clip_inputs(t, seed=seed)
        torch.save(inputs[tag], root / f"{tag}_inputs.pt")
        specs[tag] = {"model": BACKBONE_MODELS[name], "device": "cpu",
                      "weights": str(root / f"{name}.pt"), "inputs": str(root / f"{tag}_inputs.pt"),
                      "dtype": dtype, "valid_indices": valid}
    import torch_dist_cases

    with ThreadPoolExecutor(len(JAX_CASES) + 1) as pool:
        ranks = pool.submit(dryrun.run_processes, 2, torch_dist_cases.frame_shard_backbone_cases,
                            (specs, list(BITWISE)))
        jax_out = {tag: pool.submit(jax_sharded_forward, *jax_models[CASES[tag][0]], inputs[tag])
                   for tag in JAX_CASES}
        jax_out = {tag: f.result() for tag, f in jax_out.items()}
        ranks = ranks.result()
    plain = {tag: dryrun.sp_forward(dict(spec, plain=True)) for tag, spec in specs.items()}
    return dict(ranks=ranks, jax=jax_out, plain=plain)


@pytest.mark.parametrize("tag", list(CASES))
def test_two_ranks_match_one_process(runs, tag):
    """Each rank's gathered logits, boxes and masks against the
    one-process port forward at SP_TOL (F64_TOL in float64); the two ranks
    hold the same. With ``valid_indices`` the outputs hold the annotated
    frame alone, on both ranks."""
    want = runs["plain"][tag]
    ranks = [r["sp"][tag] for r in runs["ranks"]]
    _, t, dtype, valid = CASES[tag]
    tol = F64_TOL if dtype == "float64" else dryrun.SP_TOL
    for i, got in enumerate(ranks):
        assert got["sharded"]
        assert got["pred_masks"].dtype == getattr(torch, dtype)
        assert got["pred_logits"].shape[1] == (1 if valid else t)
        dryrun.sp_gaps(got, want, f"rank {i} {tag}", tol)
    for k in dryrun.SP_OUTPUTS:
        assert torch.equal(ranks[0][k], ranks[1][k]), k


@pytest.mark.parametrize("tag", JAX_CASES)
def test_two_ranks_match_the_jax_sharded_forward(runs, tag):
    want = runs["jax"][tag]
    for got in (r["sp"][tag] for r in runs["ranks"]):
        for k in dryrun.SP_OUTPUTS:
            assert tuple(got[k].shape) == want[k].shape, k
            assert_close(got[k], want[k], rtol=SLICE_TOL, atol=SLICE_TOL, name=f"{tag} {k}")


@pytest.mark.parametrize("tag", BITWISE)
def test_world_1_is_the_unsharded_forward(runs, tag):
    """A shard of the whole clip over a group of one rank gives the
    forward without a shard bitwise."""
    for r in runs["ranks"]:
        sharded, plain = r["world1"][tag]
        assert sharded["sharded"] and not plain["sharded"]
        for k in dryrun.SP_OUTPUTS:
            assert torch.equal(sharded[k], plain[k]), k


@pytest.mark.parametrize("frames,world", [(4, 2), (12, 2), (16, 2), (16, 4), (24, 3), (20, 5),
                                          (9, 3), (8, 1)])
def test_window_plans_are_the_shifted_windows(frames, world):
    """Each rank's plan, for the unshifted and the shifted block, against
    one process's padded, rolled and partitioned clip: the gathered
    frames (zeros past T) laid out by ``take`` are exactly the windows its
    frames fall in, ``keep`` finds its own frames there, it gathers no
    frame of the clip it does not need, and at T <= 8 it gathers the whole
    clip."""
    count = frames // world
    clip = np.arange(1, frames + 1)  # frame f holds f + 1; the pad holds 0
    for window, shift in ((min(frames, 8), 0), (min(frames, 8), 4 if frames > 8 else 0)):
        tp = -(-frames // window) * window
        rolled = np.roll(np.pad(clip, (0, tp - frames)), -shift).reshape(-1, window)
        for rank in range(world):
            first = rank * count
            plan = temporal_window_plan(frames, window, shift, first, count)
            assert plan.padded_frames == tp and len(plan.ranges) == (2 if shift else 1)
            gathered = np.concatenate([np.pad(clip, (0, max(hi - frames, 0)))[lo:hi]
                                       for lo, hi in plan.ranges])
            laid_out = gathered[list(plan.take)]
            np.testing.assert_array_equal(laid_out, rolled[list(plan.windows)].reshape(-1))
            np.testing.assert_array_equal(laid_out[list(plan.keep)], clip[first:first + count])
            wanted = {f for f in laid_out if f}
            assert len(wanted) == sum(min(hi, frames) - lo for lo, hi in plan.ranges if hi > lo
                                      if lo < frames)
            if frames <= 8:
                assert wanted == set(clip)


def test_frame_ranges_are_the_clips_frames_bitwise(runs):
    """``gather_frame_range`` over the two gloo ranks (3 frames each of a
    6-frame clip): every range of ``FRAME_RANGES``, past either end, wider
    than a rank's frames or empty, is the whole clip's frames bitwise in
    f32, bf16 and bool, with the fill past the clip's ends."""
    for rank, r in enumerate(runs["ranks"]):
        assert [g[0] for g in r["ranges"][::6]] == [pair[rank] for pair in FRAME_RANGES]
        for (lo, hi), dtype, fill, full, got in r["ranges"]:
            want = torch.full((2, hi - lo, *full.shape[2:]), fill, dtype=full.dtype)
            a, e = max(lo, 0), min(hi, 6)
            if e > a:
                want[:, a - lo:e - lo] = full[:, a:e]
            assert got.dtype == full.dtype and torch.equal(got, want), (rank, lo, hi, dtype, fill)


def test_frame_range_of_one_process_is_a_slice():
    """Without a shard, or with a shard of the whole clip and no process
    group, the range is a view of the local frames when it lies inside
    them, and a padded copy when it runs past the clip."""
    x = torch.randn(2, 5, 3)
    for shard in (None, FrameShard(None, 0, 1, 5, 0, 5)):
        inside = collectives.gather_frame_range(x, shard, 1, 4)
        assert inside.data_ptr() == x[:, 1].data_ptr() and torch.equal(inside, x[:, 1:4])
        past = collectives.gather_frame_range(x, shard, -2, 6)
        assert torch.equal(past[:, 2:7], x) and not past[:, :2].any() and not past[:, 7:].any()
    with pytest.raises(ValueError, match="does not hold 4 frames"):
        collectives.gather_frame_range(x, FrameShard(None, 0, 1, 4, 0, 4), 0, 2)


def test_sum_is_reduced_in_float32(runs):
    """``all_reduce_sum`` of the ranks' bf16 tensors: their sum in float32,
    rounded to bf16 once."""
    parts = [r["sum"][0] for r in runs["ranks"]]
    want = (parts[0].float() + parts[1].float()).to(torch.bfloat16)
    for r in runs["ranks"]:
        assert r["sum"][1].dtype == torch.bfloat16 and torch.equal(r["sum"][1], want)
    x = torch.randn(3)
    assert collectives.all_reduce_sum(x, None) is x


def test_owner_rows_are_picked_bitwise(runs):
    """``pick_from_owners`` with owners [1, 0, 1]: every row is its owner's
    (each rank filled its rows with its rank), f32, bool and bf16 alike."""
    owners = torch.tensor([1, 0, 1])
    for r in runs["ranks"]:
        f32, flags, bf16 = r["picked"]
        assert torch.equal(f32, owners.float()[:, None, None].expand(3, 2, 2))
        assert torch.equal(flags, (owners == 1)[:, None].expand(3, 4))
        assert bf16.dtype == torch.bfloat16 and torch.equal(bf16, (owners + 10).to(torch.bfloat16))

"""The frame-sharded forward of one video (``parallel/mesh.py::
shard_time_axis``, ``ReferFormer.forward(..., frame_shard=...)``) on the
CPU: the shards against the JAX package's ``shard_time_axis`` on a
2-device mesh; the plain 3D MSDA with fewer query frames than value
frames; two spawned gloo ranks (``parallel/dryrun.py::run_processes``;
what they run is ``tests/torch_dist_cases.py::frame_shard_cases``) whose
gathered outputs are held against the one-process port forward at
``dryrun.SP_TOL`` and against the JAX model's own sharded forward at
``SLICE_TOL``; world 1 against no shard, bitwise; and what the
frame-sharded forward refuses (the temporal backbones and
``valid_indices``: ``tests/test_torch_frame_shard_backbones.py``).

The models are the tiny flagship, LastLayerAsToken (``OPTIONS_A``) and the
``--msda_3d`` flagship at 1 + 2 layers and a one-layer text encoder, with
seeded random weights given to both
frameworks: the MSDA offsets are not zero, so the 3D taps leave their own
frame. The JAX forwards compile in threads while the ranks run.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tce_rvos_tpu.config import ModelConfig as JaxModelConfig
from tce_rvos_tpu.models.build import build_model as jax_build_model
from tce_rvos_tpu.parallel import mesh as jax_mesh
from tce_rvos_tpu_torch.config import ModelConfig
from tce_rvos_tpu_torch.models.referformer import ReferFormer
from tce_rvos_tpu_torch.ops import msda_cuda
from tce_rvos_tpu_torch.ops.msda import ms_deform_attn_3d_plain
from tce_rvos_tpu_torch.parallel import collectives, dryrun
from tce_rvos_tpu_torch.parallel.mesh import FrameShard, shard_time_axis
from tce_rvos_tpu_torch.utils.convert import state_dict_from_jax
from torch_parity_helpers import torch_threads  # noqa: F401 (autouse fixture)
from torch_parity_helpers import (
    FLAGSHIP_TINY,
    OPTIONS_A,
    SLICE_TOL,
    assert_close,
    random_variables,
)

# two decoder layers: the first IQT layer's queries are the same on every
# frame (the sentence embedding), so only from the second on does IQT mix
# what the frames hold
SMALL = dict(enc_layers=1, dec_layers=2, text_encoder_layers=1)
MODELS = {"flagship": dict(FLAGSHIP_TINY, **SMALL), "tokens": dict(OPTIONS_A, **SMALL),
          "msda3d": dict(FLAGSHIP_TINY, msda_3d=True, **SMALL)}
CASES = {  # tag: (model, frames, captions of the one video, dtype)
    "flagship_t4": ("flagship", 4, 1, "float32"),
    "flagship_t3": ("flagship", 3, 1, "float32"),   # 3 frames over 2 ranks: no shard
    "flagship_b2": ("flagship", 4, 2, "float32"),   # two expressions on the batch axis
    "tokens": ("tokens", 4, 1, "float32"),
    "msda3d": ("msda3d", 4, 2, "float32"),
    # float64: the same function up to rounding, so held at F64_TOL
    "flagship_b2_f64": ("flagship", 4, 2, "float64"),
    "msda3d_f64": ("msda3d", 4, 2, "float64"),
}
F64_TOL = {"atol": 1e-11, "rtol": 1e-11}
JAX_CASES = ("flagship_t4", "msda3d")
HW = (64, 96)


def clip_inputs(t: int, captions: int = 1, seed: int = 0) -> dict:
    """One video of ``t`` frames at 64x96, padded at the bottom and the
    right (valid ratios < 1), with ``captions`` captions (the later ones
    shorter)."""
    rng = np.random.RandomState(seed)
    h, w = HW
    mask = np.zeros((1, t, h, w), bool)
    mask[:, :, 56:] = True
    mask[:, :, :, 80:] = True
    ids = rng.randint(3, 50000, (captions, 8)).astype(np.int64)
    attn = np.ones((captions, 8), np.int64)
    attn[1:, 5:] = 0
    ids[1:, 5:] = 1
    return dict(video=rng.randn(1, t, h, w, 3).astype(np.float32), video_mask=mask,
                text_ids=ids, text_attn_mask=attn, sizes=np.asarray([[56, 80]], np.int64))


def jax_inputs(inputs: dict) -> dict:
    return {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
            for k, v in inputs.items()}


def jax_sharded_forward(model, variables, inputs: dict) -> dict:
    """The JAX model's forward with the inputs laid out by its
    ``shard_time_axis`` on a 2-device mesh, jitted."""
    mesh = jax_mesh.make_mesh(2)
    with mesh:
        sharded = jax_mesh.shard_time_axis(jax_inputs(inputs), mesh)
        fwd = jax.jit(lambda v, **kw: {k: model.apply(v, **kw)[k] for k in dryrun.SP_OUTPUTS})
        out = fwd(jax_mesh.replicate(variables, mesh), **sharded)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("frame_shard")
    jax_models = {}
    for name, cfg in MODELS.items():
        model = jax_build_model(JaxModelConfig(**cfg, msda_impl="xla"))
        variables, flat = random_variables(model.init, **jax_inputs(clip_inputs(2)), seed=3)
        torch.save(state_dict_from_jax(flat), root / f"{name}.pt")
        jax_models[name] = (model, variables)
    specs, inputs = {}, {}
    for seed, (tag, (name, t, captions, dtype)) in enumerate(CASES.items()):
        inputs[tag] = clip_inputs(t, captions, seed=seed)
        torch.save(inputs[tag], root / f"{tag}_inputs.pt")
        specs[tag] = {"model": MODELS[name], "device": "cpu", "weights": str(root / f"{name}.pt"),
                      "inputs": str(root / f"{tag}_inputs.pt"), "dtype": dtype}
    import torch_dist_cases

    with ThreadPoolExecutor(len(JAX_CASES) + 1) as pool:
        ranks = pool.submit(dryrun.run_processes, 2, torch_dist_cases.frame_shard_cases,
                            (specs, "flagship_t4"))
        jax_out = {tag: pool.submit(jax_sharded_forward, *jax_models[CASES[tag][0]], inputs[tag])
                   for tag in JAX_CASES}
        jax_out = {tag: f.result() for tag, f in jax_out.items()}
        ranks = ranks.result()
    plain = {tag: dryrun.sp_forward(dict(spec, plain=True)) for tag, spec in specs.items()}
    return dict(specs=specs, inputs=inputs, ranks=ranks, jax=jax_out, plain=plain)


@pytest.mark.parametrize("tag", ["flagship_t4", "flagship_t3"])
def test_shards_are_the_jax_packages(runs, tag):
    """Each rank's ``video`` and ``video_mask`` equal the JAX shard of
    that device of a 2-device mesh; T = 3 stays whole on both; the text
    and the sizes stay whole on every rank."""
    inputs = runs["inputs"][tag]
    mesh = jax_mesh.make_mesh(2)
    sharded = jax_mesh.shard_time_axis(jax_inputs(inputs), mesh)
    t = inputs["video"].shape[1]
    for rank, r in enumerate(runs["ranks"]):
        got = r["inputs"][tag]
        assert got["shard"] == ((rank, 2, 4, 2 * rank, 2) if t == 4 else None)
        for key in ("video", "video_mask"):
            shard = next(s for s in sharded[key].addressable_shards
                         if s.device == mesh.devices[rank])
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(shard.data))
            assert got[key].shape[1] == (2 if t == 4 else 3)
        for key in ("text_ids", "text_attn_mask", "sizes"):
            np.testing.assert_array_equal(got[key].numpy(), inputs[key])


def test_plain_3d_op_takes_fewer_query_frames():
    """Queries of frames [2, 5) of N = 6 over the whole value: bitwise the
    matching rows of the full call; the CUDA wrapper's checks take Nq < N
    in 3D forward only, and a backward launch of such a call raises before
    it reaches the kernel."""
    gen = torch.Generator().manual_seed(0)
    shapes = ((6, 8), (3, 4))
    n, q, m, p = 6, 11, 2, 3
    value = torch.randn(n, sum(h * w for h, w in shapes), m, 32, generator=gen)
    loc = torch.rand(n, q, m, len(shapes), p, 3, generator=gen) * 1.4 - 0.2
    attn = torch.softmax(torch.randn(n, q, m, len(shapes) * p, generator=gen), -1)
    attn = attn.reshape(n, q, m, len(shapes), p)
    full = ms_deform_attn_3d_plain(value, shapes, loc, attn)
    part = ms_deform_attn_3d_plain(value, shapes, loc[2:5], attn[2:5])
    assert part.shape == (3, q, m * 32) and torch.equal(part, full[2:5])
    assert torch.equal(msda_cuda.ms_deform_attn_3d(value, shapes, loc[2:5], attn[2:5]), part)
    msda_cuda._check(value, shapes, loc[2:5].contiguous(), attn[2:5].contiguous(), coords=3)
    with pytest.raises(ValueError, match="sampling_locations"):
        msda_cuda._check(value, shapes, loc[2:5, ..., :2].contiguous(),
                         attn[2:5].contiguous(), coords=2)

    def no_launch(*args):
        raise AssertionError("the backward kernel was reached")

    for grad_rows in (3, n):
        with pytest.raises(NotImplementedError, match="3 query frames over 6"):
            msda_cuda.launch_backward(no_launch, "msda3d_bwd", value, shapes, loc[2:5],
                                      attn[2:5], torch.zeros(grad_rows, q, m * 32))


@pytest.mark.parametrize("tag", list(CASES))
def test_two_ranks_match_one_process(runs, tag):
    """Each rank's gathered logits, boxes and masks against the
    one-process port forward at SP_TOL (F64_TOL in float64); the two ranks
    hold the same."""
    want = runs["plain"][tag]
    ranks = [r["sp"][tag] for r in runs["ranks"]]
    tol = F64_TOL if CASES[tag][3] == "float64" else dryrun.SP_TOL
    for i, got in enumerate(ranks):
        assert got["sharded"] == (tag != "flagship_t3")
        assert got["pred_masks"].dtype == getattr(torch, CASES[tag][3])
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


def test_world_1_is_the_unsharded_forward(runs):
    """A shard of the whole clip, gathered over a group of one rank, gives
    the forward without a shard bitwise; without a group the gather is the
    identity."""
    for r in runs["ranks"]:
        assert r["world1"]["sharded"] and not r["world1_plain"]["sharded"]
        for k in dryrun.SP_OUTPUTS:
            assert torch.equal(r["world1"][k], r["world1_plain"][k]), k
    x = torch.arange(6.0).reshape(3, 2)
    assert collectives.all_gather_frames(x, FrameShard(None, 0, 1, 3, 0, 3)) is x
    _, shard = shard_time_axis({"video_mask": torch.zeros(1, 3, 2, 2)})
    assert shard == FrameShard(None, 0, 1, 3, 0, 3)


def test_gathered_frames_are_the_whole_clips_bitwise(runs):
    """``all_gather_frames`` over the two gloo ranks, which carries every
    dtype as bytes: two clips' frames, f32, bf16 and bool, gathered from
    [b, t, ...] and from [b * t, ...], equal the whole clips bitwise, in
    the one-process b-major layout."""
    for r in runs["ranks"]:
        assert set(r["gather"]) == {"torch.float32", "torch.bfloat16", "torch.bool"}
        for name, (full, clips, flat) in r["gather"].items():
            assert clips.dtype == flat.dtype == full.dtype, name
            assert torch.equal(clips, full), name
            assert torch.equal(flat, full.reshape(-1, *full.shape[2:])), name


@pytest.fixture(scope="module")
def port_model():
    return ReferFormer(ModelConfig(**MODELS["flagship"])).eval()


@pytest.mark.parametrize("case", ["grad", "training", "precomputed_feats", "backbone_only"])
def test_refusals(port_model, case):
    """What the frame-sharded forward refuses, naming it: training (grad
    enabled or training mode) and the serving split, which the JAX package
    never shards (its trainer shards the batch, its engine no time). The
    temporal backbones and ``valid_indices`` it takes
    (``tests/test_torch_frame_shard_backbones.py``)."""
    inputs = {k: torch.as_tensor(v) for k, v in clip_inputs(2).items()}
    shard = FrameShard(None, 0, 1, 2, 0, 2)
    kw = {"precomputed_feats": dict(precomputed_feats=[torch.zeros(2, 8, 4, 4)]),
          "backbone_only": dict(backbone_only=True)}.get(case, {})
    match = {"grad": "frame_shard", "training": "frame_shard"}.get(case, case)
    try:
        port_model.train(case == "training")
        with torch.set_grad_enabled(case == "grad"), pytest.raises(ValueError, match=match):
            port_model(**inputs, frame_shard=shard, **kw)
    finally:
        port_model.eval()

"""What the ranks of the port's multi-process tests run
(tests/test_torch_dp_step.py, tests/test_torch_parallel.py,
tests/test_torch_frame_shard.py, tests/test_torch_frame_shard_backbones.py).

``parallel/dryrun.py::run_processes`` spawns the ranks, which import the
functions of this module by name, so it imports neither JAX nor the test
modules (whose imports would load JAX in every rank).
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch


def averaged_step(rank: int, spec: Dict) -> Dict:
    """The recipe of DistributedDataParallel that the port must not follow:
    every loss divided by the global count of valid frames over the world
    size (the reference's ``num_boxes``), and the gradients averaged over
    the ranks. Right for the losses normalised by ``num_boxes``, it
    weakens the visibility loss (normalised by ``t``) by the world size."""
    from tce_rvos_tpu_torch.models import criterion
    from tce_rvos_tpu_torch.parallel import collectives, dryrun, train_step

    world = collectives.process_count()
    reduce_sum = train_step.all_reduce_gradients

    def averaged(state):
        reduce_sum(state)
        for p in state.model.parameters():
            if p.grad is not None:
                p.grad /= world

    def count_over_world(valid):
        return collectives.all_reduce_sum_(valid.sum().float()).clamp(min=1.0) / world

    criterion.global_num_boxes = count_over_world
    train_step.all_reduce_gradients = averaged
    return dryrun.train_step_on_shard(rank, spec)


def dp_cases(rank: int, specs: Dict[str, Dict]) -> Dict[str, Dict]:
    """``train_step_on_shard`` on each spec (key), then ``averaged_step`` on
    ``specs["summed"]`` (last: it patches the port's modules)."""
    from tce_rvos_tpu_torch.parallel import dryrun

    out = {name: dryrun.train_step_on_shard(rank, spec) for name, spec in specs.items()}
    out["averaged"] = averaged_step(rank, specs["summed"])
    return out


def collective_cases(rank: int, workdir: str) -> Dict:
    """The collectives, the samplers and a checkpoint round trip on this
    rank: each case's result, for the test to hold."""
    from tce_rvos_tpu_torch.data.loader import NodeShardedSampler, ShardedSampler
    from tce_rvos_tpu_torch.parallel import collectives
    from tce_rvos_tpu_torch.utils import native_ckpt

    world = collectives.process_count()
    out: Dict = {"world": world, "rank": collectives.process_index(),
                 "main": collectives.is_main_process()}
    ragged = {"rank": rank, "preds": [{"score": 0.25 * k, "rle": {"size": [2, 3],
                                                                 "counts": "0" * (k + 1)}}
                                      for k in range(3 * rank + 1)]}
    out["gathered"] = collectives.all_gather_objects(ragged)
    out["mean"] = collectives.reduce_dict_mean({"a": float(rank), "b": 1.0 + 2 * rank})
    t = torch.tensor([1.0 + rank, 10.0 * rank])
    out["sum"] = collectives.all_reduce_sum_(t).tolist()
    out["broadcast"] = collectives.broadcast_(torch.tensor([float(rank)])).tolist()

    samplers = {}
    for n in (10, 11):
        s = ShardedSampler(n, shuffle=True, seed=3)
        s.set_epoch(1)
        samplers[f"sharded_{n}"] = list(s)
    os.environ["LOCAL_SIZE"], os.environ["LOCAL_RANK"] = "1", "0"
    node = NodeShardedSampler(10, shuffle=True, seed=3)
    node.set_epoch(2)
    samplers["node_10"] = list(node)
    out["samplers"] = samplers

    path = os.path.join(workdir, "checkpoint")
    sd = {"w": torch.arange(6.0).reshape(2, 3) + rank, "b": torch.tensor([rank])}
    native_ckpt.save_checkpoint(path, sd, {"state": {}, "param_groups": []}, epoch=3, step=7)
    loaded, opt, meta = native_ckpt.load_checkpoint(path)  # right after the barrier
    out["checkpoint"] = {"w": loaded["w"].tolist(), "b": loaded["b"].tolist(),
                         "meta": meta, "has_opt": opt is not None}
    mgr = native_ckpt.CheckpointManager(os.path.join(workdir, "managed"), max_to_keep=1)
    for step in (1, 2):
        mgr.save(step, {"w": torch.full((2,), float(step + rank))}, meta={"epoch": step})
    m_sd, _, m_meta = mgr.restore()
    out["managed"] = {"steps": mgr.all_steps(), "w": m_sd["w"].tolist(), "meta": m_meta}
    return out


def fake_forward(batch) -> Dict[str, torch.Tensor]:
    """Model outputs as a function of each clip alone (its frames' mean
    colour and size), so that a clip's outputs do not depend on the other
    clips of its batch: q = 5 queries, masks at a quarter of the padded
    size, binary logits."""
    video = torch.as_tensor(np.asarray(batch["video"]))  # [b, t, H, W, 3]
    b, t, h, w, _ = video.shape
    g = torch.Generator().manual_seed(0)
    proj = torch.randn(3, 5, generator=g)
    mean = video.mean(dim=(2, 3))                       # [b, t, 3]
    logits = (mean @ proj)[..., None]                   # [b, t, 5, 1]
    yy = torch.linspace(-1, 1, h // 4)[:, None]
    xx = torch.linspace(-1, 1, w // 4)[None, :]
    centre = (mean[..., :2] - 0.5)[..., None, None, None]  # [b, t, 2, 1, 1, 1]
    shift = torch.arange(5.0).view(1, 1, 5, 1, 1) * 0.2
    masks = 2.0 - 8.0 * ((yy - centre[:, :, 0] - shift) ** 2 + (xx - centre[:, :, 1]) ** 2)
    cxcy = torch.sigmoid(mean[..., None, :2] + shift[..., 0])
    boxes = torch.cat([cxcy, 0.1 + 0.2 * torch.sigmoid(mean[..., None, 2:3]).expand(
        b, t, 5, 2)], dim=-1)
    return {"pred_logits": logits, "pred_masks": masks, "pred_boxes": boxes}


def evaluation_cases(rank: int, trees: Dict[str, str], batch_size: int = 2) -> Dict:
    """``evaluate_a2d`` on a JHMDB tree and ``evaluate_coco_pretrain`` (with
    masks) on a RefCOCO tree, over this process's shard (the whole set
    outside a process group), with ``fake_forward``."""
    from tce_rvos_tpu_torch import engine
    from tce_rvos_tpu_torch.config import DataConfig, ModelConfig
    from tce_rvos_tpu_torch.data.loader import PrefetchLoader, ShardedSampler
    from tce_rvos_tpu_torch.data.registry import build_dataset, collate_batch

    def fwd(batch, valid_indices=False):
        out = fake_forward(batch)
        if valid_indices:  # the annotated frame only, as the model keeps it
            idx = torch.as_tensor(np.asarray(batch["valid_indices"])).long()
            out = {k: v[torch.arange(len(idx)), idx][:, None] for k, v in out.items()}
        return out

    def loader(ds):
        return PrefetchLoader(ds, ShardedSampler(len(ds), shuffle=False), batch_size,
                              collate_batch, num_workers=1, drop_last=False)

    mcfg = ModelConfig(num_frames=3, masks=True)
    dcfg = DataConfig(jhmdb_path=trees["jhmdb"], coco_path=trees["coco"])
    jhmdb = build_dataset("jhmdb", "val", dcfg, mcfg)
    refcoco = build_dataset("refcoco", "val", dcfg, ModelConfig(num_frames=1, masks=True))
    return {"a2d": engine.evaluate_a2d(fwd, loader(jhmdb)),
            "coco": engine.evaluate_coco_pretrain(
                fwd, loader(refcoco), refcoco.gt_boxes_by_image(),
                refcoco.coco_gt_by_image(), masks=True)}


def sample_counts(trees: Dict[str, str]) -> List[int]:
    from tce_rvos_tpu_torch.config import DataConfig, ModelConfig
    from tce_rvos_tpu_torch.data.registry import build_dataset

    dcfg = DataConfig(jhmdb_path=trees["jhmdb"], coco_path=trees["coco"])
    return [len(build_dataset("jhmdb", "val", dcfg, ModelConfig(num_frames=3))),
            len(build_dataset("refcoco", "val", dcfg, ModelConfig(num_frames=1)))]


TINY_TEXT = dict(text_encoder_layers=1, text_encoder_hidden=32, text_encoder_heads=2,
                 text_encoder_intermediate=64)


def train_main_cases(rank: int, argv: List[str], out: str) -> Dict:
    """``train.main`` on this rank (a tiny text encoder, as the port's
    command-line tests patch it): one epoch, a resume from ``checkpoint/``
    for a second, then one epoch with ``--ckpt_backend orbax``; each run's
    final parameters and step, on the CPU."""
    import dataclasses

    from tce_rvos_tpu_torch import cli, train

    orig = cli.model_config_from_args
    cli.model_config_from_args = lambda args: dataclasses.replace(orig(args), **TINY_TEXT)

    def params(state):
        return {n: p.detach().clone() for n, p in state.model.named_parameters()}

    runs = {}
    state = train.main(argv + ["--output_dir", out, "--epochs", "1"])
    runs["first"] = {"step": state.step, "params": params(state)}
    state = train.main(argv + ["--output_dir", out, "--epochs", "2", "--resume",
                               os.path.join(out, "checkpoint")])
    runs["resumed"] = {"step": state.step, "params": params(state)}
    orbax_out = out + "_orbax"
    state = train.main(argv + ["--output_dir", orbax_out, "--epochs", "1", "--ckpt_backend",
                               "orbax", "--ckpt_keep", "1"])
    runs["orbax"] = {"step": state.step, "params": params(state),
                     "dirs": sorted(os.listdir(os.path.join(orbax_out, "orbax")))}
    return runs


def frame_shard_cases(rank: int, specs: Dict[str, Dict], bitwise: str) -> Dict:
    """The frame-sharded forward (``parallel/dryrun.py::sp_forward``) of
    each spec over the world; this rank's inputs as ``shard_time_axis``
    cuts them for each spec's inputs; and, in a group of this rank alone
    (world 1), the sharded forward of ``specs[bitwise]`` beside its plain
    forward, for the test to hold bitwise; and ``all_gather_frames`` of
    this rank's frames of two seeded 4-frame clips in f32, bf16 and bool,
    in both layouts, beside the whole clips."""
    import torch.distributed as dist

    from tce_rvos_tpu_torch.parallel import dryrun
    from tce_rvos_tpu_torch.parallel.collectives import all_gather_frames
    from tce_rvos_tpu_torch.parallel.mesh import shard_time_axis

    out: Dict = {"sp": {tag: dryrun.sp_forward(spec) for tag, spec in specs.items()},
                 "inputs": {}}
    for tag, spec in specs.items():
        batch = torch.load(spec["inputs"], weights_only=False)
        local, shard = shard_time_axis({k: torch.as_tensor(batch[k])
                                        for k in dryrun.MODEL_INPUTS})
        out["inputs"][tag] = {"shard": None if shard is None else (
            shard.rank, shard.world, shard.frames, shard.first, shard.count), **local}
    alone = [dist.new_group([r]) for r in range(dist.get_world_size())]  # every rank makes each
    out["world1"] = dryrun.sp_forward(specs[bitwise], group=alone[rank])
    out["world1_plain"] = dryrun.sp_forward(dict(specs[bitwise], plain=True))
    _, shard = shard_time_axis({"video_mask": torch.zeros(1, 4, 1, 1)})
    whole = torch.randn(2, 4, 3, 5, generator=torch.Generator().manual_seed(5))
    out["gather"] = {}
    for dtype in (torch.float32, torch.bfloat16, torch.bool):
        full = whole > 0 if dtype == torch.bool else whole.to(dtype)
        local = full[:, shard.first:shard.first + shard.count]
        out["gather"][str(dtype)] = (
            full, all_gather_frames(local, shard, clip_axis=True),
            all_gather_frames(local.reshape(-1, *full.shape[2:]), shard))
    return out


# (lo, hi) each of two ranks asks for of a 6-frame clip held 3 frames a
# rank: past either end, wider than a rank's frames, empty, its own frames
FRAME_RANGES = (((-3, 5), (1, 9)), ((2, 8), (-4, 2)), ((0, 0), (3, 6)), ((0, 3), (0, 6)))


def frame_shard_backbone_cases(rank: int, specs: Dict[str, Dict],
                               bitwise: List[str]) -> Dict:
    """The frame-sharded forward (``parallel/dryrun.py::sp_forward``) of
    each spec over the world; in a group of this rank alone (world 1) the
    sharded forward of each spec of ``bitwise`` beside its plain forward;
    and the collectives the temporal backbones and ``valid_indices`` use,
    on seeded data: ``gather_frame_range`` of each pair of
    ``FRAME_RANGES`` (this rank's) in f32, bf16 and bool, with fill 0 and
    7; ``all_reduce_sum`` of a bf16 tensor; ``pick_from_owners`` of rows
    each rank fills with its rank."""
    import torch.distributed as dist

    from tce_rvos_tpu_torch.parallel import collectives, dryrun
    from tce_rvos_tpu_torch.parallel.mesh import shard_time_axis

    out: Dict = {"sp": {tag: dryrun.sp_forward(spec) for tag, spec in specs.items()}}
    alone = [dist.new_group([r]) for r in range(dist.get_world_size())]  # every rank makes each
    out["world1"] = {tag: (dryrun.sp_forward(specs[tag], group=alone[rank]),
                           dryrun.sp_forward(dict(specs[tag], plain=True))) for tag in bitwise}
    _, shard = shard_time_axis({"video_mask": torch.zeros(2, 6, 1, 1)})
    whole = torch.randn(2, 6, 3, 4, generator=torch.Generator().manual_seed(7))
    out["ranges"] = []
    for pair in FRAME_RANGES:
        lo, hi = pair[rank]
        for dtype in (torch.float32, torch.bfloat16, torch.bool):
            full = whole > 0 if dtype == torch.bool else whole.to(dtype)
            local = full[:, shard.first:shard.first + shard.count]
            for fill in (0, 7):
                got = collectives.gather_frame_range(local, shard, lo, hi, fill=fill)
                out["ranges"].append(((lo, hi), str(dtype), fill, full, got))
    part = torch.randn(3, 5, generator=torch.Generator().manual_seed(11 + rank)).to(torch.bfloat16)
    out["sum"] = (part, collectives.all_reduce_sum(part, shard))
    rows = [torch.full((3, 2, 2), float(rank)), torch.full((3, 4), rank == 1),
            torch.full((3,), rank + 10, dtype=torch.bfloat16)]
    out["picked"] = collectives.pick_from_owners(rows, torch.tensor([1, 0, 1]), shard)
    return out

"""Multi-process dry run (counterpart of the JAX package's
``__graft_entry__.py::dryrun_multichip``) and the launcher it runs on.

    python -m tce_rvos_tpu_torch.parallel.dryrun --world 2 [--device cpu]

``dryrun`` runs on the GPU unless asked for the CPU (``--device cpu``;
without a GPU it raises, naming it). It starts ``world`` processes
(``run_processes``: gloo on the CPU, NCCL on GPUs, gloo on a GPU shared
by more ranks than there are GPUs, or with ``backend="gloo"``), with TF32
off on the GPU, and checks, on a tiny flagship-shaped model:
  * one train step (f32, dropout off) of each rank on its clip of the batch
    equals the one-process step on the whole batch: the loss at rtol 1e-5,
    the grad norm at rtol 1e-4, every parameter at atol 1e-4 / rtol 1e-3
    (the tolerances of the JAX package's DP test), and every rank holds the
    same parameters afterwards;
  * the evaluators' merge of ragged per-rank shards
    (``collectives.merge_in_sample_order``) gives one process's records;
  * a checkpoint written by rank 0 reads back bitwise on every rank;
  * the frame-sharded forward (the JAX dryrun's "sp inference" step,
    ``mesh.py::shard_time_axis``): the tiny flagship at 1 + 1 layers on one
    32x32 clip of ``world`` frames (one a rank) and of ``2 * world``
    frames, each rank's outputs gathered over the ranks
    (``collectives.all_gather_frames``) and held against the one-process
    forward at ``SP_TOL``.
"""

from __future__ import annotations

import os
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

DP_TOL = {"loss_rtol": 1e-5, "grad_norm_rtol": 1e-4, "param_atol": 1e-4, "param_rtol": 1e-3}
# the frame-sharded forward's gathered outputs against one process's, f32:
# the same function with the attentions' GEMMs at other query lengths, so
# the sums differ in their last bits (the order of DP_TOL's parameter bar).
# atol is a share of the output's largest |value| (at least 1), as
# chip_smoke.py's ``compare`` takes it: at random weights the mask logits
# reach |42| and differ by up to 1.1e-4 where they cancel to 0.02, while
# in float64 the two forwards agree to 1e-13
SP_TOL = {"atol": 1e-4, "rtol": 1e-4}
SP_OUTPUTS = ("pred_logits", "pred_boxes", "pred_masks")
MODEL_INPUTS = ("video", "video_mask", "text_ids", "text_attn_mask", "sizes")


def exact_float32() -> None:
    """float32 means float32 on the GPU: no TF32 in cuDNN or cuBLAS."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _rank_main(rank: int, world: int, workdir: str, device: str, backend: Optional[str],
               target: Callable, args: tuple) -> None:
    from tce_rvos_tpu_torch.parallel.mesh import BACKEND_ENV, init_distributed, shutdown_distributed

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    if backend:
        os.environ[BACKEND_ENV] = backend
    torch.set_num_threads(min(torch.get_num_threads(), 2))
    try:
        init_distributed(device, init_method=f"file://{workdir}/process_group")
        out = target(rank, *args)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise
    finally:
        shutdown_distributed()


def run_processes(world: int, target: Callable, args: Sequence = (), device: str = "cpu",
                  backend: Optional[str] = None, timeout: float = 600.0) -> List[Any]:
    """Run ``target(rank, *args)`` in ``world`` new processes (spawned, so
    ``target`` must be importable by name), each in the process group of
    the others (``mesh.init_distributed`` over a ``file://`` rendezvous in a
    fresh temporary directory), and return their results in rank order. A
    rank that fails raises here with its traceback; every process is
    stopped before this returns."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="tce_dist_") as workdir:
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, workdir, device, backend, target, tuple(args)))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(max(deadline - time.monotonic(), 0.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        for r, p in enumerate(procs):
            err = os.path.join(workdir, f"rank{r}.err")
            if p.exitcode != 0:
                detail = open(err).read() if os.path.exists(err) else "no traceback (killed?)"
                raise RuntimeError(f"rank {r} of {world} exited with {p.exitcode}:\n{detail}")
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


# ---- one data-parallel train step --------------------------------------------------


def shard_of(batch: Dict, rank: int, world: int) -> Dict:
    """Rank ``rank``'s contiguous share of a batch's clips (and targets)."""
    def cut(x):
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        n = len(x) // world
        return x[rank * n:(rank + 1) * n]

    return cut(batch)


def train_step_on_shard(rank: int, spec: Dict) -> Dict:
    """One f32 train step (dropout off) of the model ``spec["model"]`` (a
    ``ModelConfig``'s fields) from the weights at ``spec["weights"]`` on
    this rank's share of the batch at ``spec["batch"]`` (every clip when
    there is no process group), on ``spec["device"]``, with
    ``TrainConfig(**spec.get("train", {}))``. Returns the metrics as floats,
    the parameters after the step and (rank 0) the clipped gradients (the
    flat AdamW's times the clip's factor: its buffer stays unclipped), on
    the CPU."""
    from tce_rvos_tpu_torch.config import ModelConfig, TrainConfig
    from tce_rvos_tpu_torch.models.criterion import criterion_from_configs
    from tce_rvos_tpu_torch.models.referformer import ReferFormer
    from tce_rvos_tpu_torch.parallel import collectives
    from tce_rvos_tpu_torch.parallel.mesh import replicate
    from tce_rvos_tpu_torch.parallel.train_step import create_train_state, make_train_step

    cfg, tcfg = ModelConfig(**spec["model"]), TrainConfig(**spec.get("train", {}))
    model = ReferFormer(cfg)
    model.load_state_dict(torch.load(spec["weights"], map_location="cpu", weights_only=True))
    replicate(model.to(spec["device"]).eval())  # eval: dropout off
    batch = torch.load(spec["batch"], weights_only=False)
    batch = shard_of(batch, rank, collectives.process_count())
    state = create_train_state(model, tcfg, steps_per_epoch=1)
    state, metrics = make_train_step(criterion_from_configs(cfg, tcfg))(state, batch)
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "params": {n: p.detach().cpu() for n, p in model.named_parameters()}}
    if rank == 0:
        scale = state.optimizer.unapplied_clip()
        out["grads"] = {n: (p.grad * scale).cpu() for n, p in model.named_parameters()
                        if p.grad is not None}
    return out


def check_dp_step(got: Dict, want: Dict, label: str) -> Dict:
    """A rank's step (``train_step_on_shard``) against the one-process step
    on the whole batch, at ``DP_TOL``; returns the largest gaps and where
    the parameters' largest is (``param_worst``: name, flat index)."""
    gl, wl = got["metrics"]["loss"], want["metrics"]["loss"]
    gg, wg = got["metrics"]["grad_norm"], want["metrics"]["grad_norm"]
    if not (np.isfinite(gl) and abs(gl - wl) <= DP_TOL["loss_rtol"] * abs(wl)):
        raise AssertionError(f"{label}: loss {gl!r} against {wl!r}")
    if not abs(gg - wg) <= DP_TOL["grad_norm_rtol"] * abs(wg):
        raise AssertionError(f"{label}: grad norm {gg!r} against {wg!r}")
    worst, where = 0.0, None
    for name, p in want["params"].items():
        q = got["params"][name]
        gap = (q.double() - p.double()).abs()
        limit = DP_TOL["param_atol"] + DP_TOL["param_rtol"] * p.double().abs()
        if not bool((gap <= limit).all()):
            raise AssertionError(f"{label}: parameter {name} off by {float(gap.max())!r}")
        if gap.numel() and float(gap.max()) > worst:
            worst, where = float(gap.max()), (name, int(gap.argmax()))
    return {"loss_rel": abs(gl - wl) / abs(wl), "grad_norm_rel": abs(gg - wg) / abs(wg),
            "param_max_abs": worst, "param_worst": where}


# ---- the frame-sharded forward -----------------------------------------------------


def sp_model(spec: Dict):
    """The model ``spec["model"]`` (a ``ModelConfig``'s fields) with the
    weights at ``spec["weights"]``, on ``spec["device"]`` in
    ``spec["dtype"]`` (float32 by default), in eval mode. Built on that
    device: its own initialisation, which the weights overwrite, is the
    device's work."""
    from tce_rvos_tpu_torch.config import ModelConfig
    from tce_rvos_tpu_torch.models.referformer import ReferFormer

    with torch.device(spec["device"]):
        model = ReferFormer(ModelConfig(**spec["model"]))
    model.load_state_dict(torch.load(spec["weights"], map_location="cpu", weights_only=True))
    return model.to(device=spec["device"], dtype=getattr(torch, spec.get("dtype", "float32"))).eval()


def sp_model_inputs(spec: Dict) -> Dict[str, torch.Tensor]:
    """The model inputs at ``spec["inputs"]`` on ``spec["device"]``, the
    video in ``spec["dtype"]`` (as the engine casts it), with
    ``spec["valid_indices"]`` (each clip's annotated frame) if given."""
    batch = torch.load(spec["inputs"], weights_only=False)
    inputs = {k: torch.as_tensor(batch[k]).to(spec["device"]) for k in MODEL_INPUTS}
    inputs["video"] = inputs["video"].to(getattr(torch, spec.get("dtype", "float32")))
    if spec.get("valid_indices") is not None:
        inputs["valid_indices"] = torch.as_tensor(spec["valid_indices"], dtype=torch.long,
                                                  device=spec["device"])
    return inputs


def sp_forward(spec: Dict, group=None) -> Dict:
    """One inference forward of ``sp_model(spec)`` on
    ``sp_model_inputs(spec)``: frame-sharded over the ranks of ``group``
    (the default group; ``mesh.shard_time_axis``) with ``SP_OUTPUTS``
    gathered into the whole clip's, or with ``spec["plain"]`` the
    one-process forward. With ``spec["valid_indices"]`` the outputs hold
    one frame a clip, the same on every rank, and are not gathered.
    Returns the outputs on the CPU and ``sharded``, whether a shard was
    made."""
    from tce_rvos_tpu_torch.parallel.collectives import all_gather_frames
    from tce_rvos_tpu_torch.parallel.mesh import shard_time_axis

    model, inputs = sp_model(spec), sp_model_inputs(spec)
    shard = None
    if not spec.get("plain"):
        inputs, shard = shard_time_axis(inputs, group)
    kept = None if "valid_indices" in inputs else shard  # the frames the outputs hold
    with torch.inference_mode():
        out = model(**inputs, frame_shard=shard)
        res = {k: all_gather_frames(out[k], kept, clip_axis=True).cpu() for k in SP_OUTPUTS}
    res["sharded"] = shard is not None
    return res


def sp_gaps(got: Dict, want: Dict, label: str, tol: Dict = SP_TOL) -> Dict:
    """The largest |difference| of each of ``SP_OUTPUTS`` (shapes equal),
    raising past ``tol`` (``SP_TOL``: atol as a share of the largest
    |reference|, at least 1)."""
    gaps = {}
    for k in SP_OUTPUTS:
        g, w = got[k].double(), want[k].double()
        if g.shape != w.shape:
            raise AssertionError(f"{label}: {k} {tuple(g.shape)} against {tuple(w.shape)}")
        err = (g - w).abs()
        scale = max(float(w.abs().max()), 1.0)
        if not bool((err <= tol["atol"] * scale + tol["rtol"] * w.abs()).all()):
            raise AssertionError(f"{label}: {k} off by {float(err.max())!r} (scale {scale:.3g}, "
                                 f"tolerance {tol})")
        gaps[k] = float(err.max())
    return gaps


# ---- the dry run ------------------------------------------------------------------


TINY = dict(enc_layers=1, dec_layers=2, dim_feedforward=32, binary=True, f_token=2,
            qtrans=True, with_box_refine=True, text_encoder_layers=1, text_encoder_hidden=32,
            text_encoder_heads=2, text_encoder_intermediate=64, num_frames=2, dropout=0.0)


def random_batch(b: int, t: int = 2, hw=(32, 32), seed: int = 0) -> Dict:
    """Model inputs and targets of ``b`` clips, from ``seed``."""
    rng = np.random.RandomState(seed)
    h, w = hw
    c = rng.rand(b, t, 2) * 0.6 + 0.2
    wh = rng.rand(b, t, 2) * 0.35 + 0.05
    return {
        "video": rng.randn(b, t, h, w, 3).astype(np.float32),
        "video_mask": np.zeros((b, t, h, w), bool),
        "text_ids": rng.randint(3, 1000, (b, 8)).astype(np.int64),
        "text_attn_mask": np.ones((b, 8), np.int64),
        "sizes": np.asarray([[h, w]] * b, np.int64),
        "targets": {
            "labels": np.zeros((b, t), np.int64),
            "boxes": np.concatenate([c, wh], -1).astype(np.float32),
            "masks": (rng.rand(b, t, h, w) > 0.5).astype(np.float32),
            "valid": np.ones((b, t), np.int64),
        },
    }


def _merge_and_checkpoint(rank: int, workdir: str, step: Dict) -> Dict:
    """The shard merge on ragged shards, then a checkpoint round trip."""
    from tce_rvos_tpu_torch.parallel import collectives
    from tce_rvos_tpu_torch.utils.native_ckpt import CheckpointManager

    world = collectives.process_count()
    # rank r scored samples r, r + world, ... of an unshuffled sampler over
    # n samples padded to a multiple of world (the pad repeats sample 0)
    n = 2 * world - 1
    order = (list(range(n)) + [0])[rank::world]
    records = [[f"s{i}", {"score": 0.5 + 0.01 * i, "rle": {"size": [4, 4], "counts": "ab" * i}}]
               for i in order]
    merged = collectives.merge_in_sample_order(records)
    want = [[f"s{i}", {"score": 0.5 + 0.01 * i, "rle": {"size": [4, 4], "counts": "ab" * i}}]
            for i in range(n)]
    assert merged == want, f"rank {rank}: shard merge {merged}"
    assert collectives.all_gather_objects(rank) == list(range(world))

    mgr = CheckpointManager(os.path.join(workdir, "ckpt"), max_to_keep=1)
    sd = {k: v.clone() for k, v in step["params"].items()}
    opt = {"state": {0: {"step": torch.tensor(1.0), "exp_avg": sd[next(iter(sd))] * 0.5}},
           "param_groups": [{"lr": 1e-4, "params": [0]}]}
    mgr.save(1, sd, opt, meta={"epoch": 0, "step": 1})
    r_sd, r_opt, meta = mgr.restore()
    assert meta == {"epoch": 0, "step": 1}, meta
    assert all(torch.equal(r_sd[k], sd[k]) for k in sd) and len(r_sd) == len(sd)
    assert torch.equal(r_opt["state"][0]["exp_avg"], opt["state"][0]["exp_avg"])
    return {"merged": len(merged), "checkpoint_tensors": len(r_sd)}


def _dryrun_rank(rank: int, spec: Dict) -> Dict:
    exact_float32()
    step = train_step_on_shard(rank, spec)
    step.update(_merge_and_checkpoint(rank, spec["workdir"], step))
    step["sp"] = {tag: sp_forward(s) for tag, s in spec["sp"].items()}
    return step


def dryrun(world: int = 2, device: str = "cuda", backend: Optional[str] = None,
           model: Optional[Dict] = None, hw=(32, 32), seed: int = 0) -> Dict:
    """The dry run in ``world`` processes (see the module docstring) on
    ``model`` (``ModelConfig`` fields; ``TINY`` by default) with weights
    and a batch of ``world`` clips from ``seed``; returns the gaps of the
    step and what the merge and the checkpoint held, and its seconds."""
    from tce_rvos_tpu_torch.config import ModelConfig
    from tce_rvos_tpu_torch.models.build import build_model
    from tce_rvos_tpu_torch.utils.device import resolve_device

    t0 = time.perf_counter()
    dev = resolve_device(device)
    if dev.type == "cuda":
        exact_float32()
        if backend is None and world > torch.cuda.device_count():
            backend = "gloo"  # ranks sharing a GPU: NCCL takes one rank a GPU
    device = str(dev)

    model = TINY if model is None else model
    sp_model = dict(model, dec_layers=1)  # the JAX dryrun's sp step: 1 + 1 layers
    with tempfile.TemporaryDirectory(prefix="tce_dryrun_") as workdir:
        spec = {"model": model, "device": device, "workdir": workdir,
                "weights": os.path.join(workdir, "weights.pt"),
                "batch": os.path.join(workdir, "batch.pt"), "sp": {}}
        torch.save(build_model(ModelConfig(**model), device="cpu", seed=seed).state_dict(),
                   spec["weights"])
        torch.save(random_batch(world, hw=hw, seed=seed), spec["batch"])
        sp_weights = os.path.join(workdir, "sp_weights.pt")
        torch.save(build_model(ModelConfig(**sp_model), device="cpu", seed=seed).state_dict(),
                   sp_weights)
        for t in (world, 2 * world):  # one frame a rank, then two
            spec["sp"][f"t{t}"] = {"model": sp_model, "device": device, "weights": sp_weights,
                                   "inputs": os.path.join(workdir, f"sp_t{t}.pt")}
            torch.save(random_batch(1, t=t, hw=hw, seed=seed + t), spec["sp"][f"t{t}"]["inputs"])
        want = train_step_on_shard(0, spec)  # one process, the whole batch
        want_sp = {tag: sp_forward(dict(s, plain=True)) for tag, s in spec["sp"].items()}
        ranks = run_processes(world, _dryrun_rank, (spec,), device=device, backend=backend)
    gaps = [check_dp_step(r, want, f"rank {i}") for i, r in enumerate(ranks)]
    for i, r in enumerate(ranks[1:], 1):
        for name, p in ranks[0]["params"].items():
            if not torch.equal(r["params"][name], p):
                raise AssertionError(f"rank {i} holds another {name} than rank 0")
    sp = [{tag: sp_gaps(r["sp"][tag], w, f"rank {i} sp {tag}") for tag, w in want_sp.items()}
          for i, r in enumerate(ranks)]
    if not all(r["sp"][tag]["sharded"] for r in ranks for tag in want_sp):
        raise AssertionError("a rank ran the sp forward without a frame shard")
    return {"world": world, "loss": want["metrics"]["loss"], "gaps": gaps,
            "merged": ranks[0]["merged"], "checkpoint_tensors": ranks[0]["checkpoint_tensors"],
            "sp": sp, "device": device, "backend": backend or ("nccl" if dev.type == "cuda"
                                                             else "gloo"),
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> Dict:
    import argparse
    import json

    p = argparse.ArgumentParser("tce_rvos_tpu_torch multi-process dry run")
    p.add_argument("--world", type=int, default=2)
    p.add_argument("--device", default="cuda", help="cpu runs the ranks on the CPU over gloo")
    p.add_argument("--backend", default=None, help="gloo shares one GPU between the ranks")
    a = p.parse_args(argv)
    res = dryrun(a.world, a.device, a.backend)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()

"""Process groups (counterpart of ``tce_rvos_tpu/parallel/mesh.py``).

The JAX package trains one ``jit`` over the global batch sharded on a 1-D
``data`` mesh, and XLA inserts the gradient psum. The port runs one
process a shard over ``torch.distributed``: each rank's loss is its part
of the global-batch loss (``models/criterion.py`` divides by the global
count of valid frames), and the train step sums the gradients and the
logged losses over the ranks (``parallel/train_step.py``), so that the
update is the global-batch step's.

  * ``init_distributed`` is the counterpart of ``jax.distributed.initialize``
    (the JAX ``train.py`` calls it when ``JAX_COORDINATOR`` is set): a
    launcher's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``, as ``torchrun`` sets them) starts the
    process group;
  * ``replicate`` broadcasts rank 0's parameters and buffers;
  * ``shard_batch`` has no counterpart: each rank's sampler
    (``data/loader.py::ShardedSampler``) hands it its share of the batch;
  * ``shard_time_axis`` cuts one video along its frame axis over the
    ranks (the JAX package's sequence-parallel layout, run by its
    multi-chip dryrun): each rank runs ``ReferFormer.forward(...,
    frame_shard=shard)`` on its contiguous frames. The port has no GSPMD
    to derive the collectives from the sharding, so the model gathers what
    mixes frames itself (``collectives.all_gather_frames``: the keys and
    values of the FTF, ``LastLayerAsToken``, IQT and V-L block attentions
    and the 3D MSDA's value), and the rank's outputs are its frames of the
    one-process forward's.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn

from tce_rvos_tpu_torch.parallel.collectives import (
    broadcast_,
    initialized,
    process_count,
    process_index,
)

BACKEND_ENV = "TCE_DIST_BACKEND"  # overrides the backend (gloo to share one GPU)


def init_distributed(device: Union[str, torch.device, None] = "cuda",
                     init_method: Optional[str] = None) -> int:
    """Join the process group that the environment describes and return
    the world size. Without ``WORLD_SIZE`` in the environment, or with a
    group already up, it starts nothing. The backend is NCCL for ``cuda``
    and gloo for ``cpu`` (``TCE_DIST_BACKEND`` overrides it: two ranks on
    one GPU need gloo); on ``cuda`` the process takes GPU ``LOCAL_RANK``
    (modulo the GPUs present). ``init_method`` defaults to ``env://``
    (``MASTER_ADDR`` and ``MASTER_PORT``); the tests pass ``file://``."""
    if initialized():
        return process_count()
    if "WORLD_SIZE" not in os.environ:
        return 1
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ.get("RANK", 0))
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank))
                              % torch.cuda.device_count())
    backend = os.environ.get(BACKEND_ENV) or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world, rank=rank)
    return world


def shutdown_distributed() -> None:
    if initialized():
        dist.destroy_process_group()


def world_size() -> int:
    return process_count()


@torch.no_grad()
def replicate(model: nn.Module) -> nn.Module:
    """Give every rank rank 0's parameters and buffers (in place)."""
    if initialized():
        for t in (*model.parameters(), *model.buffers()):
            broadcast_(t.data)
    return model


FRAME_INPUTS = ("video", "video_mask")  # the forward's inputs whose axis 1 is the frames


@dataclass(frozen=True)
class FrameShard:
    """One rank's share of a clip's frames under the frame-sharded forward:
    the process ``group`` (None: the default group, or no group at world
    1), this rank's index in it and its size, the clip's frame count
    ``frames`` (T), and this rank's frames ``[first, first + count)``."""

    group: Any
    rank: int
    world: int
    frames: int
    first: int
    count: int


def shard_time_axis(inputs: Dict[str, Any], group=None) -> Tuple[Dict[str, Any],
                                                                   Optional[FrameShard]]:
    """The sequence-parallel layout of one video's inference over the
    ranks of ``group`` (the default process group, or one process outside
    a group): counterpart of ``tce_rvos_tpu/parallel/mesh.py::
    shard_time_axis``, which replaces the reference's 32-frame chunking
    of a video longer than a chip can hold. ``video`` [b, T, H, W, 3] and
    ``video_mask`` [b, T, H, W] are cut along axis 1 into contiguous
    shards, rank r taking frames ``[r T / world, (r + 1) T / world)``;
    returns the rank's inputs and its ``FrameShard``, which
    ``ReferFormer.forward(..., frame_shard=...)`` takes.

    When T does not divide by the world, the JAX package leaves the arrays
    replicated; here every rank then runs the whole clip, with no shard
    (``None``). ``text_ids``, ``text_attn_mask`` and ``sizes`` stay whole
    on every rank: GSPMD may cut them in JAX when their axis 1 happens to
    divide by the mesh, which never changes its result."""
    if group is None:
        world, rank = process_count(), process_index()
    else:
        world, rank = dist.get_world_size(group), dist.get_rank(group)
    frames = int(inputs["video_mask"].shape[1])
    if frames % world:
        return dict(inputs), None
    count = frames // world
    shard = FrameShard(group, rank, world, frames, rank * count, count)
    out = dict(inputs)
    for key in FRAME_INPUTS:
        if inputs.get(key) is not None:
            out[key] = inputs[key][:, shard.first:shard.first + count]
    return out, shard

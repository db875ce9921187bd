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
  * ``shard_time_axis`` (the frame-sharded forward of one long video) is
    not ported: no JAX entry point shards frames, only its multi-chip
    dryrun does.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch
import torch.distributed as dist
from torch import nn

from tce_rvos_tpu_torch.parallel.collectives import broadcast_, initialized, process_count

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

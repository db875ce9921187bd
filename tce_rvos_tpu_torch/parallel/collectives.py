"""Host-level collectives (counterpart of
``tce_rvos_tpu/parallel/collectives.py``), over ``torch.distributed``.

  * ``process_count`` / ``process_index`` / ``is_main_process``: the world
    of ``torch.distributed``, or one process outside it;
  * ``all_reduce_sum_`` and ``broadcast_``: in-place tensor collectives. A
    gloo group reduces host tensors, so a CUDA tensor under gloo is staged
    through the host (two ranks sharing one GPU run over gloo, since NCCL
    takes one rank per GPU);
  * ``encode_object`` / ``decode_object`` / ``gather_encoded`` /
    ``all_gather_objects``: the JAX package's wire format, an object as
    JSON bytes in a uint8 array (no pickle), padded to the longest payload
    and all-gathered, on the device under NCCL and on the host under gloo;
  * ``merge_in_sample_order``: the evaluators' merge of per-sample records;
  * ``reduce_dict_mean`` (logging) and ``barrier``;
  * ``all_gather_frames``: the frame-sharded forward's gather of the
    ranks' frames into the whole clip (``mesh.py::shard_time_axis``).

Outside a process group every function is the one-process identity.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if initialized() else 1


def process_index() -> int:
    return dist.get_rank() if initialized() else 0


def is_main_process() -> bool:
    return process_index() == 0


def barrier() -> None:
    if initialized():
        dist.barrier()


def _host_staged(t: torch.Tensor) -> bool:
    return t.device.type != "cpu" and dist.get_backend() == "gloo"


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over every process, in place (and return it)."""
    if not initialized():
        return t
    if _host_staged(t):
        host = t.cpu()
        dist.all_reduce(host)
        t.copy_(host)
    else:
        dist.all_reduce(t)
    return t


def broadcast_(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Overwrite ``t`` with process ``src``'s, in place (and return it)."""
    if not initialized():
        return t
    if _host_staged(t):
        host = t.cpu()
        dist.broadcast(host, src)
        t.copy_(host)
    else:
        dist.broadcast(t, src)
    return t


def encode_object(obj: Any) -> np.ndarray:
    """Object -> uint8 JSON payload (the wire format of the gather)."""
    return np.frombuffer(json.dumps(obj).encode("utf-8"), np.uint8)


def decode_object(row: np.ndarray, length: int) -> Any:
    """Inverse of encode_object on one (possibly padded) gathered row."""
    return json.loads(bytes(np.asarray(row, np.uint8)[:length]).decode("utf-8"))


def gather_encoded(payload: np.ndarray, gather_fn, n: int) -> List[Any]:
    """Shared pad/gather/decode core: ``gather_fn(arr [L]) -> [n, L]`` is the
    transport (``torch.distributed.all_gather`` here; any stacking of the
    processes' arrays in the tests)."""
    local_len = np.asarray([payload.size], np.int32)
    all_lens = np.asarray(gather_fn(local_len)).reshape(-1)
    max_len = int(all_lens.max())
    padded = np.zeros((max_len,), np.uint8)
    padded[: payload.size] = payload
    gathered = np.asarray(gather_fn(padded))
    return [decode_object(gathered[i], int(all_lens[i])) for i in range(n)]


def _all_gather_array(arr: np.ndarray) -> np.ndarray:
    """[L] from every process -> [n, L] (equal L on every process)."""
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return torch.stack(out).cpu().numpy()


def all_gather_objects(obj: Any) -> List[Any]:
    """One JSON-serializable object per process -> the list of all the
    processes' objects, in rank order (one process: ``[obj]``)."""
    if process_count() == 1:
        return [obj]
    return gather_encoded(encode_object(obj), _all_gather_array, process_count())


def merge_in_sample_order(records: List[list]) -> List[list]:
    """Every process's per-sample records ``[key, ...]``, in its loader's
    order, merged into the order of one process over the whole set: an
    unshuffled ``ShardedSampler`` deals sample ``j * n + r`` to rank ``r``
    as its ``j``-th, so the merge takes the ranks' records round robin. A
    key seen before is dropped: the sampler pads the last ranks with the
    first samples, which one process scores once. (The JAX package
    concatenates the shards, which puts the records in another order and
    keeps the padding's duplicates.)"""
    shards = all_gather_objects(records)
    merged, seen = [], set()
    for j in range(max(len(s) for s in shards)):
        for shard in shards:
            if j < len(shard) and shard[j][0] not in seen:
                seen.add(shard[j][0])
                merged.append(shard[j])
    return merged


def reduce_dict_mean(d: Dict[str, float]) -> Dict[str, float]:
    """Average scalar metrics across processes (logging only), in float32
    as the JAX package averages them."""
    if process_count() == 1:
        return dict(d)
    keys = sorted(d)
    vals = np.asarray([float(d[k]) for k in keys], np.float32)
    mean = _all_gather_array(vals).mean(axis=0)
    return {k: float(v) for k, v in zip(keys, mean)}


def all_gather_frames(x: torch.Tensor, shard, clip_axis: bool = False) -> torch.Tensor:
    """The ranks' frames of ``x`` gathered into the whole clip's, laid out
    as one process lays it out: ``x`` [b * t, ...] (``clip_axis``:
    [b, t, ...]) holds this rank's t = ``shard.count`` frames of each of b
    clips; the result [b * T, ...] ([b, T, ...]) holds rank r's frames at
    ``[first_r, first_r + t)`` of each clip, b-major. Without a shard
    (None) or outside a process group ``x`` is the whole clip and comes
    back as it is. No autograd (the frame-sharded forward is inference
    only). Under gloo a CUDA tensor is staged through the host; under NCCL
    it stays on the device. The ranks' shards are equal
    (``shard_time_axis`` shards only a T that divides by the world)."""
    if shard is None or not initialized():
        return x
    t = shard.count
    if (clip_axis and x.shape[1] != t) or (not clip_axis and x.shape[0] % t):
        raise ValueError(f"all_gather_frames: {tuple(x.shape)} does not hold {t} frames a clip")
    local = x.detach() if clip_axis else x.detach().reshape(-1, t, *x.shape[1:])
    # carried as bytes (gloo takes neither bfloat16 nor bool); the last
    # axis grows by the item size, the frame axis 1 stays
    local = local.contiguous().view(torch.uint8)
    if x.device.type != "cpu" and dist.get_backend(shard.group) == "gloo":
        local = local.cpu()
    parts = [torch.empty_like(local) for _ in range(shard.world)]
    dist.all_gather(parts, local, group=shard.group)
    out = torch.cat(parts, 1).to(x.device).view(x.dtype)
    return out if clip_axis else out.reshape(-1, *out.shape[2:])

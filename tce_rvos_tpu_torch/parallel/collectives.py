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
    ranks' frames into the whole clip (``mesh.py::shard_time_axis``);
  * ``gather_frame_range``: one global frame range of the clip from the
    ranks that hold it (the temporal backbones' window and convolution
    halos); ``all_reduce_sum``: a sum over the ranks in float32 or wider
    (X3D's squeeze-excitation means); ``pick_from_owners``: each clip's
    row from the rank that holds it (``valid_indices``).

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


def spread(shard) -> bool:
    """Whether ``shard`` (a ``mesh.FrameShard`` or None) spreads the clip
    over more than one process: what the frame-sharded forward's modules
    exchange frames for. At world 1 they take the one-process path."""
    return shard is not None and shard.world > 1 and initialized()


def _wire_device(t: torch.Tensor, group) -> torch.device:
    """Where a collective of ``group`` takes ``t``: the host under gloo."""
    return t.device if dist.get_backend(group) != "gloo" else torch.device("cpu")


def _global_rank(shard, r: int) -> int:
    return r if shard.group is None else dist.get_global_rank(shard.group, r)


def gather_frame_range(x: torch.Tensor, shard, lo: int, hi: int, fill: float = 0.0) -> torch.Tensor:
    """Frames ``[lo, hi)`` of the clip, of each of b clips: ``x`` [b, t,
    ...] holds this rank's t = ``shard.count`` frames ``[shard.first,
    shard.first + t)`` (without a shard: the whole clip); returns [b, hi -
    lo, ...], b-major. Frames outside ``[0, T)`` (the range may run past
    either end) are ``fill``. Every rank of the group calls it together,
    each with its own range: the ranks first all-gather the ranges, then
    each sends every other rank the frames it holds of that rank's range
    (point to point), so a range wider than one rank's frames takes them
    from every rank that holds them, and a rank receives only the frames
    it does not hold. Carried as bytes (gloo takes neither bfloat16 nor
    bool; under gloo a CUDA tensor is staged through the host). Without a
    shard, at world 1 or outside a process group it is a slice of ``x``,
    a view when the range lies inside it. No autograd."""
    b, t = x.shape[0], x.shape[1]
    first, frames = (0, t) if shard is None else (shard.first, shard.frames)
    if shard is not None and t != shard.count:
        raise ValueError(f"gather_frame_range: {tuple(x.shape)} does not hold {shard.count} "
                         "frames a clip")
    hi = max(hi, lo)
    inner_lo, inner_hi = max(lo, 0), min(hi, frames)          # the frames that exist
    own_lo, own_hi = max(inner_lo, first), min(inner_hi, first + t)
    received = _receive_frames(x, shard, lo, hi) if spread(shard) else []
    if not received and own_lo == lo and own_hi == hi:
        return x[:, lo - first:hi - first]
    out = x.new_full((b, hi - lo, *x.shape[2:]), fill)
    if own_hi > own_lo:
        out[:, own_lo - lo:own_hi - lo] = x[:, own_lo - first:own_hi - first]
    for a, piece in received:
        out[:, a - lo:a - lo + piece.shape[1]] = piece
    return out


def _receive_frames(x: torch.Tensor, shard, lo: int, hi: int) -> list:
    """``gather_frame_range``'s exchange: [(first frame, [b, n, ...])] of
    the frames of ``[lo, hi)`` that other ranks hold."""
    group, count, frames = shard.group, shard.count, shard.frames
    wire = _wire_device(x, group)
    mine = torch.tensor([lo, hi], dtype=torch.int64, device=wire)
    ranges = [torch.empty_like(mine) for _ in range(shard.world)]
    dist.all_gather(ranges, mine, group=group)
    ranges = [tuple(int(v) for v in r.tolist()) for r in ranges]
    ops, sends, recvs = [], [], []
    for r in range(shard.world):
        if r == shard.rank:
            continue
        peer = _global_rank(shard, r)
        # what rank r asked for of this rank's frames
        a, e = max(ranges[r][0], 0, shard.first), min(ranges[r][1], frames, shard.first + count)
        if e > a:
            piece = x[:, a - shard.first:e - shard.first].detach().contiguous().to(wire)
            sends.append(piece)
            ops.append(dist.P2POp(dist.isend, piece.reshape(-1).view(torch.uint8), peer, group))
        # what this rank asked for of rank r's frames
        a, e = max(lo, 0, r * count), min(hi, frames, (r + 1) * count)
        if e > a:
            buf = torch.empty((x.shape[0], e - a, *x.shape[2:]), dtype=x.dtype, device=wire)
            recvs.append((a, buf))
            ops.append(dist.P2POp(dist.irecv, buf.reshape(-1).view(torch.uint8), peer, group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [(a, buf.to(x.device)) for a, buf in recvs]


def all_reduce_sum(x: torch.Tensor, shard) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``shard``'s group, reduced in
    float32 (or wider: float64 stays float64) whatever ``x``'s dtype, and
    returned in ``x``'s dtype. Without a shard, at world 1 or outside a
    process group: ``x``."""
    if not spread(shard):
        return x
    wide = x.detach().to(device=_wire_device(x, shard.group),
                         dtype=torch.promote_types(x.dtype, torch.float32), copy=True)
    dist.all_reduce(wide, group=shard.group)
    return wide.to(device=x.device, dtype=x.dtype)


def pick_from_owners(tensors: List[torch.Tensor], owners: torch.Tensor,
                     shard) -> List[torch.Tensor]:
    """Row i of each of ``tensors`` (each [b, ...]) as rank ``owners[i]``
    of ``shard``'s group holds it, on every rank: the rows travel as bytes
    in one all-gather and are picked, not computed (bitwise). Without a
    shard, at world 1 or outside a process group: ``tensors``."""
    if not spread(shard):
        return list(tensors)
    b = tensors[0].shape[0]
    wire = _wire_device(tensors[0], shard.group)
    rows = [t.detach().contiguous().reshape(b, -1) for t in tensors]
    packed = torch.cat([r.to(wire).view(torch.uint8) for r in rows], 1)
    parts = [torch.empty_like(packed) for _ in range(shard.world)]
    dist.all_gather(parts, packed, group=shard.group)
    owners = owners.to(device=wire, dtype=torch.long)
    picked = torch.stack(parts)[owners, torch.arange(b, device=wire)]
    out, at = [], 0
    for t, r in zip(tensors, rows):
        n = r.shape[1] * r.element_size()
        own = torch.empty((b, n), dtype=torch.uint8, device=wire).copy_(picked[:, at:at + n])
        out.append(own.view(t.dtype).reshape(t.shape).to(t.device))
        at += n
    return out

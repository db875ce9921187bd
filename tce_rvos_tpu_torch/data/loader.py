"""Host-side data loading (the port's copy of ``tce_rvos_tpu/data/loader.py``):
epoch-seeded sharded samplers and a threaded prefetching loader.

Replaces the reference's torch DataLoader + DistributedSampler stack
(datasets/samplers.py:16-72, main.py:119-131):
  * ``ShardedSampler`` — epoch-seeded shuffle, pad-to-divisible, per-process
    strided shard — same semantics as the reference's DistributedSampler.
    The replicas and the rank are ``torch.distributed``'s when it is
    initialised, else 1 and 0;
  * ``PrefetchLoader`` — a worker thread pool maps __getitem__ + transforms
    while the device computes, a bounded queue provides backpressure
    (replaces num_workers=4 subprocess workers; threads suffice because the
    heavy lifting is numpy, PIL and torch ops, which release the GIL).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np


def _world() -> Tuple[int, int]:
    """(replicas, rank) of ``torch.distributed``, or (1, 0) outside it."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class ShardedSampler:
    def __init__(
        self,
        dataset_len: int,
        shuffle: bool = True,
        seed: int = 0,
        num_replicas: Optional[int] = None,
        rank: Optional[int] = None,
    ):
        if num_replicas is None:
            num_replicas, rank = _world()
        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank or 0
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.num_samples = -(-dataset_len // num_replicas)
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return self.num_samples

    def __iter__(self) -> Iterator[int]:
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            indices = rng.permutation(self.dataset_len).tolist()
        else:
            indices = list(range(self.dataset_len))
        indices += indices[: self.total_size - len(indices)]  # pad
        return iter(indices[self.rank : self.total_size : self.num_replicas])


class NodeShardedSampler:
    """Per-node dataset sharding (reference NodeDistributedSampler,
    datasets/samplers.py:75-139, used with ``--cache_mode``): each sample
    index is owned by the node whose ``local_rank`` equals
    ``index % local_size`` — a host only ever touches (and can therefore
    cache) its own slice of the dataset — and the node's processes then
    stride through that slice. The rank is ``torch.distributed``'s;
    local_rank/local_size describe processes per host (env LOCAL_RANK /
    LOCAL_SIZE, same contract as the reference)."""

    def __init__(
        self,
        dataset_len: int,
        shuffle: bool = True,
        seed: int = 0,
        num_replicas: Optional[int] = None,
        rank: Optional[int] = None,
        local_rank: Optional[int] = None,
        local_size: Optional[int] = None,
    ):
        import os

        if num_replicas is None:
            num_replicas, rank = _world()
        if local_rank is None:
            local_rank = int(os.environ.get("LOCAL_RANK", 0))
        if local_size is None:
            local_size = int(os.environ.get("LOCAL_SIZE", 1))
        self.dataset_len = dataset_len
        self.shuffle = shuffle
        self.seed = seed
        self.num_replicas = num_replicas
        self.num_parts = local_size
        self.rank = rank or 0
        self.local_rank = local_rank
        self.epoch = 0
        self.num_samples = -(-dataset_len // num_replicas)
        self.total_size_parts = self.num_samples * num_replicas // self.num_parts

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return self.num_samples

    def __iter__(self) -> Iterator[int]:
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            indices = rng.permutation(self.dataset_len).tolist()
        else:
            indices = list(range(self.dataset_len))
        indices = [i for i in indices if i % self.num_parts == self.local_rank]
        indices += indices[: self.total_size_parts - len(indices)]
        assert len(indices) == self.total_size_parts
        out = indices[
            self.rank // self.num_parts : self.total_size_parts
            : self.num_replicas // self.num_parts
        ]
        assert len(out) == self.num_samples
        return iter(out)


class PrefetchLoader:
    def __init__(
        self,
        dataset,
        sampler: ShardedSampler,
        batch_size: int,
        collate_fn: Callable,
        num_workers: int = 4,
        prefetch: int = 4,
        drop_last: bool = True,
    ):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.num_workers = max(num_workers, 1)
        self.prefetch = prefetch
        # torch parity (reference main.py:128,148): train batch sampler
        # drops the ragged tail, eval loaders keep it (drop_last=False) so
        # every val sample is scored
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        indices = list(self.sampler)
        end = (
            len(indices) - self.batch_size + 1 if self.drop_last
            else len(indices)
        )
        batches = [
            indices[i : i + self.batch_size]
            for i in range(0, end, self.batch_size)
        ]
        stop = threading.Event()

        def q_put(q, item) -> bool:
            # bounded put that keeps checking stop: a consumer that
            # abandons the iterator mid-epoch (max_steps, eval probes)
            # must not leave workers parked forever in a blocking put,
            # pinning full video batches in memory
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker(batch_list: List[List[int]], q: "queue.Queue"):
            for batch_idx in batch_list:
                if stop.is_set():
                    return
                try:
                    samples = [self.dataset[i] for i in batch_idx]
                    if not q_put(q, ("ok", self.collate_fn(samples))):
                        return
                except Exception as e:  # surface loader errors to the consumer
                    q_put(q, ("err", e))
                    return
            q_put(q, ("done", None))

        # round-robin the batches over worker threads, each with its own
        # queue, and interleave in order to preserve determinism
        qs = [queue.Queue(maxsize=self.prefetch) for _ in range(self.num_workers)]
        threads = []
        for w in range(self.num_workers):
            t = threading.Thread(
                target=worker, args=(batches[w :: self.num_workers], qs[w]),
                daemon=True,
            )
            t.start()
            threads.append(t)
        try:
            done = [False] * self.num_workers
            i = 0
            while not all(done):
                w = i % self.num_workers
                i += 1
                if done[w]:
                    continue
                kind, payload = qs[w].get()
                if kind == "err":
                    raise payload
                if kind == "done":
                    done[w] = True
                    continue
                yield payload
        finally:
            stop.set()

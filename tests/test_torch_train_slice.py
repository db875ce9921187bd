"""The training slice as a whole, the port against the JAX package on the CPU:
for the same seeds the first batch of the port's loader (``YTVOSDataset``
with ``make_train_transform``, ``ShardedSampler``, ``PrefetchLoader`` and
``collate_batch``, as ``train.main`` builds them) equals the JAX loader's
(frames within FRAME_TOL after Normalize, everything else exact), and one
f32 train step of the tiny flagship model with dropout off, from shared
weights, matches between the port on its batch and JAX on its own, at
``check_two_train_steps``' tolerances.
"""

import functools
import random

import numpy as np
import pytest

from tce_rvos_tpu.data import loader as jax_loader
from tce_rvos_tpu.data import registry as jax_registry
from tce_rvos_tpu.data import transforms as jax_tf
from tce_rvos_tpu.data import ytvos as jax_ytvos
from tce_rvos_tpu_torch.data import loader, registry, ytvos
from tce_rvos_tpu_torch.data import transforms as tf
from test_torch_data import FRAME_TOL
from torch_parity_helpers import torch_threads  # noqa: F401 (autouse fixture)
from torch_parity_helpers import T, check_two_train_steps, write_ytvos_tree

MAX_SIZE = 64  # main's buckets, range(128, max_size + 64, 64), are empty: pad to 32


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_ytvos_tree(str(tmp_path_factory.mktemp("ytvos_slice")), n_frames=6,
                            second_object=True)


def first_batch(tree, seed: int, tmod, ymod, lmod, rmod):
    """The first batch of a loader built as ``train.main`` builds it, with
    one Random(seed) for the dataset and its transform (one worker, so the
    draws come in one order)."""
    rng = random.Random(seed)
    ds = ymod.YTVOSDataset(f"{tree}/train", f"{tree}/meta_expressions/train/meta_expressions.json",
                           transforms=tmod.make_train_transform(MAX_SIZE, rng=rng),
                           num_frames=T, rng=rng)
    sampler = lmod.ShardedSampler(len(ds), shuffle=True, seed=seed)
    collate = functools.partial(rmod.collate_batch,
                                hw_buckets=tuple(range(128, MAX_SIZE + 64, 64)))
    it = iter(lmod.PrefetchLoader(ds, sampler, 2, collate, num_workers=1))
    batch = next(it)
    it.close()
    return batch


def assert_batch_equal(got, want):
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(got["video"], want["video"], rtol=0, atol=FRAME_TOL)
    for k in ("video_mask", "text_ids", "text_attn_mask", "sizes", "orig_sizes"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k, v in want["targets"].items():
        assert got["targets"][k].dtype == v.dtype, k
        np.testing.assert_array_equal(got["targets"][k], v, err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_first_batch_matches_jax(tree, seed):
    got = first_batch(tree, seed, tf, ytvos, loader, registry)
    want = first_batch(tree, seed, jax_tf, jax_ytvos, jax_loader, jax_registry)
    assert_batch_equal(got, want)
    assert got["video"].shape[:2] == (2, T) and got["video"].shape[2] % 32 == 0


def test_one_train_step_on_the_loaders_batches(tree):
    port = first_batch(tree, 0, tf, ytvos, loader, registry)
    jax_batch = first_batch(tree, 0, jax_tf, jax_ytvos, jax_loader, jax_registry)
    assert port["targets"]["valid"].sum() > 0
    check_two_train_steps("flagship", batch=port, jax_batch=jax_batch, n_steps=1)

"""The port's multi-process modules on the CPU, over gloo in two spawned
processes (``parallel/dryrun.py::run_processes``): the collectives against
the JAX package's wire format, the samplers, checkpoints written by rank 0
and read by both ranks, the evaluators' merge of the ranks' shards against
one process, and the dry run (``parallel/dryrun.py``). What the ranks run
is in tests/torch_dist_cases.py."""

import json
import os

import numpy as np
import pytest

from tce_rvos_tpu.data import loader as jax_loader
from tce_rvos_tpu.parallel import collectives as jax_coll
from tce_rvos_tpu_torch.data import loader
from tce_rvos_tpu_torch.parallel import collectives, dryrun, mesh
from torch_parity_helpers import torch_threads  # noqa: F401 (autouse fixture)
from torch_parity_helpers import write_jhmdb_tree, write_refexp_tree


def _stacked(payloads):
    """A transport for ``gather_encoded``: process i's array is payloads[i]
    (each encoded, or their lengths), stacked and padded as an all-gather."""
    def gather(arr):
        if arr.dtype == np.int32:
            return np.stack([np.asarray([p.size], np.int32) for p in payloads])
        out = np.zeros((len(payloads), arr.shape[0]), np.uint8)
        for i, p in enumerate(payloads):
            out[i, :p.size] = p
        return out
    return gather


RAGGED = [[{"image_id": 1000 + d * 10 + k, "score": 0.1 * d + 0.01 * k,
            "rle": {"size": [3, 5], "counts": "ab" * (d + 1)}} for k in range(d + 1)]
          for d in range(3)] + [{"unicode": "é ✓", "nested": [1, [2.5, None]]}, []]


@pytest.mark.parametrize("obj", RAGGED, ids=[f"shard{i}" for i in range(len(RAGGED))])
def test_wire_format_is_the_jax_packages(obj):
    got = collectives.encode_object(obj)
    np.testing.assert_array_equal(got, jax_coll.encode_object(obj))
    assert collectives.decode_object(np.pad(got, (0, 7)), got.size) == obj


def test_gather_encoded_matches_jax_on_ragged_shards():
    payloads = [collectives.encode_object(s) for s in RAGGED]
    for d in range(len(RAGGED)):
        got = collectives.gather_encoded(payloads[d], _stacked(payloads), len(RAGGED))
        want = jax_coll.gather_encoded(payloads[d], _stacked(payloads), len(RAGGED))
        assert got == want == RAGGED


def test_one_process_is_the_identity():
    assert collectives.process_count() == mesh.world_size() == 1
    assert collectives.is_main_process() and mesh.init_distributed("cpu") == 1
    assert collectives.all_gather_objects({"a": 1}) == [{"a": 1}]
    assert collectives.reduce_dict_mean({"a": 2.0}) == {"a": 2.0}
    assert collectives.merge_in_sample_order([["x", 1], ["x", 2]]) == [["x", 1]]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    import torch_dist_cases

    return dryrun.run_processes(2, torch_dist_cases.collective_cases,
                                (str(tmp_path_factory.mktemp("ckpt")),))


def test_all_gather_objects_and_reductions_at_world_2(world2):
    for rank, r in enumerate(world2):
        assert (r["world"], r["rank"], r["main"]) == (2, rank, rank == 0)
        assert [g["rank"] for g in r["gathered"]] == [0, 1]
        assert [len(g["preds"]) for g in r["gathered"]] == [1, 4]  # ragged payloads
        assert r["gathered"] == world2[0]["gathered"]
        assert r["mean"] == {"a": 0.5, "b": 2.0}
        assert r["sum"] == [3.0, 10.0] and r["broadcast"] == [0.0]


@pytest.mark.parametrize("name,n", [("sharded_10", 10), ("sharded_11", 11), ("node_10", 10)])
def test_samplers_split_the_epoch_at_world_2(world2, name, n):
    """Each rank's indices are the JAX sampler's for that rank; they are
    disjoint and cover the epoch (11 samples: the pad repeats one)."""
    shards = [r["samplers"][name] for r in world2]
    for rank, got in enumerate(shards):
        if name.startswith("node"):
            want = jax_loader.NodeShardedSampler(n, seed=3, num_replicas=2, rank=rank,
                                                 local_rank=0, local_size=1)
            want.set_epoch(2)
        else:
            want = jax_loader.ShardedSampler(n, seed=3, num_replicas=2, rank=rank)
            want.set_epoch(1)
        assert got == list(want)
    both = shards[0] + shards[1]
    assert sorted(set(both)) == list(range(n))
    if n % 2:
        assert len(both) == n + 1
    else:
        assert len(both) == n and not set(shards[0]) & set(shards[1])


def test_checkpoints_are_written_by_rank_0_and_read_by_both(world2):
    for r in world2:
        ck = r["checkpoint"]
        assert ck["w"] == [[0.0, 1.0, 2.0], [3.0, 4.0, 5.0]] and ck["b"] == [0]  # rank 0's
        assert ck["meta"] == {"epoch": 3, "step": 7} and ck["has_opt"]
        assert r["managed"] == {"steps": [2], "w": [2.0, 2.0], "meta": {"epoch": 2, "step": 2}}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A JHMDB tree of 5 samples and a RefCOCO val split of 5 images (odd:
    the two ranks' sampler pads one)."""
    root = tmp_path_factory.mktemp("trees")
    jhmdb = write_jhmdb_tree(str(root / "jhmdb"), videos=(("pour", "v0", 9), ("pour", "v1", 7),
                                                          ("wave", "v2", 8)))
    meta = os.path.join(jhmdb, "jhmdb_sentences_samples_metadata.json")
    with open(meta) as fh:
        samples = json.load(fh)
    with open(meta, "w") as fh:
        json.dump(samples[:5], fh)
    coco = write_refexp_tree(str(root / "coco"), splits=("val",), n_images=5)
    return {"jhmdb": jhmdb, "coco": coco}


@pytest.fixture(scope="module")
def evaluations(trees):
    import torch_dist_cases

    assert torch_dist_cases.sample_counts(trees) == [5, 5]
    return (torch_dist_cases.evaluation_cases(0, trees),
            dryrun.run_processes(2, torch_dist_cases.evaluation_cases, (trees,)))


@pytest.mark.parametrize("which", ["a2d", "coco"])
def test_evaluators_merged_over_two_processes_equal_one(evaluations, which):
    one, ranks = evaluations
    for r in ranks:
        assert r[which] == one[which]
    if which == "a2d":
        assert 0.0 < one["a2d"]["mean_iou"] < 1.0  # the predictions are not trivial
    else:
        assert one["coco"]["coco_eval_masks"][0] >= 0.0


def test_sample_order_merge_drops_the_padding():
    """``merge_in_sample_order`` with the gather stubbed: three ranks'
    shards of 7 samples padded to 9 (the pad repeats samples 0 and 1)."""
    order = list(range(7)) + [0, 1]
    shards = [[[f"s{i}", i] for i in order[r::3]] for r in range(3)]
    import unittest.mock as mock

    with mock.patch.object(collectives, "all_gather_objects", lambda obj: shards):
        assert collectives.merge_in_sample_order(shards[0]) == [[f"s{i}", i] for i in range(7)]


def test_dryrun_at_world_2():
    res = dryrun.dryrun(world=2, device="cpu")
    assert res["world"] == 2 and np.isfinite(res["loss"])
    assert res["merged"] == 3 and res["checkpoint_tensors"] > 300
    for gap in res["gaps"]:
        assert gap["loss_rel"] <= 1e-5 and gap["param_max_abs"] <= 1e-4
    # the frame-sharded forward at one and two frames a rank, each rank's
    # gathered outputs against one process (held at SP_TOL inside)
    assert len(res["sp"]) == 2
    for sp in res["sp"]:
        assert sorted(sp) == ["t2", "t4"]
        for gaps in sp.values():
            assert sorted(gaps) == sorted(dryrun.SP_OUTPUTS)
            assert all(np.isfinite(g) and g < 1e-2 for g in gaps.values())


def test_samplers_read_the_process_group_world():
    s = loader.ShardedSampler(9)
    assert (s.num_replicas, s.rank) == (1, 0)  # outside a group: one process

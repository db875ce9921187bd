"""The traffic generator: a seed gives the same inputs every time, and every
seed the same multiset of request shapes (or batch shapes), in its own
order, for each mix of the benchmark."""

import collections
import json

import numpy as np
import pytest

import bench_helpers as bh
from harness.traffic import ServeTraffic, train_batches

MIXES = sorted(p.stem for p in (bh.ROOT / "benchmark" / "traffic").glob("*.json"))
SEEDS = (0, 7, 2**31 + 12345, 2**40 + 3)


def small(mix):
    mix = dict(mix)
    if mix["kind"] == "serve":
        mix.update(frame_hw=[24, 40], pool_frames=6)
    else:
        mix.update(frame_hw=[16, 24], pool_batches=3)
    return mix


def load(name):
    return small(json.loads((bh.ROOT / "benchmark" / "traffic" / f"{name}.json").read_text()))


def serve_stream(mix, seed, n):
    t = ServeTraffic(mix, seed, "cpu")
    reqs = [t.request(i) for i in range(n)]
    return t, [(r.frames, r.expressions, r.first, tuple(r.captions)) for r in reqs]


@pytest.mark.parametrize("name", MIXES)
def test_a_seed_gives_the_same_inputs(name):
    mix = load(name)
    for seed in SEEDS[1:3]:
        if mix["kind"] == "serve":
            (a, ra), (b, rb) = serve_stream(mix, seed, 25), serve_stream(mix, seed, 25)
            assert ra == rb
            assert all(np.array_equal(x, y) for x, y in zip(a.pool, b.pool))
        else:
            xa, xb = train_batches(mix, seed, "cpu"), train_batches(mix, seed, "cpu")
            for u, v in zip(xa, xb):
                assert np.array_equal(u["video"], v["video"])
                assert np.array_equal(u["text_ids"], v["text_ids"])
                assert np.array_equal(u["targets"]["masks"], v["targets"]["masks"])


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_gives_the_same_multiset(name):
    mix = load(name)
    if mix["kind"] == "serve":
        shapes, words = [], set()
        for seed in SEEDS:
            t, reqs = serve_stream(mix, seed, 2 * len(ServeTraffic(mix, 0, "cpu").shapes))
            cyc = t.cycle
            for c in range(2):  # each cycle is the whole multiset
                shapes.append(collections.Counter((r[0], r[1]) for r in reqs[c * cyc:(c + 1) * cyc]))
            words |= {len(cap.split()) for r in reqs for cap in r[3]}
        assert all(s == shapes[0] for s in shapes)
        assert words == {mix["caption_words"]}
        orders = {tuple((r[0], r[1]) for r in serve_stream(mix, s, 12)[1]) for s in SEEDS}
        assert len(orders) > 1  # the order is the seed's
    else:
        shapes = {tuple((k, np.shape(v)) for k, v in b.items() if k != "targets")
                  for s in SEEDS for b in train_batches(mix, s, "cpu")}
        assert len(shapes) == 1


def test_the_frames_differ_between_seeds():
    mix = load("clip_e1")
    a, b = ServeTraffic(mix, 1, "cpu"), ServeTraffic(mix, 2, "cpu")
    assert not np.array_equal(a.pool[0], b.pool[0])
    assert a.pool[0].dtype == np.float32 and 0 <= a.pool[0].min() and a.pool[0].max() <= 1

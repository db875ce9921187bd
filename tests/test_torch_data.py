"""The port's data pipeline against the JAX package's, on the CPU.

The same ``random.Random(seed)`` goes to both sides, over several seeds:
each transform, ``make_train_transform``, ``make_val_transform``,
``sample_clip_indices``, ``YTVOSDataset.__getitem__`` (on a synthetic
Ref-YouTube-VOS tree, with frames where an object is absent, so that
``valid = 0`` and the resample-on-empty loop both occur) and
``collate_batch``. Afterwards the generators' states are equal. Masks,
boxes, labels, valid flags, sizes, frame indices, captions and token ids
are exact. Frames agree within FRAME_TOL after Normalize: the JAX package
resizes and converts colours with cv2, the port without it (bilinear
within 2e-7 of cv2 on 720x1280 -> 512x910, hue within 3.1e-5 degrees),
divided by the smallest ImageNet std 0.224, with margin. The samplers and
``PrefetchLoader`` mirror tests/test_data.py.
"""

import random
import threading
import time

import numpy as np
import pytest

from tce_rvos_tpu.data import loader as jax_loader
from tce_rvos_tpu.data import registry as jax_registry
from tce_rvos_tpu.data import transforms as jax_tf
from tce_rvos_tpu.data import ytvos as jax_ytvos
from tce_rvos_tpu_torch.data import loader, registry, ytvos
from tce_rvos_tpu_torch.data import transforms as tf
from torch_parity_helpers import torch_threads  # noqa: F401 (autouse fixture)
from torch_parity_helpers import write_ytvos_tree

FRAME_TOL = 1e-3  # after Normalize
RAW_TOL = FRAME_TOL * float(tf.IMAGENET_STD.min())  # frames in [0, 1]
SEEDS = (0, 1, 2, 3)
EXACT = ("masks", "boxes", "labels", "valid", "size", "orig_size", "frames_idx", "caption")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_ytvos_tree(str(tmp_path_factory.mktemp("ytvos")), n_frames=6,
                            second_object=True)


def _clip(seed: int, hw=(48, 64), t: int = 3):
    """Frames, and a target with moving boxes and masks, one frame invalid."""
    rng = np.random.RandomState(seed)
    h, w = hw
    frames = [rng.rand(h, w, 3).astype(np.float32) for _ in range(t)]
    masks = np.zeros((t, h, w), np.float32)
    boxes = np.zeros((t, 4), np.float32)
    for i in range(t):
        y, x = 8 + 2 * i, 10 + 3 * i
        masks[i, y:y + 20, x:x + 24] = 1
        boxes[i] = [x, y, x + 23, y + 19]
    valid = np.ones(t, np.int64)
    valid[-1] = 0
    target = {"masks": masks, "boxes": boxes, "valid": valid, "labels": np.zeros(t, np.int64),
              "caption": "the left cat right of the dog",
              "size": np.array([h, w], np.int64), "orig_size": np.array([h, w], np.int64)}
    return frames, target


def _copy(frames, target):
    return [f.copy() for f in frames], {k: (v.copy() if isinstance(v, np.ndarray) else v)
                                        for k, v in target.items()}


def assert_sample_equal(got, want, tol: float, where: str):
    (g_frames, g_target), (w_frames, w_target) = got, want
    assert len(g_frames) == len(w_frames), where
    for g, w in zip(g_frames, w_frames):
        assert g.shape == w.shape, where
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=where)
    assert sorted(g_target) == sorted(w_target), where
    for k in EXACT:
        if k in w_target:
            np.testing.assert_array_equal(np.asarray(g_target[k]), np.asarray(w_target[k]),
                                          err_msg=f"{where} {k}")


def _pair(make, seed: int):
    """A transform built on each side around its own Random(seed)."""
    r_port, r_jax = random.Random(seed), random.Random(seed)
    return make(tf, r_port), make(jax_tf, r_jax), r_port, r_jax


TRANSFORMS = {
    "hflip": (lambda m, r: m.RandomHorizontalFlip(0.5, rng=r), RAW_TOL),
    "resize": (lambda m, r: m.RandomResize(m.TRAIN_SCALES, max_size=640, rng=r), RAW_TOL),
    "resize_crop_resize": (lambda m, r: m.Compose([
        m.RandomResize([400, 500, 600], rng=r), m.RandomSizeCrop(384, 600, rng=r),
        m.RandomResize(m.TRAIN_SCALES, max_size=640, rng=r)]), RAW_TOL),
    "photometric": (lambda m, r: m.PhotometricDistort(rng=r), RAW_TOL),
    "normalize": (lambda m, r: m.Normalize(), FRAME_TOL),
    "train": (lambda m, r: m.make_train_transform(640, rng=r), FRAME_TOL),
    "train_max96": (lambda m, r: m.make_train_transform(96, rng=r), FRAME_TOL),
    "val": (lambda m, r: m.make_val_transform(), FRAME_TOL),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(name):
    make, tol = TRANSFORMS[name]
    for seed in SEEDS:
        port, jax_t, r_port, r_jax = _pair(make, seed)
        frames, target = _clip(seed)
        want = jax_t(*_copy(frames, target))
        got = port(*_copy(frames, target))
        assert_sample_equal(got, want, tol, f"{name} seed {seed}")
        assert r_port.getstate() == r_jax.getstate(), name


def test_resize_and_hsv_without_cv2_match_cv2():
    """The two cv2 calls the port replaces, on a 720x1280 frame: bilinear
    resizes (down and up) within 1e-6, nearest mask resizes exact, and the
    HSV round trip at cv2's float convention."""
    import cv2

    rng = np.random.RandomState(0)
    img = rng.rand(720, 1280, 3).astype(np.float32)
    mask = (rng.rand(720, 1280) * 3).astype(np.uint8)
    for h, w in ((512, 910), (288, 512), (47, 63), (1000, 1500)):
        np.testing.assert_allclose(tf._resize_frame(img, (h, w)),
                                   cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR),
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tf._resize_mask(mask, (h, w)),
                                      cv2.resize(mask, (w, h), interpolation=cv2.INTER_NEAREST))
    img[:4] = 0.5            # grey: S = 0
    img[4:8, :, 0] = 0.0     # hue in every sector
    hsv = tf.rgb_to_hsv(img)
    want = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    np.testing.assert_allclose(hsv[..., 0], want[..., 0], rtol=0, atol=1e-3)
    np.testing.assert_allclose(hsv[..., 1:], want[..., 1:], rtol=0, atol=1e-6)
    want[..., 1] *= 1.4      # saturation above 1, as RandomSaturation makes
    want[..., 0] = (want[..., 0] + 17.0) % 360.0
    np.testing.assert_allclose(tf.hsv_to_rgb(want), cv2.cvtColor(want, cv2.COLOR_HSV2RGB),
                               rtol=0, atol=1e-6)


def _outcome(fn, *args, **kw):
    """``fn``'s result, or the type of what it raised (a short video with
    many context frames asks random.sample for more than it holds, on both
    sides)."""
    try:
        return fn(*args, **kw)
    except ValueError as e:
        return type(e)


@pytest.mark.parametrize("keep_fps,vid_aug,f_extra",
                         [(False, False, 0), (False, True, 0), (True, False, 0),
                          (True, True, 0), (False, False, 1), (False, False, 3)])
def test_sample_clip_indices_matches_jax(keep_fps, vid_aug, f_extra):
    for seed in SEEDS:
        r_port, r_jax = random.Random(seed), random.Random(seed)
        for vid_len, num_frames in ((6, 3), (20, 5), (36, 5), (3, 5)):
            if keep_fps and vid_len <= num_frames * 3:
                continue  # keep_fps reads a whole window past the anchor
            for frame_id in range(0, vid_len - (num_frames * 3 if keep_fps else 0), 2):
                args = (frame_id, vid_len, num_frames)
                kw = dict(keep_fps=keep_fps, vid_aug=vid_aug, f_extra=f_extra)
                assert (_outcome(ytvos.sample_clip_indices, *args, r_port, **kw)
                        == _outcome(jax_ytvos.sample_clip_indices, *args, r_jax, **kw))
        assert r_port.getstate() == r_jax.getstate()


def _datasets(tree, seed: int, transform: str = "train", **kw):
    """The port's and the JAX package's YTVOSDataset, each with one
    Random(seed) shared by the dataset and its transform."""
    out = []
    for tmod, ymod in ((tf, ytvos), (jax_tf, jax_ytvos)):
        rng = random.Random(seed)
        t = (tmod.make_train_transform(96, rng=rng) if transform == "train"
             else tmod.make_val_transform(size=64, max_size=96))
        out.append((ymod.YTVOSDataset(f"{tree}/train",
                                      f"{tree}/meta_expressions/train/meta_expressions.json",
                                      transforms=t, rng=rng, **kw), rng))
    return out


@pytest.mark.parametrize("kw", [dict(num_frames=3), dict(num_frames=2, vid_aug=True),
                                dict(num_frames=3, f_extra=1), dict(num_frames=2, keep_fps=True)],
                         ids=["default", "vid_aug", "f_extra", "keep_fps"])
def test_dataset_getitem_matches_jax(tree, kw):
    saw_invalid = False
    for seed in SEEDS[:2]:
        (port, r_port), (jax_ds, r_jax) = _datasets(tree, seed, **kw)
        if kw.get("keep_fps"):
            port.refresh_metas()
            jax_ds.refresh_metas()
        assert len(port) == len(jax_ds) > 0
        assert port.metas == jax_ds.metas
        for idx in range(len(port)):
            np.random.seed(seed * 100 + idx)  # vid_aug's occlusion draws from np.random
            want = jax_ds[idx]
            np.random.seed(seed * 100 + idx)
            got = port[idx]
            assert_sample_equal(([got[0]], got[1]), ([want[0]], want[1]), FRAME_TOL,
                                f"{kw} seed {seed} idx {idx}")
            saw_invalid |= bool((got[1]["valid"] == 0).any())
        assert r_port.getstate() == r_jax.getstate()
    if not kw.get("keep_fps"):
        assert saw_invalid, "no clip with an invisible frame: the tree does not test valid = 0"


def test_dataset_resamples_empty_clips_like_jax(tree):
    """The second object appears in two frames of one video only: its other
    samples must resample, drawing the same replacement index on both
    sides."""
    (port, r_port), (jax_ds, r_jax) = _datasets(tree, 5, transform="val", num_frames=3)
    empty = [i for i, m in enumerate(port.metas) if m["obj_id"] == 3 and m["video"] != "vid_0"]
    assert empty
    for idx in empty:
        before = r_port.getstate()
        got, want = port[idx], jax_ds[idx]
        assert r_port.getstate() != before  # the resample drew
        assert_sample_equal(([got[0]], got[1]), ([want[0]], want[1]), FRAME_TOL, f"idx {idx}")
        assert got[1]["valid"].any()
    assert r_port.getstate() == r_jax.getstate()


def test_collate_batch_matches_jax(tree):
    (port, _), (jax_ds, _) = _datasets(tree, 7, num_frames=3)
    samples = [port[i] for i in range(3)]
    jax_samples = [jax_ds[i] for i in range(3)]
    buckets = tuple(range(128, 96 + 64, 64))
    for kw in ({}, {"hw_buckets": buckets}):
        got = registry.collate_batch(samples, **kw)
        want = jax_registry.collate_batch(samples, **kw)
        assert sorted(got) == sorted(want)
        for k in ("video", "video_mask", "text_ids", "text_attn_mask", "sizes", "orig_sizes"):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in want["targets"]:
            np.testing.assert_array_equal(got["targets"][k], want["targets"][k], err_msg=k)
        # each side's own samples: within the frame tolerance
        own = jax_registry.collate_batch(jax_samples, **kw)
        np.testing.assert_allclose(got["video"], own["video"], rtol=0, atol=FRAME_TOL)
        np.testing.assert_array_equal(got["targets"]["masks"], own["targets"]["masks"])
    assert got["video"].shape[2:4] == (128, 128)


def test_build_dataset_names(tree):
    from tce_rvos_tpu_torch.config import DataConfig, ModelConfig

    ds = registry.build_dataset("ytvos", "train", DataConfig(ytvos_path=tree),
                                ModelConfig(num_frames=2))
    assert len(ds) == 2 * 2 * 3  # 2 videos x 2 expressions x 3 anchors
    davis = registry.build_dataset("davis", "train", DataConfig(davis_path=tree),
                                   ModelConfig(num_frames=2))
    assert davis.category_dict["dog"] == 18
    for name in registry.NOT_PORTED:
        with pytest.raises(ValueError, match="not ported"):
            registry.build_dataset(name, "train", DataConfig(), ModelConfig())
    with pytest.raises(NotImplementedError, match="VidSTG"):
        registry.build_dataset("vidstg", "train", DataConfig(), ModelConfig())
    with pytest.raises(ValueError, match="unknown"):
        registry.build_dataset("nope", "train", DataConfig(), ModelConfig())
    both = registry.ConcatDataset([[1, 2], [3], [4, 5, 6]])
    assert len(both) == 6 and [both[i] for i in range(6)] == [1, 2, 3, 4, 5, 6]


# ---- samplers and the loader (tests/test_data.py:127-229,270-328) ---------------------


def test_sampler_shards_and_seeds_like_jax():
    for n, world in ((10, 2), (37, 4), (5, 1)):
        for rank in range(world):
            s = loader.ShardedSampler(n, seed=1, num_replicas=world, rank=rank)
            js = jax_loader.ShardedSampler(n, seed=1, num_replicas=world, rank=rank)
            for epoch in (0, 1, 2):
                s.set_epoch(epoch)
                js.set_epoch(epoch)
                assert list(s) == list(js) and len(s) == len(js)
    s0 = loader.ShardedSampler(10, seed=1, num_replicas=2, rank=0)
    s1 = loader.ShardedSampler(10, seed=1, num_replicas=2, rank=1)
    assert len(list(s0)) == len(list(s1)) == 5
    assert set(s0) | set(s1) == set(range(10))
    a = list(s0)
    s0.set_epoch(1)
    assert list(s0) != a  # epoch reshuffles
    assert loader._world() == (1, 0)  # torch.distributed is not initialised here
    assert loader.ShardedSampler(10).num_replicas == 1


def test_node_sharded_sampler_like_jax():
    n, world, local_size = 37, 4, 2  # 2 nodes x 2 processes
    all_idx = []
    for rank in range(world):
        kw = dict(shuffle=True, seed=3, num_replicas=world, rank=rank,
                  local_rank=rank % local_size, local_size=local_size)
        idx = list(loader.NodeShardedSampler(n, **kw))
        assert idx == list(jax_loader.NodeShardedSampler(n, **kw))
        assert all(i % local_size == rank % local_size for i in idx), rank
        all_idx.extend(idx)
    assert set(all_idx) == set(range(n))


class _Range:
    def __init__(self, n: int):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return i


def test_prefetch_loader_batches_like_jax():
    for n, batch, workers, drop_last in ((20, 4, 3, True), (10, 4, 2, True),
                                         (10, 4, 2, False), (7, 3, 4, False)):
        sampler = loader.ShardedSampler(n, seed=2, num_replicas=1, rank=0)
        got = loader.PrefetchLoader(_Range(n), sampler, batch, list, num_workers=workers,
                                    drop_last=drop_last)
        want = jax_loader.PrefetchLoader(_Range(n), sampler, batch, list, num_workers=workers,
                                         drop_last=drop_last)
        assert len(got) == len(want)
        assert list(got) == list(want)
    val = loader.PrefetchLoader(_Range(10), loader.ShardedSampler(10, shuffle=False), 4, list,
                                num_workers=2, drop_last=False)
    assert [len(b) for b in val] == [4, 4, 2]


def test_prefetch_loader_surfaces_errors_and_stops_workers():
    class Bad(_Range):
        def __getitem__(self, i):
            if i == 5:
                raise KeyError("sample 5")
            return i

    sampler = loader.ShardedSampler(8, shuffle=False, num_replicas=1, rank=0)
    with pytest.raises(KeyError, match="sample 5"):
        list(loader.PrefetchLoader(Bad(8), sampler, 1, list, num_workers=2))

    big = loader.PrefetchLoader(_Range(64), loader.ShardedSampler(64, shuffle=False), 1, list,
                                num_workers=2, prefetch=2)
    before = threading.active_count()
    it = iter(big)
    next(it), next(it)
    it.close()  # abandon: the generator's finally sets stop
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before, "loader workers leaked"

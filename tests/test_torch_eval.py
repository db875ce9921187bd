"""The port's evaluation metrics and postprocessors against the JAX
package's, on the CPU, on inputs made from a seed with numpy.

  * the RLE (``utils/rle.py``): bitwise, all-zero, all-one and 0x0 masks
    included (the JAX package may take its C fast path; the port's numpy
    path must give the same strings and counts);
  * the A2D/JHMDB metrics, ``RefExpEvaluator`` and ``CocoEvaluator``
    (bbox and segm, crowd and area-range rules): the same numbers, within
    1e-6;
  * DAVIS J&F: the port's boundary map and its k-d tree boundary match
    against the JAX package's dilation (cv2.dilate where cv2 is installed)
    and scipy's, the statistics, the Hungarian matching and
    ``evaluate_davis`` on a synthetic tree;
    ``eval_davis``'s CSVs byte for byte against the JAX command line's
    (pandas) and its "precomputed results" short cut;
  * the postprocessors on the same model outputs: scores and boxes within
    1e-6, the A2D device masks equal except where the mask logit lies
    within 1e-5 of 0 (the two frameworks' bilinear resizes round
    differently), the host masks, their RLE strings and the COCO masks
    equal.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tce_rvos_tpu import eval_davis as jax_eval_davis
from tce_rvos_tpu.eval import a2d_eval as jax_a2d_eval
from tce_rvos_tpu.eval import coco_eval as jax_coco_eval
from tce_rvos_tpu.eval import davis_eval as jax_davis_eval
from tce_rvos_tpu.eval import refexp_eval as jax_refexp_eval
from tce_rvos_tpu.models import postprocessors as jax_pp
from tce_rvos_tpu.utils import rle as jax_rle
from tce_rvos_tpu_torch import eval_davis
from tce_rvos_tpu_torch.eval import a2d_eval, coco_eval, davis_eval, refexp_eval
from tce_rvos_tpu_torch.models import postprocessors as pp
from tce_rvos_tpu_torch.utils import rle
from torch_parity_helpers import torch_threads  # noqa: F401 (autouse fixture)

METRIC_TOL = 1e-6


def _blobs(rng, h, w, n=3):
    """A binary mask of ``n`` random rectangles and discs."""
    m = np.zeros((h, w), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(n):
        cy, cx = rng.randint(0, max(h, 1)), rng.randint(0, max(w, 1))
        r = rng.randint(1, max(2, min(h, w) // 3))
        if rng.rand() < 0.5:
            m[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 1
        else:
            m[max(cy - r, 0): cy + r, max(cx - r, 0): cx + r] = 1
    return m


MASKS = {
    "zeros": np.zeros((7, 5), np.uint8),
    "ones": np.ones((6, 9), np.uint8),
    "empty": np.zeros((0, 0), np.uint8),
    "one_pixel": np.ones((1, 1), np.uint8),
    "first_on": np.pad(np.ones((1, 1), np.uint8), ((0, 3), (0, 2))),
    "blobs": _blobs(np.random.RandomState(0), 48, 64, 5),
    "noise": (np.random.RandomState(1).rand(33, 17) > 0.5).astype(np.uint8),
    "large": _blobs(np.random.RandomState(2), 240, 320, 8),
}


@pytest.mark.parametrize("name", sorted(MASKS))
def test_rle_bitwise(name):
    m = MASKS[name]
    counts = rle.encode_counts(m)
    assert counts == list(jax_rle.encode_counts(m))
    enc = rle.encode(m)
    want = jax_rle.encode(m)
    assert enc == {"size": want["size"], "counts": want["counts"]}
    assert rle._compress_counts(counts) == jax_rle._compress_counts(counts)
    assert rle._decompress_counts(enc["counts"]) == list(jax_rle._decompress_counts(enc["counts"]))
    for r in (enc, {"size": enc["size"], "counts": enc["counts"].encode("ascii")},
              {"size": enc["size"], "counts": counts}):
        np.testing.assert_array_equal(rle.decode(r), jax_rle.decode(r))
        np.testing.assert_array_equal(rle.decode(r), m)
        assert rle.area(r) == jax_rle.area(r) == int(m.sum())
    other = rle.encode(np.roll(m, 1, axis=-1)) if m.size else enc
    assert rle.iou(enc, other) == jax_rle.iou(enc, other)


def test_rle_counts_with_long_runs_and_large_differences():
    # runs past 2^5, 2^10 and 2^15: the 6-bit groups, their sign bit and the
    # difference from the count two before
    for counts in ([0, 70000, 3, 1, 40000, 2], [5, 1, 1, 31, 32, 1023, 1024, 33000, 1]):
        s = rle._compress_counts(counts)
        assert s == jax_rle._compress_counts(counts)
        assert rle._decompress_counts(s) == counts


def _a2d_case(seed: int, n_images: int = 6, q: int = 5, hw=(24, 32)):
    """GT RLEs for ``n_images`` images and ``q`` scored predictions each,
    some close to the GT, one image without predictions."""
    rng = np.random.RandomState(seed)
    gt, preds = {}, []
    for i in range(n_images):
        g = _blobs(rng, *hw, n=2)
        gt[f"img{i}"] = jax_rle.encode(g)
        if i == n_images - 1:
            continue
        for k in range(q):
            p = g.copy() if k == 0 else _blobs(rng, *hw, n=2)
            if k == 1:
                p = np.roll(g, rng.randint(1, 4), axis=1)
            preds.append({"image_id": f"img{i}", "score": float(rng.rand()),
                          "rle": jax_rle.encode(p)})
    preds.append({"image_id": "unknown", "score": 0.99, "rle": preds[0]["rle"]})
    return gt, preds


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_a2d_metrics_match_jax(seed):
    gt, preds = _a2d_case(seed)
    got, want = a2d_eval.calculate_map(gt, preds), jax_a2d_eval.calculate_map(gt, preds)
    assert sorted(got) == sorted(want) == ["AP 0.5", "AP 0.75", "mAP 0.5:0.95"]
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=METRIC_TOL), k
    (p_got, o_got, m_got) = a2d_eval.calculate_precision_at_k_and_iou_metrics(gt, preds)
    (p_want, o_want, m_want) = jax_a2d_eval.calculate_precision_at_k_and_iou_metrics(gt, preds)
    np.testing.assert_allclose(p_got, p_want, rtol=0, atol=METRIC_TOL)
    assert o_got == pytest.approx(o_want, abs=METRIC_TOL)
    assert m_got == pytest.approx(m_want, abs=METRIC_TOL)
    # the ground truth scored against itself
    own = [{"image_id": k, "score": 1.0, "rle": v} for k, v in gt.items()]
    assert a2d_eval.calculate_map(gt, own)["mAP 0.5:0.95"] == 1.0
    assert a2d_eval.calculate_precision_at_k_and_iou_metrics(gt, own)[1:] == (1.0, 1.0)


def _boxes(rng, n, hw=(100, 120)):
    h, w = hw
    xy = rng.rand(n, 2) * [w * 0.7, h * 0.7]
    wh = rng.rand(n, 2) * [w * 0.3, h * 0.3] + 2
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_refexp_evaluator_matches_jax(seed):
    rng = np.random.RandomState(seed)
    gt = {i: _boxes(rng, rng.randint(1, 3)) for i in range(8)}
    preds = {}
    for i in range(7):  # image 7 has no prediction
        b = _boxes(rng, 10)
        if i % 2 == 0:
            b[rng.randint(0, 10)] = gt[i][0] + rng.rand(4) * 2
        preds[i] = {"scores": rng.rand(10).astype(np.float32), "boxes": b}
    got_ev, want_ev = refexp_eval.RefExpEvaluator(gt), jax_refexp_eval.RefExpEvaluator(gt)
    got_ev.update(preds)
    want_ev.update(preds)
    got, want = got_ev.summarize(), want_ev.summarize()
    assert sorted(got) == sorted(want) == ["P@1", "P@10", "P@5"]
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=METRIC_TOL), k
    a, b = _boxes(rng, 6), _boxes(rng, 4)
    np.testing.assert_allclose(refexp_eval._iou_xyxy(a, b), jax_refexp_eval._iou_xyxy(a, b),
                               rtol=0, atol=METRIC_TOL)


def _coco_case(seed: int, hw=(60, 80)):
    """GT annotations with boxes, areas across the small/medium/large
    ranges, a crowd region and RLE segmentations; predictions with boxes,
    masks and scores (up to 12 a image, some matching a GT)."""
    rng = np.random.RandomState(seed)
    h, w = hw
    gt, preds = {}, {}
    for img in range(5):
        anns = []
        for k in range(rng.randint(1, 4)):
            m = _blobs(rng, h, w, n=1)
            ys, xs = np.nonzero(m)
            if not len(ys):
                continue
            x0, y0 = xs.min(), ys.min()
            box = [float(x0), float(y0), float(xs.max() - x0 + 1), float(ys.max() - y0 + 1)]
            scale = [1.0, 40.0, 200.0][k % 3]   # areas in each COCO range
            anns.append({"bbox": box, "area": float(m.sum()) * scale,
                         "iscrowd": int(k == 2 and img % 2 == 0),
                         "segmentation": jax_rle.encode(m), "_mask": m})
        gt[img] = anns
        n = rng.randint(3, 12)
        masks = np.stack([_blobs(rng, h, w, n=1) for _ in range(n)])
        boxes = _boxes(rng, n, hw)
        for j, a in enumerate(anns[:2]):
            masks[j] = a["_mask"]
            x, y, bw, bh = a["bbox"]
            boxes[j] = [x + 0.5, y, x + bw, y + bh - 0.5]
        preds[img] = {"scores": rng.rand(n).astype(np.float32), "boxes": boxes,
                      "masks": masks[:, None]}
    for anns in gt.values():
        for a in anns:
            del a["_mask"]
    return gt, preds


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coco_evaluator_matches_jax(seed):
    gt, preds = _coco_case(seed)
    got_ev = coco_eval.CocoEvaluator(gt, iou_types=("bbox", "segm"))
    want_ev = jax_coco_eval.CocoEvaluator(gt, iou_types=("bbox", "segm"))
    got_ev.update(preds)
    want_ev.update(preds)
    got_ev.update(preds)  # an image seen twice counts once
    got, want = got_ev.summarize(), want_ev.summarize()
    for t in ("bbox", "segm"):
        assert list(got[t]) == list(want[t]) == list(coco_eval.STAT_NAMES)
        np.testing.assert_allclose(got_ev.stats(t), want_ev.stats(t), rtol=0, atol=METRIC_TOL,
                                   err_msg=t)
    # ground truth scored against itself: AP 1 for boxes and masks
    own = {i: {"scores": np.ones(len(a), np.float32),
               "boxes": np.array([[x, y, x + bw, y + bh] for x, y, bw, bh in
                                  (b["bbox"] for b in a)], np.float32).reshape(-1, 4),
               "rle_masks": [b["segmentation"] for b in a]} for i, a in gt.items()}
    ev = coco_eval.CocoEvaluator(gt, iou_types=("bbox", "segm"))
    ev.update(own)
    assert ev.summarize()["bbox"]["AP"] == pytest.approx(1.0)
    assert ev.summarize()["segm"]["AP"] == pytest.approx(1.0)
    with pytest.raises(ValueError):
        coco_eval.CocoEvaluator(gt, iou_types=("keypoints",))


def _davis_masks(seed: int, n_obj=2, t=6, hw=(40, 56)):
    rng = np.random.RandomState(seed)
    gt = np.stack([np.stack([_blobs(rng, *hw, n=1) for _ in range(t)]) for _ in range(n_obj)])
    res = gt.copy()
    res[0, 1] = np.roll(res[0, 1], 3, axis=1)
    res[1, 2:] = 0
    return gt.astype(bool), res.astype(bool), rng


def test_davis_metrics_match_jax():
    gt, res, rng = _davis_masks(0)
    void = rng.rand(*gt.shape[1:]) > 0.95
    for i in range(gt.shape[1]):
        np.testing.assert_array_equal(davis_eval.seg2bmap(gt[0, i]),
                                      jax_davis_eval.seg2bmap(gt[0, i]))
    for v in (None, np.broadcast_to(void, gt.shape[1:])):
        np.testing.assert_allclose(davis_eval.db_eval_iou(gt[0], res[0], v),
                                   jax_davis_eval.db_eval_iou(gt[0], res[0], v), atol=0)
        for bound_th in (0.008, 3):
            np.testing.assert_allclose(
                davis_eval.db_eval_boundary(gt[0], res[0], v, bound_th),
                jax_davis_eval.db_eval_boundary(gt[0], res[0], v, bound_th), atol=0)
    assert davis_eval.db_eval_iou(np.zeros((4, 4)), np.zeros((4, 4))) == 1.0
    for case in (np.zeros((2, 4, 4), bool), np.ones((1, 4, 4), bool)):
        np.testing.assert_array_equal(davis_eval.db_eval_boundary(case, case[::-1]),
                                      jax_davis_eval.db_eval_boundary(case, case[::-1]))
    values = rng.rand(11)
    values[3] = np.nan
    assert davis_eval.db_statistics(values) == jax_davis_eval.db_statistics(values)
    j, f = davis_eval.evaluate_unsupervised(gt, res[::-1])
    j_want, f_want = jax_davis_eval.evaluate_unsupervised(gt, res[::-1])
    np.testing.assert_array_equal(j, j_want)
    np.testing.assert_array_equal(f, f_want)
    j, f = davis_eval.evaluate_unsupervised(gt, res[:1])  # fewer proposals than objects
    np.testing.assert_array_equal(j, jax_davis_eval.evaluate_unsupervised(gt, res[:1])[0])


@pytest.mark.parametrize("seed", [0, 1])
def test_boundary_match_equals_dilation(seed):
    from scipy import ndimage

    rng = np.random.RandomState(seed)
    for trial in range(150):
        h, w = rng.randint(1, 70), rng.randint(1, 70)
        a, b = (rng.rand(h, w) > rng.rand() for _ in range(2))
        if trial % 3 == 0:
            a = np.zeros((h, w), bool)
            a[rng.randint(h):, rng.randint(w):] = True
        for bound_th in (0.008, 0.05, 2, 3.7):
            assert davis_eval.f_measure(a, b, None, bound_th) == jax_davis_eval.f_measure(
                a, b, None, bound_th), (trial, bound_th)
        # the match itself: boundary pixels of a inside b's boundary dilated by the disk
        r = int(rng.randint(0, 6))
        ba, bb = davis_eval.seg2bmap(a), davis_eval.seg2bmap(b)
        disk = jax_davis_eval._disk(r)
        want = int((ba & ndimage.binary_dilation(bb, disk)).sum())
        assert davis_eval._within(np.argwhere(ba), np.argwhere(bb), r) == want


def _png(path, arr):
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    img = Image.fromarray(arr.astype(np.uint8), mode="P")
    img.putpalette([c for i in range(256) for c in (i, 3 * i % 256, 7 * i % 256)])
    img.save(path)


def write_davis_tree(root, seqs=("bear", "car,turn"), t=6, hw=(40, 56), seed=0):
    """A DAVIS 2017 root (ImageSets/2017/val.txt, Annotations_unsupervised
    palette PNGs with 2 objects and a void border) and a results parent
    with anno_0 and anno_1 (palette PNGs: the first the annotations with
    one object moved, the second with one object missing). Returns
    (davis root, results parent)."""
    rng = np.random.RandomState(seed)
    davis, results = os.path.join(root, "davis"), os.path.join(root, "results")
    os.makedirs(os.path.join(davis, "ImageSets", "2017"))
    with open(os.path.join(davis, "ImageSets", "2017", "val.txt"), "w") as fh:
        fh.write("\n".join(seqs) + "\n")
    for seq in seqs:
        for i in range(t):
            lab = np.zeros(hw, np.uint8)
            lab[_blobs(rng, *hw, n=1) > 0] = 1
            lab[_blobs(rng, *hw, n=1) > 0] = 2
            lab[0, :] = 255
            name = f"{i:05d}.png"
            _png(os.path.join(davis, "Annotations_unsupervised", "480p", seq, name), lab)
            a0 = lab.copy()
            a0[a0 == 255] = 0
            a0 = np.where(a0 == 1, 0, a0)
            a0[np.roll(lab == 1, 2, axis=0)] = 1
            a1 = np.where(lab == 2, 0, lab % 255)
            _png(os.path.join(results, "anno_0", seq, name), a0)
            _png(os.path.join(results, "anno_1", seq, name), a1)
    return davis, results


def test_evaluate_davis_matches_jax(tmp_path):
    davis, results = write_davis_tree(str(tmp_path))
    for anno in ("anno_0", "anno_1"):
        got = davis_eval.evaluate_davis(davis, os.path.join(results, anno))
        want = jax_davis_eval.evaluate_davis(davis, os.path.join(results, anno))
        assert got["summary"] == want["summary"]
        for k in ("J", "F"):
            assert got[k] == want[k]
    # the annotations (void label 255 as background) scored against themselves: J&F 1
    from PIL import Image

    own = os.path.join(str(tmp_path), "own")
    anno = os.path.join(davis, "Annotations_unsupervised", "480p")
    for seq in os.listdir(anno):
        for name in os.listdir(os.path.join(anno, seq)):
            lab = np.array(Image.open(os.path.join(anno, seq, name)))
            _png(os.path.join(own, seq, name), lab % 255)
    assert davis_eval.evaluate_davis(davis, own)["summary"]["J&F-Mean"] == 1.0


def test_eval_davis_csvs_bytewise(tmp_path, capsys):
    davis, results = write_davis_tree(str(tmp_path / "port"))
    jax_davis, jax_results = write_davis_tree(str(tmp_path / "jax"))
    means = eval_davis.main(["--davis_path", davis, "--results_path", results])
    jax_eval_davis.main(["--davis_path", jax_davis, "--results_path", jax_results])
    for anno in ("anno_0", "anno_1"):
        for name in ("global_results-val.csv", "per-sequence_results-val.csv"):
            with open(os.path.join(results, anno, name), "rb") as fh:
                got = fh.read()
            with open(os.path.join(jax_results, anno, name), "rb") as fh:
                assert got == fh.read(), (anno, name)
    assert len(means) == 2 and all(0 <= m <= 1 for m in means)
    with open(os.path.join(results, "anno_1", "per-sequence_results-val.csv")) as fh:
        assert '"car,turn_1"' in fh.read()  # quoted like pandas
    out = capsys.readouterr().out
    assert f"Mean J&F over 2 annotators: {np.mean(means):.5f}" in out
    # a second run reads the CSVs back
    again = eval_davis.main(["--davis_path", davis, "--results_path", results])
    assert "Using precomputed results..." in capsys.readouterr().out
    np.testing.assert_allclose(again, means, rtol=0, atol=5e-6)
    # one annotator directory given directly
    one = eval_davis.main(["--davis_path", davis,
                           "--results_path", os.path.join(results, "anno_0")])
    assert one == [again[0]]


def test_csv_fields_like_pandas():
    import pandas as pd

    table = {"Sequence": ["a", "b,c", 'd"e'], "J-Mean": [0.123456789, np.nan, -0.0],
             "F-Mean": [1.0, 2.5e-7, np.float64(3)]}
    got = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"csv_port_{os.getpid()}.csv")
    want = got.replace("port", "pandas")
    try:
        eval_davis.write_csv(got, table)
        pd.DataFrame(table).to_csv(want, index=False, float_format="%.5f")
        with open(got, "rb") as a, open(want, "rb") as b:
            assert a.read() == b.read()
        back = eval_davis.read_csv(got)
        assert back["Sequence"] == table["Sequence"] and np.isnan(back["J-Mean"][1])
    finally:
        for p in (got, want):
            if os.path.exists(p):
                os.remove(p)


def _outputs(seed: int, b=2, t=1, q=5, hw=(12, 16)):
    rng = np.random.RandomState(seed)
    return {"pred_logits": rng.randn(b, t, q, 1).astype(np.float32),
            "pred_boxes": (rng.rand(b, t, q, 4) * 0.5 + 0.2).astype(np.float32),
            "pred_masks": (3 * rng.randn(b, t, q, *hw)).astype(np.float32)}


def _near_zero_logit(masks, up_shape, tol=1e-5):
    """Pixels of the 4x bilinear upsample of ``masks`` [..., h, w] whose
    logit lies within ``tol`` of 0 (float64, align_corners=False)."""
    x = torch.from_numpy(masks.astype(np.float64))
    lead = x.shape[:-2]
    up = torch.nn.functional.interpolate(x.reshape(-1, 1, *x.shape[-2:]), size=up_shape,
                                         mode="bilinear", align_corners=False)
    return (up.abs() <= tol).reshape(*lead, *up_shape).numpy()


def test_a2d_postprocess_matches_jax():
    out = _outputs(0)
    dev = pp.a2d_device_postprocess({k: torch.from_numpy(v) for k, v in out.items()})
    want = jax_pp.a2d_device_postprocess({k: jnp.asarray(v) for k, v in out.items()})
    np.testing.assert_allclose(dev["scores"].numpy(), np.asarray(want["scores"]), rtol=0,
                               atol=METRIC_TOL)
    near = _near_zero_logit(out["pred_masks"][:, 0], (48, 64))
    assert not ((dev["masks"].numpy() != np.asarray(want["masks"])) & ~near).any()
    sizes, orig = [(40, 60), (48, 64)], [(30, 45), (96, 128)]
    got = pp.a2d_host_postprocess(dev, sizes, orig)
    # the JAX host half on the port's device half: the same masks and RLEs
    want = jax_pp.a2d_host_postprocess({k: v.numpy() for k, v in dev.items()}, sizes, orig)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["scores"], w["scores"])
        np.testing.assert_array_equal(g["masks"], w["masks"])
        assert g["rle_masks"] == w["rle_masks"]
    assert got[0]["masks"].shape == (5, 30, 45)


@pytest.mark.parametrize("t", [1, 2])
def test_coco_postprocess_matches_jax(t):
    out = _outputs(1, t=t)
    target = np.array([[100, 140], [60, 64]])
    max_sizes = np.array([[40, 56], [48, 64]])
    got = pp.coco_postprocess_bbox({k: torch.from_numpy(v) for k, v in out.items()}, target)
    want = jax_pp.coco_postprocess_bbox(out, target)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0, atol=METRIC_TOL)
        np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=1e-6, atol=1e-4)
        np.testing.assert_array_equal(g["labels"], w["labels"])
    got = pp.coco_postprocess_segm(got, out, target, max_sizes)
    want = jax_pp.coco_postprocess_segm(want, out, target, max_sizes)
    q = out["pred_logits"].shape[2] * t
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["masks"].shape == w["masks"].shape == (q, 1, *target[i])
        assert g["masks"].dtype == w["masks"].dtype == np.uint8
        np.testing.assert_array_equal(g["masks"], w["masks"])

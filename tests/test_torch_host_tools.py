"""The port's host tools against the JAX package's on tiny trees:
``data/coco.py::CocoDetection`` (samples and ``coco_gt_by_image``), the
dataset converters ``tools/convert_davis_to_ytvos.py`` and
``tools/convert_refexp_to_coco.py`` (their output trees, also through
their command lines), and the exporter of ``utils/profiling.py`` on the
CPU (``tests/test_torch_tracing.py`` holds its spans and counters)."""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from tce_rvos_tpu.data import coco as jax_coco
from tce_rvos_tpu.tools import convert_davis_to_ytvos as jax_davis_conv
from tce_rvos_tpu.tools import convert_refexp_to_coco as jax_refexp_conv
from tce_rvos_tpu_torch.data import coco
from tce_rvos_tpu_torch.tools import convert_davis_to_ytvos, convert_refexp_to_coco
from tce_rvos_tpu_torch.utils import profiling
from torch_parity_helpers import torch_threads  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_coco_tree(root, hw=(40, 56), seed: int = 0):
    """images/*.png and instances.json: polygons, a box partly outside the
    image (clipped), a degenerate box (dropped), a crowd RLE annotation and
    an image without annotations."""
    from PIL import Image

    from tce_rvos_tpu_torch.utils import rle

    rng = np.random.RandomState(seed)
    h, w = hw
    os.makedirs(os.path.join(root, "images"))
    images, anns = [], []
    for i in range(3):
        name = f"img{i}.png"
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(
            os.path.join(root, "images", name))
        images.append({"id": 10 + i, "file_name": name, "height": h, "width": w})
    poly = [[5.2, 4.0, 30.7, 6.1, 28.0, 25.5, 8.4, 22.0]]
    anns.append({"id": 1, "image_id": 10, "category_id": 3, "bbox": [5.2, 4.0, 25.5, 21.5],
                 "segmentation": poly, "iscrowd": 0, "area": 400.0})
    anns.append({"id": 2, "image_id": 10, "category_id": 7, "bbox": [40.0, 30.0, 30.0, 20.0],
                 "segmentation": [[40, 30, 55.9, 30, 55.9, 39.9, 40, 39.9]], "iscrowd": 0})
    anns.append({"id": 3, "image_id": 11, "category_id": 1, "bbox": [10.0, 10.0, 0.0, 5.0],
                 "segmentation": [[10, 10, 10, 15, 10, 12]], "iscrowd": 0})
    crowd = np.zeros((h, w), np.uint8)
    crowd[2:12, 30:50] = 1
    anns.append({"id": 4, "image_id": 11, "category_id": 1, "bbox": [30, 2, 20, 10],
                 "segmentation": rle.encode(crowd), "iscrowd": 1, "area": 200})
    with open(os.path.join(root, "instances.json"), "w") as fh:
        json.dump({"images": images, "annotations": anns, "categories": []}, fh)
    return root


def _assert_same(got, want, where=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=where)
        assert np.asarray(got).dtype == want.dtype, where
    else:
        assert got == want, where


@pytest.mark.parametrize("return_masks", [True, False])
def test_coco_detection_matches_jax(tmp_path, return_masks):
    root = write_coco_tree(str(tmp_path))
    args = (os.path.join(root, "images"), os.path.join(root, "instances.json"))
    port = coco.CocoDetection(*args, return_masks=return_masks)
    want = jax_coco.CocoDetection(*args, return_masks=return_masks)
    assert len(port) == len(want) == 3 and port.ids == want.ids
    for i in range(len(port)):
        (g_frames, g_t), (w_frames, w_t) = port[i], want[i]
        np.testing.assert_array_equal(g_frames, w_frames)
        _assert_same(g_t, w_t, f"sample {i}")
    assert "masks" in port[0][1] if return_masks else "masks" not in port[0][1]
    assert port[0][1]["boxes"][1].tolist() == [40.0, 30.0, 56.0, 40.0]  # clipped
    assert len(port[1][1]["boxes"]) == 0  # degenerate box dropped, crowd skipped
    _assert_same(port.coco_gt_by_image(), want.coco_gt_by_image(), "gt")


def write_davis_download(root, seed: int = 0):
    """A Ref-DAVIS17 download: DAVIS/JPEGImages/480p, Annotations/480p,
    ImageSets/2017/{train,val}.txt and davis_text_annotations (one full-video
    file, one first-frame file)."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    for split, videos in (("train", ["bear", "dog"]), ("val", ["cows"])):
        sets = os.path.join(root, "DAVIS", "ImageSets", "2017")
        os.makedirs(sets, exist_ok=True)
        with open(os.path.join(sets, f"{split}.txt"), "w") as fh:
            fh.write("\n".join(videos) + "\n")
        for v, video in enumerate(videos):
            img_dir = os.path.join(root, "DAVIS", "JPEGImages", "480p", video)
            ann_dir = os.path.join(root, "DAVIS", "Annotations", "480p", video)
            os.makedirs(img_dir)
            os.makedirs(ann_dir)
            for f in range(3):
                Image.fromarray((rng.rand(12, 16, 3) * 255).astype(np.uint8)).save(
                    os.path.join(img_dir, f"{f:05d}.jpg"))
                m = np.zeros((12, 16), np.uint8)
                m[2:6, 3:9] = 1
                m[7:10, 10:14] = 2 + v
                m[0, 0] = 255
                Image.fromarray(m, mode="L").save(os.path.join(ann_dir, f"{f:05d}.png"))
    text = os.path.join(root, "davis_text_annotations")
    os.makedirs(text)
    with open(os.path.join(text, "Davis17_annot1_full_video.txt"), "w", encoding="latin-1") as fh:
        fh.write('bear 1 "a brown bear walking"\ndog 2 "the dog on the right"\nbad line\n'
                 'cows 1 "a cow caf\xe9"\n')
    with open(os.path.join(text, "Davis17_annot2.txt"), "w", encoding="latin-1") as fh:
        fh.write('bear 1 "the bear"\n')
    return root


def _tree(root):
    """Every file under ``root`` (symlinks followed) -> its bytes."""
    out = {}
    for dirpath, _, files in os.walk(root, followlinks=True):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.mark.parametrize("symlink", [True, False])
def test_davis_converter_matches_jax(tmp_path, symlink):
    src = write_davis_download(str(tmp_path / "src"))
    convert_davis_to_ytvos.convert(src, str(tmp_path / "port"), symlink=symlink)
    jax_davis_conv.convert(src, str(tmp_path / "jax"), symlink=symlink)
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert got == want and len(got) > 20
    meta = json.loads(got[os.path.join("meta_expressions", "train", "meta_expressions.json")])
    assert meta["videos"]["bear"]["expressions"]["1"] == {"exp": "the bear", "obj_id": "1"}
    assert os.path.islink(tmp_path / "port" / "train" / "JPEGImages" / "bear") == symlink


def write_refer_download(root):
    """A REFER release: refcoco/refs(unc).p and instances.json."""
    os.makedirs(os.path.join(root, "refcoco"))
    instances = {
        "images": [{"id": 5, "file_name": "a.jpg", "height": 10, "width": 12},
                   {"id": 6, "file_name": "b.jpg", "height": 10, "width": 12}],
        "annotations": [{"id": 50, "image_id": 5, "bbox": [1, 1, 4, 4], "category_id": 1},
                        {"id": 60, "image_id": 6, "bbox": [2, 2, 3, 3], "category_id": 2}],
        "categories": [{"id": 1, "name": "person"}, {"id": 2, "name": "dog"}]}
    refs = [{"split": "train", "ann_id": 50, "image_id": 5,
             "sentences": [{"sent": "left man"}, {"sent": "the person"}]},
            {"split": "val", "ann_id": 60, "image_id": 6, "sentences": [{"sent": "a dog"}]},
            {"split": "testA", "ann_id": 50, "image_id": 5, "sentences": [{"sent": "man"}]}]
    with open(os.path.join(root, "refcoco", "instances.json"), "w") as fh:
        json.dump(instances, fh)
    with open(os.path.join(root, "refcoco", "refs(unc).p"), "wb") as fh:
        pickle.dump(refs, fh)
    return root


def test_refexp_converter_matches_jax(tmp_path):
    src = write_refer_download(str(tmp_path / "src"))
    convert_refexp_to_coco.convert(src, str(tmp_path / "port"))
    jax_refexp_conv.convert(src, str(tmp_path / "jax"))
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert got == want
    train = json.loads(got["instances_refcoco_train.json"])
    assert [i["caption"] for i in train["images"]] == ["left man", "the person"]


def test_converters_command_lines(tmp_path):
    src = write_refer_download(str(tmp_path / "refer"))
    davis = write_davis_download(str(tmp_path / "davis"))
    for module, args in (("convert_refexp_to_coco", ["--data_root", src, "--output_root",
                                                     str(tmp_path / "coco")]),
                         ("convert_davis_to_ytvos", ["--data_root", davis, "--output_root",
                                                     str(tmp_path / "ytvos"), "--copy"])):
        res = subprocess.run([sys.executable, "-m", f"tce_rvos_tpu_torch.tools.{module}", *args],
                             cwd=REPO, capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr
    assert (tmp_path / "coco" / "instances_refcoco_val.json").exists()
    assert not os.path.islink(tmp_path / "ytvos" / "valid" / "JPEGImages" / "cows")


def test_trace_writes_a_chrome_trace_with_the_annotated_span(tmp_path):
    with profiling.trace(str(tmp_path / "trace")) as prof:
        assert profiling.enabled()
        with profiling.span("tce_step", 1):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None and not profiling.enabled()
    with open(tmp_path / "trace" / profiling.TRACE_FILE) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "tce_step" for e in events)
    assert any(e.get("name") == "aten::mm" for e in events)
    with open(tmp_path / "trace" / profiling.SPANS_FILE) as fh:
        spans = json.load(fh)["spans"]
    assert [(s["name"], s["units"]) for s in spans] == [("tce_step", 1)]

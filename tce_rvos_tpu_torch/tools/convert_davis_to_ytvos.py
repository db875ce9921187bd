"""Convert a Ref-DAVIS17 download into the Ref-YouTube-VOS directory layout
(capability parity with reference tools/data/convert_davis_to_ytvos.py):
split DAVIS/JPEGImages/480p + Annotations by ImageSets/2017/{train,val}.txt
into <out>/{train,valid}/{JPEGImages,Annotations}, build meta.json and
meta_expressions.json from the Davis17 language annotations
(Davis17_annot1.txt .. 4, both raw and full-video re-annotations).

Uses copies/symlinks instead of the reference's shell ``mv`` (non-destructive).


The port's copy of ``tce_rvos_tpu/tools/convert_davis_to_ytvos.py``, with its
command line:

    python -m tce_rvos_tpu_torch.tools.convert_davis_to_ytvos --help
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
from collections import defaultdict


def read_split_set(data_root: str):
    base = os.path.join(data_root, "DAVIS/ImageSets/2017")
    with open(os.path.join(base, "train.txt")) as fh:
        train = [x.strip() for x in fh if x.strip()]
    with open(os.path.join(base, "val.txt")) as fh:
        val = [x.strip() for x in fh if x.strip()]
    return train, val


def _link_tree(src: str, dst: str, symlink: bool = True):
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    if os.path.exists(dst):
        return
    if symlink:
        os.symlink(os.path.abspath(src), dst)
    else:
        shutil.copytree(src, dst)


def read_expressions(data_root: str):
    """Davis17 annotator files: lines '<video> <obj_id> "<expression>"'."""
    out = defaultdict(lambda: defaultdict(dict))  # video -> exp_id -> dict
    exp_counter = defaultdict(int)
    for anno_id in range(1, 5):
        path = os.path.join(
            data_root, "davis_text_annotations", f"Davis17_annot{anno_id}_full_video.txt"
        )
        if not os.path.exists(path):
            path = os.path.join(
                data_root, "davis_text_annotations", f"Davis17_annot{anno_id}.txt"
            )
        if not os.path.exists(path):
            continue
        with open(path, encoding="latin-1") as fh:
            for line in fh:
                parts = line.strip().split(maxsplit=2)
                if len(parts) != 3:
                    continue
                video, obj_id, exp = parts
                exp = exp.strip('"')
                eid = str(exp_counter[video])
                exp_counter[video] += 1
                out[video][eid] = {"exp": exp, "obj_id": obj_id}
    return out


def convert(data_root: str, output_root: str, symlink: bool = True):
    train_set, val_set = read_split_set(data_root)
    expressions = read_expressions(data_root)

    for split_name, videos in (("train", train_set), ("valid", val_set)):
        meta = {"videos": {}}
        meta_exp = {"videos": {}}
        for video in videos:
            img_src = os.path.join(data_root, "DAVIS/JPEGImages/480p", video)
            ann_src = os.path.join(data_root, "DAVIS/Annotations/480p", video)
            _link_tree(img_src, os.path.join(output_root, split_name, "JPEGImages", video), symlink)
            _link_tree(ann_src, os.path.join(output_root, split_name, "Annotations", video), symlink)
            frames = sorted(
                os.path.splitext(f)[0]
                for f in os.listdir(img_src)
                if f.endswith(".jpg")
            )
            from PIL import Image
            import numpy as np

            first_ann = os.path.join(ann_src, frames[0] + ".png")
            objs = {}
            if os.path.exists(first_ann):
                ids = np.unique(np.array(Image.open(first_ann)))
                for oid in ids:
                    if oid in (0, 255):
                        continue
                    objs[str(int(oid))] = {"category": "object", "frames": frames}
            meta["videos"][video] = {"objects": objs}
            meta_exp["videos"][video] = {
                "frames": frames,
                "expressions": expressions.get(video, {}),
            }
        os.makedirs(os.path.join(output_root, split_name), exist_ok=True)
        with open(os.path.join(output_root, split_name, "meta.json"), "w") as fh:
            json.dump(meta, fh)
        os.makedirs(os.path.join(output_root, "meta_expressions", split_name), exist_ok=True)
        with open(
            os.path.join(output_root, "meta_expressions", split_name, "meta_expressions.json"),
            "w",
        ) as fh:
            json.dump(meta_exp, fh)


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--data_root", default="data/ref-davis")
    p.add_argument("--output_root", default="data/ref-davis")
    p.add_argument("--copy", action="store_true", help="copy instead of symlink")
    a = p.parse_args()
    convert(a.data_root, a.output_root, symlink=not a.copy)

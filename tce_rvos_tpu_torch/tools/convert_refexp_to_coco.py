"""Convert RefCOCO/RefCOCO+/RefCOCOg (REFER pickle releases) into per-split
COCO-format json with one annotation per referred object and the expression
in image['caption'] (capability parity with reference
tools/data/convert_refexp_to_coco.py).

The port's copy of ``tce_rvos_tpu/tools/convert_refexp_to_coco.py``, with its
command line:

    python -m tce_rvos_tpu_torch.tools.convert_refexp_to_coco --help
"""

from __future__ import annotations

import argparse
import json
import os
import pickle


def convert(data_root: str, output_root: str, dataset: str = "refcoco",
            dataset_split: str = "unc"):
    dataset_dir = os.path.join(data_root, dataset)
    os.makedirs(output_root, exist_ok=True)

    with open(os.path.join(dataset_dir, f"refs({dataset_split}).p"), "rb") as fh:
        refs = pickle.load(fh)
    with open(os.path.join(dataset_dir, "instances.json")) as fh:
        instances = json.load(fh)
    anns = {a["id"]: a for a in instances["annotations"]}
    imgs = {i["id"]: i for i in instances["images"]}

    by_split = {}
    next_img_id = 0
    next_ann_id = 0
    for ref in refs:
        split = ref["split"]
        out = by_split.setdefault(
            split,
            {"images": [], "annotations": [], "categories": instances["categories"]},
        )
        ann = anns[ref["ann_id"]]
        img = imgs[ref["image_id"]]
        for sent in ref["sentences"]:
            image_entry = dict(img)
            image_entry["id"] = next_img_id
            image_entry["original_id"] = img["id"]
            image_entry["caption"] = sent["sent"]
            out["images"].append(image_entry)
            ann_entry = dict(ann)
            ann_entry["id"] = next_ann_id
            ann_entry["image_id"] = next_img_id
            out["annotations"].append(ann_entry)
            next_img_id += 1
            next_ann_id += 1

    for split, payload in by_split.items():
        path = os.path.join(output_root, f"instances_{dataset}_{split}.json")
        with open(path, "w") as fh:
            json.dump(payload, fh)
        print(f"wrote {path}: {len(payload['images'])} expressions")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--data_root", default="data/coco")
    p.add_argument("--output_root", default="data/coco")
    p.add_argument("--dataset", default="refcoco",
                   choices=["refcoco", "refcoco+", "refcocog"])
    p.add_argument("--dataset_split", default="unc")
    a = p.parse_args()
    convert(a.data_root, a.output_root, a.dataset, a.dataset_split)

"""COCO detection -> panoptic format converter.

    python3 -m quber_tpu_torch.data.detection2panoptic --json instances.json \
        --out-json panoptic.json --out-dir panoptic_pngs/

The port's copy of tools/detection2panoptic.py, with the same flags: each
image's instance masks (COCO RLEs) are painted in order into an id map
(later instances over earlier ones, ids from 1), written as a panoptic PNG
(data/png.py; datasets.id2rgb colours), and a panoptic JSON with the
images, their segments_info and the categories. Polygon segmentations
wait for a polygon fill (ROADMAP.md Queue 1 item 11d).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from quber_tpu_torch.data import png, rle
from quber_tpu_torch.data.datasets import id2rgb


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--json", required=True)
    parser.add_argument("--out-json", required=True)
    parser.add_argument("--out-dir", required=True)
    args = parser.parse_args(argv)

    with open(args.json) as f:
        coco = json.load(f)
    os.makedirs(args.out_dir, exist_ok=True)
    by_image: dict = {}
    for ann in coco["annotations"]:
        by_image.setdefault(ann["image_id"], []).append(ann)

    pan_annotations = []
    for img in coco["images"]:
        h, w = img["height"], img["width"]
        panoptic = np.zeros((h, w), np.uint32)
        segments_info = []
        for j, ann in enumerate(by_image.get(img["id"], []), start=1):
            seg = ann["segmentation"]
            if not isinstance(seg, dict):
                raise NotImplementedError(
                    f"image {img['id']}: polygon segmentations are not converted by the port "
                    "(ROADMAP.md Queue 1 item 11d); give the masks as COCO RLEs")
            mask = rle.decode(seg)
            panoptic[mask > 0] = j
            segments_info.append({
                "id": j,
                "category_id": ann.get("category_id", 1),
                "iscrowd": ann.get("iscrowd", 0),
                "area": int(mask.sum()),
            })
        png_name = os.path.basename(os.path.splitext(img["file_name"])[0] + ".png")
        png.imwrite(os.path.join(args.out_dir, png_name), id2rgb(panoptic))
        pan_annotations.append({"image_id": img["id"], "file_name": png_name,
                                "segments_info": segments_info})

    out = {
        "images": coco["images"],
        "annotations": pan_annotations,
        "categories": coco.get("categories", [{"id": 1, "name": "object", "isthing": 1}]),
    }
    with open(args.out_json, "w") as f:
        json.dump(out, f)
    print(f"wrote {args.out_json} and {len(pan_annotations)} PNGs to {args.out_dir}")


if __name__ == "__main__":
    main()

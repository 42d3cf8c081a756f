"""Offline quadruple-error-map generator.

    python3 -m quber_tpu_torch.data.panoptic2eee --json train_panoptic_perturbed.json \
        --panoptic-root panoptic_pngs/ [--out updated.json]

The port's copy of tools/panoptic2eee.py, with the same flags: for each
image with perturbed masks, the GT masks of its panoptic PNG against the
perturbed ones give the eight TP/TN/FP/FN mask and boundary maps
(data/eee.compute_eee_maps), written as RLEs into the images[] records
(keys tp_mask ... fn_boundary).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from quber_tpu_torch.data import rle
from quber_tpu_torch.data.datasets import read_image, rgb2id
from quber_tpu_torch.data.eee import compute_eee_maps


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--json", required=True)
    parser.add_argument("--panoptic-root", required=True)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    with open(args.json) as f:
        coco = json.load(f)
    anns = {a["image_id"]: a for a in coco.get("annotations", [])}
    for i, img in enumerate(coco["images"]):
        ann = anns.get(img["id"])
        if ann is None or "perturbed_segmentation" not in img:
            continue
        pan_path = os.path.join(args.panoptic_root,
                                ann.get("file_name", img["file_name"]).replace(".jpg", ".png"))
        panoptic = rgb2id(read_image(pan_path))
        gt = np.asarray([(panoptic == seg["id"]).astype(np.uint8)
                         for seg in ann["segments_info"]])
        pert = np.asarray([rle.decode(r) for r in img["perturbed_segmentation"]])
        for key, value in compute_eee_maps(gt, pert).items():
            img[key] = rle.encode(value.astype(np.uint8))
        if (i + 1) % 100 == 0:
            print(f"{i + 1}/{len(coco['images'])}")

    out = args.out or args.json
    with open(out, "w") as f:
        json.dump(coco, f)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()

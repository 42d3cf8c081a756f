"""Turn an OSD-layout dataset into a UOAIS-Sim-layout refiner training set
with the port's offline tools.

    python3 -m quber_tpu_torch.data.make_synthetic_dataset --out datasets/synth_osd --n 64
    python3 -m quber_tpu_torch.data.make_uoais_sim --osd datasets/synth_osd \
        --data-root datasets/uoais_synth [--seed 7]

Writes, under <data-root>/UOAIS-Sim/: train/color/*.png and
train/depth/*.png (copies of the frames), a COCO instance JSON with one RLE
per labelled object, then runs detection2panoptic (panoptic PNGs in
train/panoptic_annos), perturbate_masks (Felzenszwalb-seeded, from the
colour images) and panoptic2eee, ending in
annotations/coco_anns_panoptic_uoais_sim_train_perturbed.json: what
data/datasets.py registers as uoais_sim_train_panoptic under --data-root.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

import numpy as np

from quber_tpu_torch.data import detection2panoptic, panoptic2eee, perturbate_masks, png, rle


def write_instances(osd_root: str, split_dir: str) -> dict:
    """Copy the OSD frames under split_dir/{color,depth} and return the COCO
    instance JSON of their labels."""
    names = sorted(os.listdir(os.path.join(osd_root, "image_color")))
    for sub in ("color", "depth"):
        os.makedirs(os.path.join(split_dir, sub), exist_ok=True)
    images, annotations = [], []
    for i, name in enumerate(names, start=1):
        shutil.copyfile(os.path.join(osd_root, "image_color", name),
                        os.path.join(split_dir, "color", name))
        shutil.copyfile(os.path.join(osd_root, "disparity", name),
                        os.path.join(split_dir, "depth", name))
        label = png.imread(os.path.join(osd_root, "annotation", name))
        h, w = label.shape
        images.append({"id": i, "file_name": f"color/{name}", "depth_file_name": f"depth/{name}",
                       "height": h, "width": w})
        for k in np.unique(label[label > 0]):
            mask = (label == k).astype(np.uint8)
            ys, xs = np.nonzero(mask)
            annotations.append({
                "id": len(annotations) + 1, "image_id": i, "category_id": 1, "iscrowd": 0,
                "segmentation": rle.encode(mask), "area": int(mask.sum()),
                "bbox": [int(xs.min()), int(ys.min()), int(np.ptp(xs)) + 1, int(np.ptp(ys)) + 1],
            })
    return {"images": images, "annotations": annotations,
            "categories": [{"id": 1, "name": "object", "isthing": 1}]}


def make(osd_root: str, data_root: str, seed: int = 7, felzenszwalb: bool = True) -> str:
    """Build the layout; returns the path of the final annotation JSON."""
    base = os.path.join(data_root, "UOAIS-Sim")
    split_dir = os.path.join(base, "train")
    ann_dir = os.path.join(base, "annotations")
    os.makedirs(ann_dir, exist_ok=True)
    instances = os.path.join(ann_dir, "coco_anns_uoais_sim_train.json")
    with open(instances, "w") as f:
        json.dump(write_instances(osd_root, split_dir), f)
    panoptic = os.path.join(ann_dir, "coco_anns_panoptic_uoais_sim_train.json")
    pan_root = os.path.join(split_dir, "panoptic_annos")
    detection2panoptic.main(["--json", instances, "--out-json", panoptic, "--out-dir", pan_root])
    perturbed = os.path.join(ann_dir, "coco_anns_panoptic_uoais_sim_train_perturbed.json")
    perturbate_masks.main(["--json", panoptic, "--panoptic-root", pan_root, "--image-root",
                           split_dir, "--out", perturbed, "--seed", str(seed)]
                          + ([] if felzenszwalb else ["--no-felzenszwalb"]))
    panoptic2eee.main(["--json", perturbed, "--panoptic-root", pan_root])
    return perturbed


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--osd", required=True, help="an OSD-layout dataset root")
    parser.add_argument("--data-root", required=True)
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--no-felzenszwalb", action="store_true",
                        help="the image-free perturbation flow (ellipse proposals)")
    args = parser.parse_args(argv)
    out = make(args.osd, args.data_root, args.seed, felzenszwalb=not args.no_felzenszwalb)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()

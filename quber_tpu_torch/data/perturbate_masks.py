"""Offline mask-perturbation generator (panoptic format).

    python3 -m quber_tpu_torch.data.perturbate_masks --json train_panoptic.json \
        --panoptic-root panoptic_pngs/ [--image-root imgs/] [--out out.json]

The port's copy of tools/perturbate_masks.py for its `panoptic` format,
with the same flags and draws (one RandomState(--seed) over the images in
order): each image's GT masks, read from its panoptic PNG, are corrupted
and written as RLEs into images[*].perturbed_segmentation of a new
*_perturbed.json. Where the image is readable under --image-root, false
positives and over- / under-segmentations come from Felzenszwalb proposals
(data/perturb.perturb_masks_reference); otherwise, or with
--no-felzenszwalb, the image-free flow with its ellipse proposals runs.
The `coco`, `armbench` and `from_is` formats wait (ROADMAP.md Queue 1
item 11d).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from quber_tpu_torch.data import rle
from quber_tpu_torch.data.datasets import read_image, rgb2id
from quber_tpu_torch.data.perturb import perturb_masks, perturb_masks_reference


def _perturb(masks, rgb, rng, args):
    if masks.size == 0:
        return masks
    if rgb is not None and not args.no_felzenszwalb:
        return perturb_masks_reference(masks, rgb, rng, iou_target=(args.iou_low, args.iou_high))
    return perturb_masks(np.asarray(masks), rng, target_iou=(args.iou_low, args.iou_high),
                         ratios={"fp": args.fp_ratio})


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--format", default="panoptic",
                        choices=("panoptic", "coco", "armbench", "from_is"))
    parser.add_argument("--json", required=True)
    parser.add_argument("--panoptic-root", default=None, help="panoptic PNG dir")
    parser.add_argument("--image-root", default=None,
                        help="RGB image dir (enables Felzenszwalb proposals)")
    parser.add_argument("--out", default=None)
    parser.add_argument("--iou-low", type=float, default=0.8)
    parser.add_argument("--iou-high", type=float, default=1.0)
    parser.add_argument("--fp-ratio", type=float, default=0.15,
                        help="FP ratio of the image-free fallback flow")
    parser.add_argument("--no-felzenszwalb", action="store_true",
                        help="force the image-free ellipse-proposal flow")
    parser.add_argument("--seed", type=int, default=7)
    args = parser.parse_args(argv)
    if args.format != "panoptic":
        parser.error(f"--format {args.format} is not ported yet: ROADMAP.md Queue 1 item 11d")
    if not args.panoptic_root:
        parser.error("--panoptic-root required for panoptic format")

    with open(args.json) as f:
        coco = json.load(f)
    rng = np.random.RandomState(args.seed)

    def load_rgb(img):
        if args.image_root is None:
            return None
        path = os.path.join(args.image_root, img["file_name"])
        return read_image(path, bgr=True) if os.path.isfile(path) else None

    anns = {a["image_id"]: a for a in coco.get("annotations", [])}
    for i, img in enumerate(coco["images"]):
        ann = anns.get(img["id"])
        if ann is None:
            continue
        pan_path = os.path.join(args.panoptic_root,
                                ann.get("file_name", img["file_name"]).replace(".jpg", ".png"))
        panoptic = rgb2id(read_image(pan_path))
        masks = np.asarray([(panoptic == seg["id"]).astype(np.uint8)
                            for seg in ann["segments_info"]])
        pert = _perturb(masks, load_rgb(img), rng, args)
        img["perturbed_segmentation"] = [rle.encode(m) for m in pert]
        if (i + 1) % 100 == 0:
            print(f"{i + 1}/{len(coco['images'])}")

    out = args.out or args.json.replace(".json", "_perturbed.json")
    with open(out, "w") as f:
        json.dump(coco, f)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()

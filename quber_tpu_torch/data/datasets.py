"""Dataset registration and perturbed-panoptic JSON loading.

Port of quber_tpu/data/datasets.py: a registry mapping dataset names to
loader functions that join the COCO-panoptic `images` and `annotations`
records and pull the `perturbed_segmentation` RLE list plus the eight
TP/TN/FP/FN error-map RLEs into per-image dicts. Registered names follow
the reference: uoais_sim_{train,val}_panoptic (and the `_augmented` / `_is`
variants), tod_v2_{train,val}_panoptic, armbench_{train,test}_panoptic, and
the COCO-instance-format uoais_sim_{train,val}, armbench_{train,test}.

`read_image` is the readers' stand-in for `cv2.imread` / `imageio.imread`
on PNG files (data/png.py); a JPEG file raises, since the port has no JPEG
decoder (ROADMAP.md Queue 1 item 11d).
"""

from __future__ import annotations

import json
import os

import numpy as np

from quber_tpu_torch.data import png

DATASET_REGISTRY: dict = {}

EEE_KEYS = [
    "tp_mask", "tn_mask", "fp_mask", "fn_mask",
    "tp_boundary", "tn_boundary", "fp_boundary", "fn_boundary",
]


def read_image(path: str, bgr: bool = False) -> np.ndarray:
    """A PNG file as `imageio.imread` gives it, or with `bgr` as
    `cv2.imread(path)` (IMREAD_COLOR) does: uint8 [H, W, 3] in BGR order,
    grey replicated, alpha dropped, 16-bit cut to its high byte."""
    with open(path, "rb") as f:
        head = f.read(3)
    if head == b"\xff\xd8\xff":
        raise NotImplementedError(
            f"{path}: JPEG images are not read by the port (no JPEG decoder on the card's "
            "machine): ROADMAP.md Queue 1 item 11d")
    return png.imread(path, bgr=bgr)


def register_dataset(name: str, loader, metadata: dict | None = None):
    DATASET_REGISTRY[name] = {"loader": loader, "metadata": metadata or {}}


def get_dataset(name: str) -> list[dict]:
    return DATASET_REGISTRY[name]["loader"]()


def get_metadata(name: str) -> dict:
    return DATASET_REGISTRY[name]["metadata"]


def load_perturbed_panoptic_json(json_file: str, image_root: str,
                                 panoptic_root: str) -> list[dict]:
    """Join images and annotations into dataset dicts with perturbed masks and
    error-map RLEs."""
    with open(json_file) as f:
        coco = json.load(f)
    anns_by_image = {a["image_id"]: a for a in coco.get("annotations", [])}
    out = []
    for img in coco["images"]:
        ann = anns_by_image.get(img["id"], {})
        record = {
            "image_id": img["id"],
            "file_name": os.path.join(image_root, img["file_name"]),
            "pan_seg_file_name": os.path.join(
                panoptic_root, ann.get("file_name", img["file_name"]).replace(".jpg", ".png")),
            "height": img.get("height"),
            "width": img.get("width"),
            "segments_info": ann.get("segments_info", []),
            "perturbed_segmentation": img.get("perturbed_segmentation", []),
        }
        if "depth_file_name" in img:
            record["depth_file_name"] = os.path.join(image_root, img["depth_file_name"])
        for key in EEE_KEYS:
            if key in img:
                record[key] = img[key]
        out.append(record)
    return out


def load_perturbed_instance_json(json_file: str, image_root: str) -> list[dict]:
    """COCO instance-format loader: per-image records with the instance
    `annotations` (bbox XYWH, contiguous category_id, segmentation, iscrowd,
    visible_mask) plus the per-image perturbed and error-map RLEs."""
    with open(json_file) as f:
        coco = json.load(f)
    cat_ids = sorted(c["id"] for c in coco.get("categories", [])) or [1]
    id_map = {v: i for i, v in enumerate(cat_ids)}
    anns_by_image: dict = {}
    for a in coco.get("annotations", []):
        anns_by_image.setdefault(a["image_id"], []).append(a)
    out = []
    for img in coco["images"]:
        record = {
            "image_id": img["id"],
            "file_name": os.path.join(image_root, img["file_name"]),
            "height": img.get("height"),
            "width": img.get("width"),
            "annotations": [
                {
                    "bbox": a.get("bbox"),
                    "category_id": id_map.get(a.get("category_id", cat_ids[0]), 0),
                    "segmentation": a.get("segmentation"),
                    "iscrowd": a.get("iscrowd", 0),
                    "visible_mask": a.get("visible_mask"),
                }
                for a in anns_by_image.get(img["id"], [])
            ],
            "perturbed_segmentation": img.get("perturbed_segmentation", []),
        }
        if "depth_file_name" in img:
            record["depth_file_name"] = os.path.join(image_root, img["depth_file_name"])
        for key in EEE_KEYS:
            if key in img:
                record[key] = img[key]
        out.append(record)
    return out


UOAIS_METADATA = {
    "thing_classes": ["object"],
    "thing_dataset_id_to_contiguous_id": {1: 0},
    "stuff_classes": [],
    "label_divisor": 1000,
    "ignore_label": 255,
}

# name -> (annotation json, image root, panoptic PNG root), under the data root
PANOPTIC_SPECS = {
    "uoais_sim_train_panoptic": (
        "UOAIS-Sim/annotations/coco_anns_panoptic_uoais_sim_train_perturbed.json",
        "UOAIS-Sim/train", "UOAIS-Sim/train/panoptic_annos"),
    "uoais_sim_val_panoptic": (
        "UOAIS-Sim/annotations/coco_anns_panoptic_uoais_sim_val_perturbed.json",
        "UOAIS-Sim/val", "UOAIS-Sim/val/panoptic_annos"),
    "uoais_sim_train_panoptic_augmented": (
        "UOAIS-Sim/annotations/uoais_sim_train_panoptic_augmented_perturbed.json",
        "UOAIS-Sim/train", "UOAIS-Sim/train/panoptic_annos"),
    "uoais_sim_val_panoptic_augmented": (
        "UOAIS-Sim/annotations/uoais_sim_val_panoptic_augmented_perturbed.json",
        "UOAIS-Sim/val", "UOAIS-Sim/val/panoptic_annos"),
    "uoais_sim_train_panoptic_is": (
        "UOAIS-Sim/annotations/uoais_sim_train_panoptic_perturbed_is.json",
        "UOAIS-Sim/train", "UOAIS-Sim/train/panoptic_annos"),
    "tod_v2_train_panoptic": (
        "TODv2/annotations/train_panoptic_perturbed.json", "TODv2/train", "TODv2/train/panoptic"),
    "tod_v2_val_panoptic": (
        "TODv2/annotations/val_panoptic_perturbed.json", "TODv2/val", "TODv2/val/panoptic"),
    "armbench_train_panoptic": (
        "armbench/mix-object-tote/train_panoptic_perturbed.json",
        "armbench/mix-object-tote/images", "armbench/train"),
    "armbench_test_panoptic": (
        "armbench/mix-object-tote/test_panoptic_perturbed.json",
        "armbench/mix-object-tote/images", "armbench/test"),
}

# name -> (annotation json, image root), COCO instance format
INSTANCE_SPECS = {
    "uoais_sim_train": ("UOAIS-Sim/annotations/coco_anns_uoais_sim_train_perturbed.json",
                        "UOAIS-Sim/train"),
    "uoais_sim_val": ("UOAIS-Sim/annotations/coco_anns_uoais_sim_val_perturbed.json",
                      "UOAIS-Sim/val"),
    "armbench_train": ("armbench/mix-object-tote/train_panoptic_perturbed.json",
                       "armbench/mix-object-tote/images"),
    "armbench_test": ("armbench/mix-object-tote/test_object_only.json",
                      "armbench/mix-object-tote/images"),
}


def register_standard_datasets(data_root: str = "datasets"):
    """Register the reference dataset names against a data root."""
    for name, (json_rel, img_rel, pan_rel) in PANOPTIC_SPECS.items():
        register_dataset(
            name,
            (lambda jf=os.path.join(data_root, json_rel), ir=os.path.join(data_root, img_rel),
                    pr=os.path.join(data_root, pan_rel): load_perturbed_panoptic_json(jf, ir, pr)),
            UOAIS_METADATA)
    for name, (json_rel, img_rel) in INSTANCE_SPECS.items():
        register_dataset(
            name,
            (lambda jf=os.path.join(data_root, json_rel), ir=os.path.join(data_root, img_rel):
                load_perturbed_instance_json(jf, ir)),
            UOAIS_METADATA)


def rgb2id(color) -> np.ndarray:
    """Panoptic PNG colour -> segment id (panopticapi convention)."""
    color = np.asarray(color, dtype=np.uint32)
    return color[..., 0] + 256 * color[..., 1] + 256 * 256 * color[..., 2]


def id2rgb(ids) -> np.ndarray:
    """Segment id -> panoptic PNG colour, the inverse of rgb2id."""
    ids = np.asarray(ids, dtype=np.uint32)
    return np.stack([ids % 256, (ids // 256) % 256, (ids // 65536) % 256],
                    axis=-1).astype(np.uint8)

"""Benchmark dataset walkers: OSD, OCID, WISDOM, HOPE, DoPose.

Port of quber_tpu/evaluation/datasets.py: the same on-disk layouts, each
walker returning parallel (rgb_paths, depth_paths, anno_paths) lists, and
the annotation loader, reading PNGs with data/png.py and resizing with
ops/preprocess.resize_nearest in place of imageio and OpenCV.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from quber_tpu_torch.data import png
from quber_tpu_torch.ops.preprocess import resize_nearest

# OCID background labels to zero out before evaluation
BG_LABELS = {"floor": [0, 1], "table": [0, 1, 2]}
EVAL_W, EVAL_H = 640, 480


def _walk_tree(root: str, level_dirs: list[list[str]]):
    """Walk root/<d1>/<d2>/.../<seq>/{rgb,depth,label}/ sequences."""
    rgb, depth, anno = [], [], []

    def rec(base, levels):
        if not levels:
            for seq in sorted(os.listdir(base)):
                data_dir = os.path.join(base, seq)
                if not os.path.isdir(data_dir):
                    continue
                for name in sorted(os.listdir(os.path.join(data_dir, "rgb"))):
                    rgb.append(os.path.join(data_dir, "rgb", name))
                    depth.append(os.path.join(data_dir, "depth", name))
                    anno.append(os.path.join(data_dir, "label", name))
            return
        for d in levels[0]:
            p = os.path.join(base, d)
            if os.path.isdir(p):
                rec(p, levels[1:])

    rec(root, level_dirs)
    return rgb, depth, anno


def build_file_lists(dataset: str, dataset_path: str | None = None):
    """Returns (rgb_paths, depth_paths, anno_paths) for a benchmark dataset."""
    if dataset == "OSD":
        root = dataset_path or "detectron2_datasets/OSD-0.2-depth"
        rgb = sorted(glob.glob(f"{root}/image_color/*.png"))
        depth = sorted(glob.glob(f"{root}/disparity/*.png"))
        anno = sorted(glob.glob(f"{root}/annotation/*.png"))
    elif dataset == "OCID":
        root = dataset_path or "detectron2_datasets/OCID-dataset"
        ft, bt = ["floor", "table"], ["bottom", "top"]
        r1, d1, a1 = _walk_tree(os.path.join(root, "ARID20"), [ft, bt])
        r2, d2, a2 = _walk_tree(
            os.path.join(root, "YCB10"), [ft, bt, ["cuboid", "curved", "mixed"]]
        )
        r3, d3, a3 = _walk_tree(
            os.path.join(root, "ARID10"),
            [ft, bt, ["box", "curved", "fruits", "mixed", "non-fruits"]],
        )
        rgb, depth, anno = r1 + r2 + r3, d1 + d2 + d3, a1 + a2 + a3
    elif dataset == "WISDOM":
        root = dataset_path or "detectron2_datasets/wisdom-real/high-res"
        idx = np.load(os.path.join(root, "test_indices.npy"))
        rgb = [os.path.join(root, "color_ims", f"image_{i:06d}.png") for i in idx]
        depth = [os.path.join(root, "depth_ims_numpy", f"image_{i:06d}.npy") for i in idx]
        anno = [os.path.join(root, "modal_segmasks", f"image_{i:06d}.png") for i in idx]
    elif dataset in ("HOPE", "DoPose"):
        root = dataset_path or (
            "detectron2_datasets/hope_preprocessed" if dataset == "HOPE" else "detectron2_datasets/DoPose"
        )
        rgb = sorted(glob.glob(f"{root}/rgb/*.png"))
        depth = sorted(glob.glob(f"{root}/depth/*.png"))
        anno = sorted(glob.glob(f"{root}/annotation/*.png"))
    else:
        raise NotImplementedError(
            f"dataset {dataset} not supported (OSD, OCID, WISDOM, HOPE, DoPose)"
        )
    if not len(rgb) == len(depth) == len(anno):
        raise ValueError(f"{dataset} under {root}: {len(rgb)} colour, {len(depth)} depth and "
                         f"{len(anno)} annotation files")
    return rgb, depth, anno


def load_annotation(anno_path: str, dataset: str, rgb_path: str = "") -> np.ndarray:
    """Ground-truth label image at 640x480 with OCID floor/table removal."""
    anno = resize_nearest(png.imread(anno_path), (EVAL_H, EVAL_W))
    if dataset == "OCID":
        key = "floor" if "floor" in rgb_path else "table"
        for label in BG_LABELS[key]:
            anno[anno == label] = 0
    return anno

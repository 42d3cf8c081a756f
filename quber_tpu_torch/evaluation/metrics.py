"""Overlap and Boundary P/R/F metrics with Hungarian matching.

Port of quber_tpu/evaluation/metrics.py (the UOIS protocol of Davis-2017 /
Dave et al.), with the same keys and edge cases, without OpenCV:
  * `seg2bmap`, the boundary of `cv2.findContours(RETR_EXTERNAL)` drawn
    1 px wide, is the mask with its holes filled (holes: background not
    4-connected to the outside) minus its 4-connected erosion, the image
    border counting as outside: rims of holes and islands inside holes draw
    no boundary, as RETR_EXTERNAL draws none;
  * `cv2.dilate` with a disk is `scipy.ndimage.binary_dilation`, exact for
    binary maps.
`multilabel_metrics` dilates each mask's boundary once a frame (G + P
dilations, where the JAX function dilates both boundaries of every pair)
and counts all pairwise boundary overlaps with one product; the counts are
the same.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage
from scipy.optimize import linear_sum_assignment

BACKGROUND_LABEL = 0
_CROSS = ndimage.generate_binary_structure(2, 1)


def disk(radius: int) -> np.ndarray:
    """Disk structuring element (skimage.morphology.disk semantics)."""
    r = int(radius)
    y, x = np.ogrid[-r : r + 1, -r : r + 1]
    return (x**2 + y**2 <= r**2).astype(np.uint8)


def _bbox(seg: np.ndarray, margin: int):
    """Slices of the bounding box of seg's set pixels grown by `margin`,
    clipped to the image; None for an empty mask."""
    rows, cols = np.flatnonzero(seg.any(axis=1)), np.flatnonzero(seg.any(axis=0))
    if not len(rows):
        return None
    h, w = seg.shape
    return (slice(max(rows[0] - margin, 0), min(rows[-1] + 1 + margin, h)),
            slice(max(cols[0] - margin, 0), min(cols[-1] + 1 + margin, w)))


def _boundary(crop: np.ndarray) -> np.ndarray:
    """External boundary of a bool crop whose edges are background or the
    image border."""
    filled = ndimage.binary_fill_holes(np.pad(crop, 1))
    return (filled & ~ndimage.binary_erosion(filled, _CROSS))[1:-1, 1:-1]


def seg2bmap(seg: np.ndarray) -> np.ndarray:
    """1-px-wide external-contour boundary map (uint8) of a binary mask."""
    seg = np.asarray(seg) != 0
    bmap = np.zeros(seg.shape, np.uint8)
    box = _bbox(seg, 0)
    if box is not None:
        bmap[box] = _boundary(seg[box])
    return bmap


def _bound_pix(shape, bound_th: float) -> int:
    return int(bound_th if bound_th >= 1 else np.ceil(bound_th * np.linalg.norm(shape)))


def _boundary_and_dilation(seg: np.ndarray, radius: int):
    """(boundary, boundary dilated by disk(radius)), both bool [H, W]."""
    seg = np.asarray(seg) != 0
    bmap = np.zeros(seg.shape, bool)
    dil = np.zeros(seg.shape, bool)
    box = _bbox(seg, radius)
    if box is not None:
        b = _boundary(seg[box])
        bmap[box] = b
        dil[box] = ndimage.binary_dilation(b, disk(radius).astype(bool)) if radius > 0 else b
    return bmap, dil


def boundary_overlap(predicted_mask, gt_mask, bound_th: float = 0.003):
    """(precision_tps, recall_tps) between dilated boundaries."""
    radius = _bound_pix(np.shape(predicted_mask), bound_th)
    fg_boundary, fg_dil = _boundary_and_dilation(predicted_mask, radius)
    gt_boundary, gt_dil = _boundary_and_dilation(gt_mask, radius)
    return (
        int(np.logical_and(fg_boundary, gt_dil).sum()),
        int(np.logical_and(gt_boundary, fg_dil).sum()),
    )


def _edge_case(num_pred: int, num_gt: int, value_p: float, value_r: float, all_correct: bool):
    f = 1.0 if all_correct else 0.0
    pct = 1.0 if all_correct else 0.0
    out = {
        "Objects F-measure": f,
        "Objects Precision": value_p,
        "Objects Recall": value_r,
        "Boundary F-measure": f,
        "Boundary Precision": value_p,
        "Boundary Recall": value_r,
        "Objects OSN F-measure": f,
        "Objects OSN Precision": value_p,
        "Objects OSN Recall": value_r,
        "Boundary OSN F-measure": f,
        "Boundary OSN Precision": value_p,
        "Boundary OSN Recall": value_r,
        "obj_detected": num_pred,
        "obj_detected_075": 0.0,
        "obj_gt": num_gt,
        "obj_detected_075_percentage": pct,
        "obj_detected_075_percentage_normalized": pct,
    }
    return out


def multilabel_metrics(
    prediction: np.ndarray,
    gt: np.ndarray,
    obj_detect_threshold: float = 0.75,
    compute_boundary_stuff: bool = True,
) -> dict:
    """Metrics between two [H, W] label images (0 = background)."""
    labels_gt = np.unique(gt)
    labels_gt = labels_gt[labels_gt != BACKGROUND_LABEL]
    labels_pred = np.unique(prediction)
    labels_pred = labels_pred[labels_pred != BACKGROUND_LABEL]
    g, p = len(labels_gt), len(labels_pred)

    if p == 0 and g > 0:
        return _edge_case(p, g, 1.0, 0.0, False)  # all false negatives
    if p > 0 and g == 0:
        return _edge_case(p, g, 0.0, 1.0, False)  # all false positives
    if p == 0 and g == 0:
        return _edge_case(p, g, 1.0, 1.0, True)  # correctly predicted nothing

    # one-hot intersection counts [G, P] in one pass
    gt_flat = gt.reshape(-1)
    pred_flat = prediction.reshape(-1)
    gt_idx = np.searchsorted(labels_gt, gt_flat)
    pred_idx = np.searchsorted(labels_pred, pred_flat)
    gt_valid = np.isin(gt_flat, labels_gt)
    pred_valid = np.isin(pred_flat, labels_pred)
    both = gt_valid & pred_valid
    inter = np.zeros((g, p), np.int64)
    np.add.at(inter, (gt_idx[both], pred_idx[both]), 1)
    gt_areas = np.bincount(gt_idx[gt_valid], minlength=g).astype(np.int64)
    pred_areas = np.bincount(pred_idx[pred_valid], minlength=p).astype(np.int64)

    with np.errstate(divide="ignore", invalid="ignore"):
        obj_P = inter / pred_areas[None, :]
        obj_R = inter / gt_areas[:, None]
        obj_F = 2 * obj_P * obj_R / (obj_P + obj_R)
        union = gt_areas[:, None] + pred_areas[None, :] - inter
        obj_iou = inter / union
    obj_F = np.nan_to_num(obj_F)

    if compute_boundary_stuff:
        radius = _bound_pix(prediction.shape, 0.003)
        pred_b = [_boundary_and_dilation(prediction == l, radius) for l in labels_pred]
        gt_b = [_boundary_and_dilation(gt == l, radius) for l in labels_gt]
        bound_counts_pred = np.array([b.sum() for b, _ in pred_b], np.float64)
        bound_counts_gt = np.array([b.sum() for b, _ in gt_b], np.float64)

        def stack(maps):
            return np.stack(maps).reshape(len(maps), -1).astype(np.float32)

        # exact integer counts: float32 holds them below 2**24
        bound_tps = np.zeros((g, p, 2))
        bound_tps[..., 0] = stack([d for _, d in gt_b]) @ stack([b for b, _ in pred_b]).T
        bound_tps[..., 1] = stack([b for b, _ in gt_b]) @ stack([d for _, d in pred_b]).T
        with np.errstate(divide="ignore", invalid="ignore"):
            bound_P = bound_tps[..., 0] / bound_counts_pred[None, :]
            bound_R = bound_tps[..., 1] / bound_counts_gt[:, None]
            bound_F = 2 * bound_P * bound_R / (bound_P + bound_R)
        bound_F = np.nan_to_num(bound_F)

    # Hungarian assignment maximising the pairwise F
    rows, cols = linear_sum_assignment(obj_F.max() - obj_F)
    idx = (rows, cols)

    num_obj_detected = int(np.sum(obj_F[idx] > obj_detect_threshold))

    precision = inter[idx].sum() / np.maximum((pred_flat != BACKGROUND_LABEL).sum(), 1)
    recall = inter[idx].sum() / np.maximum((gt_flat != BACKGROUND_LABEL).sum(), 1)
    F_measure = (
        0.0 if precision + recall == 0 else 2 * precision * recall / (precision + recall)
    )

    obj_F_osn = obj_F[idx].sum() / max(p, g)
    obj_P_osn = np.nan_to_num(obj_P)[idx].sum() / p
    obj_R_osn = np.nan_to_num(obj_R)[idx].sum() / g
    obj_iou_osn = float(np.mean(np.nan_to_num(obj_iou)[idx]))
    i_over_u = float(inter[idx].sum() / np.maximum(union[idx].sum(), 1))

    result = {
        "Objects F-measure": float(F_measure),
        "Objects Precision": float(precision),
        "Objects Recall": float(recall),
        "Objects OSN F-measure": float(obj_F_osn),
        "Objects OSN Precision": float(obj_P_osn),
        "Objects OSN Recall": float(obj_R_osn),
        "obj_detected": p,
        "obj_detected_075": num_obj_detected,
        "obj_gt": g,
        "obj_detected_075_percentage": num_obj_detected / g,
        "obj_detected_075_percentage_normalized": num_obj_detected / max(g, p),
        "obj_mIOU_osn": obj_iou_osn,
        "obj_mIOU": i_over_u,
    }

    if compute_boundary_stuff:
        b_prec = bound_tps[idx][:, 0].sum() / np.maximum(bound_counts_pred.sum(), 1)
        b_rec = bound_tps[idx][:, 1].sum() / np.maximum(bound_counts_gt.sum(), 1)
        b_f = 0.0 if b_prec + b_rec == 0 else 2 * b_prec * b_rec / (b_prec + b_rec)
        result.update({
            "Boundary F-measure": float(b_f),
            "Boundary Precision": float(b_prec),
            "Boundary Recall": float(b_rec),
            "Boundary OSN F-measure": float(bound_F[idx].sum() / max(p, g)),
            "Boundary OSN Precision": float(np.nan_to_num(bound_P)[idx].sum() / p),
            "Boundary OSN Recall": float(np.nan_to_num(bound_R)[idx].sum() / g),
        })
    else:
        for k in ["Boundary F-measure", "Boundary Precision", "Boundary Recall",
                  "Boundary OSN F-measure", "Boundary OSN Precision", "Boundary OSN Recall"]:
            result[k] = None
    return result

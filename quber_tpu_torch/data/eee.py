"""Host-side quadruple error maps (the offline tool's core).

Port of quber_tpu/data/eee.py: the eight TP/TN/FP/FN maps of the foreground
region and of the boundary band, between a GT and a predicted mask stack.
A mask's boundary is the mask minus its erosion by round(0.02 x diagonal)
steps of a 3x3 square inside a one-pixel zero frame (cv2.copyMakeBorder +
cv2.erode, ops/imgproc.erode_rect).
"""

from __future__ import annotations

import numpy as np

from quber_tpu_torch.ops.imgproc import erode_rect


def mask_to_boundary(mask: np.ndarray, dilation_ratio: float = 0.02) -> np.ndarray:
    h, w = mask.shape
    n = max(1, int(round(dilation_ratio * np.sqrt(h ** 2 + w ** 2))))
    padded = np.pad(mask.astype(np.uint8), 1)
    eroded = erode_rect(padded, 3, iterations=n)
    return mask.astype(np.uint8) - eroded[1:h + 1, 1:w + 1]


def masks_to_fg(masks: np.ndarray) -> np.ndarray:
    if len(masks) == 0:
        return np.zeros((0, 0), np.uint8)
    return (np.sum(masks, axis=0) > 0).astype(np.uint8)


def masks_to_boundary(masks: np.ndarray, dilation_ratio: float = 0.01) -> np.ndarray:
    if len(masks) == 0:
        return np.zeros((0, 0), np.uint8)
    b = np.sum([mask_to_boundary(m, dilation_ratio) for m in masks], axis=0)
    return (b > 0).astype(np.uint8)


def compute_eee_maps(gt_masks: np.ndarray, pred_masks: np.ndarray) -> dict:
    """The 8 float32 maps {tp,tn,fp,fn}_{mask,boundary} [H, W]."""
    h, w = (gt_masks.shape[1:] if len(gt_masks) else pred_masks.shape[1:])
    zero = np.zeros((h, w), np.uint8)
    gt_fg = masks_to_fg(gt_masks) if len(gt_masks) else zero
    pr_fg = masks_to_fg(pred_masks) if len(pred_masks) else zero
    gt_b = masks_to_boundary(gt_masks) if len(gt_masks) else zero
    pr_b = masks_to_boundary(pred_masks) if len(pred_masks) else zero
    out = {}
    for kind, (gt, pr) in (("mask", (gt_fg, pr_fg)), ("boundary", (gt_b, pr_b))):
        gt, pr = gt.astype(bool), pr.astype(bool)
        for name, m in (("tp", gt & pr), ("tn", ~gt & ~pr), ("fp", ~gt & pr), ("fn", gt & ~pr)):
            out[f"{name}_{kind}"] = m.astype(np.float32)
    return out

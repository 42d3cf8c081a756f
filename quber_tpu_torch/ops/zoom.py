"""Zoom-in second stage: crop each instance, segment the crop again, paste.

Port of quber_tpu/ops/zoom.py (torch, on the tensors' device). Every one of
`max_instances` slots gets a padded square crop around its instance (an
empty slot gets a zero box and changes nothing); the refined crops are
pasted back in slot order, so a later instance overwrites an earlier one.
"""

from __future__ import annotations

from typing import Callable

import torch


def instance_boxes_from_labels(labels: torch.Tensor, max_instances: int,
                               pad_ratio: float = 0.4):
    """Label map [H, W] -> (boxes [max_instances, 4] XYXY float32: the square
    around instance id i + 1 grown by pad_ratio and 8 pixels, clipped to the
    image; valid [max_instances] bool)."""
    h, w = labels.shape
    dev = labels.device
    ids = torch.arange(1, max_instances + 1, dtype=labels.dtype, device=dev)
    masks = labels[None] == ids[:, None, None]
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    big = 1e9

    def minmax(coord):
        mn = torch.where(masks, coord[None], big).amin(dim=(1, 2))
        mx = torch.where(masks, coord[None], -big).amax(dim=(1, 2))
        return mn, mx

    y0, y1 = minmax(ys)
    x0, x1 = minmax(xs)
    cy, cx = (y0 + y1) / 2, (x0 + x1) / 2
    bh = (y1 - y0) * (1 + pad_ratio) + 8
    bw = (x1 - x0) * (1 + pad_ratio) + 8
    side = torch.maximum(bh, bw)  # square crops keep the aspect
    boxes = torch.stack([
        (cx - side / 2).clamp(0, w), (cy - side / 2).clamp(0, h),
        (cx + side / 2).clamp(0, w), (cy + side / 2).clamp(0, h),
    ], dim=-1)
    valid = masks.any(dim=(1, 2))
    return torch.where(valid[:, None], boxes, 0.0), valid


def zoom_refine_labels(labels: torch.Tensor, refine: Callable, max_instances: int,
                       zoom: int, pad_ratio: float = 0.4) -> torch.Tensor:
    """Second-stage refinement of an int label map [H, W].

    refine(boxes [M, 4], valid [M], ids [M]) -> [M, zoom, zoom] float32 in
    {0, 1}: each slot's refined mask inside its crop. Each slot's instance
    is replaced by its refined mask; a pixel takes its nearest crop cell
    (rounded half to even)."""
    h, w = labels.shape
    dev = labels.device
    boxes, valid = instance_boxes_from_labels(labels, max_instances, pad_ratio=pad_ratio)
    ids = torch.arange(1, max_instances + 1, dtype=labels.dtype, device=dev)
    crops = refine(boxes, valid, ids)
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    full = labels
    for i in range(max_instances):
        box = boxes[i]
        gy = (ys + 0.5 - box[1]) / (box[3] - box[1]).clamp_min(1e-3) * zoom - 0.5
        gx = (xs + 0.5 - box[0]) / (box[2] - box[0]).clamp_min(1e-3) * zoom - 0.5
        inside = (gy >= 0) & (gy < zoom) & (gx >= 0) & (gx < zoom)
        val = crops[i][torch.round(gy).clamp(0, zoom - 1).long(),
                       torch.round(gx).clamp(0, zoom - 1).long()]
        refined = inside & (val > 0.5) & valid[i]
        full = torch.where((full == ids[i]) & ~refined, 0, full)
        full = torch.where(refined, ids[i], full)
    return full

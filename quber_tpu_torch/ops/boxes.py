"""Box operations (torch, on the tensors' device): IoU, fixed-shape NMS,
anchors, box deltas, FPN level assignment and ROI-align.

Port of quber_tpu/ops/boxes.py. Boxes are XYXY float32. Feature maps are
channels-first ([C, H, W]), as the port's models hold them.

`nms_fixed` keeps the reference's result bit for bit: the boxes are walked
in stable descending-score order and a box is dropped when its IoU with an
already kept one is strictly above the threshold. The reference scans on the
device one box at a time; here the IoU matrix is computed on the device,
thresholded, and its bit matrix copied to the host once, where the greedy
scan runs in numpy (one pass over the kept boxes), so a call costs one
device-to-host copy and not one launch per box.
"""

from __future__ import annotations

import numpy as np
import torch


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]).clamp_min(0) * (boxes[..., 3] - boxes[..., 1]).clamp_min(0)


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU: a [N, 4], b [M, 4] -> [N, M]."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[:, None] + box_area(b)[None, :] - inter
    return inter / union.clamp_min(1e-9)


def greedy_scan(over: np.ndarray) -> np.ndarray:
    """Greedy suppression over boxes in scan order: over [N, N] bool (IoU
    above the threshold) -> keep [N] bool. A box is kept iff no kept box
    before it overlaps it."""
    n = over.shape[0]
    keep = np.ones(n, bool)
    for i in range(n):
        if keep[i]:
            keep[i + 1:] &= ~over[i, i + 1:]
    return keep


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.5,
              max_out: int | None = None) -> torch.Tensor:
    """Greedy single-class NMS -> keep [N] bool in the ORIGINAL order; with
    `max_out`, only the first max_out kept boxes in score order stay kept."""
    n = boxes.shape[0]
    order = torch.argsort(-scores, stable=True)
    b = boxes[order]
    over = (box_iou(b, b) > iou_threshold).cpu().numpy()
    keep_sorted = greedy_scan(over)
    if max_out is not None and max_out < n:
        keep_sorted &= np.cumsum(keep_sorted) <= max_out
    keep = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    keep[order] = torch.from_numpy(keep_sorted).to(boxes.device)
    return keep


def generate_anchors(feat_h: int, feat_w: int, stride: int, sizes=(32, 64, 128),
                     aspect_ratios=(0.5, 1.0, 2.0), offset: float = 0.5,
                     device="cpu") -> torch.Tensor:
    """Dense anchors [H * W * A, 4] XYXY centred on the feature cells (offset
    0.5) or on their corners (offset 0, detectron2's DefaultAnchorGenerator),
    in (h, w, a) order."""
    anchors = []
    for s in sizes:
        for ar in aspect_ratios:
            w = s * np.sqrt(1.0 / ar)
            h = s * np.sqrt(ar)
            anchors.append([-w / 2, -h / 2, w / 2, h / 2])
    base = np.asarray(anchors, np.float32)
    ys = (np.arange(feat_h) + offset) * stride
    xs = (np.arange(feat_w) + offset) * stride
    cx, cy = np.meshgrid(xs, ys)
    shifts = np.stack([cx, cy, cx, cy], axis=-1).reshape(-1, 1, 4)
    out = (shifts + base[None]).reshape(-1, 4).astype(np.float32)
    return torch.from_numpy(out).to(device)


def apply_deltas(boxes: torch.Tensor, deltas: torch.Tensor, clip_hw=None, weights=None,
                 scale_clamp: float = 4.0) -> torch.Tensor:
    """Faster R-CNN decoding of (dx, dy, dw, dh) on XYXY boxes; `weights`
    (wx, wy, ww, wh) divide the deltas first, dw / dh are clamped to
    +-scale_clamp, and `clip_hw` clips the result to the image."""
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    cx = boxes[:, 0] + 0.5 * w
    cy = boxes[:, 1] + 0.5 * h
    dx, dy, dw, dh = deltas.unbind(dim=1)
    if weights is not None:
        wx, wy, ww, wh = weights
        dx, dy, dw, dh = dx / wx, dy / wy, dw / ww, dh / wh
    dw = dw.clamp(-scale_clamp, scale_clamp)
    dh = dh.clamp(-scale_clamp, scale_clamp)
    ncx = cx + dx * w
    ncy = cy + dy * h
    nw = w * torch.exp(dw)
    nh = h * torch.exp(dh)
    out = torch.stack([ncx - nw / 2, ncy - nh / 2, ncx + nw / 2, ncy + nh / 2], dim=-1)
    if clip_hw is not None:
        hh, ww = clip_hw
        out = torch.stack([out[:, 0].clamp(0, ww), out[:, 1].clamp(0, hh),
                           out[:, 2].clamp(0, ww), out[:, 3].clamp(0, hh)], dim=-1)
    return out


def boxes_to_deltas(anchors: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The inverse of apply_deltas (no weights): the regression targets."""
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = anchors[:, 0] + 0.5 * aw
    acy = anchors[:, 1] + 0.5 * ah
    tw = targets[:, 2] - targets[:, 0]
    th = targets[:, 3] - targets[:, 1]
    tcx = targets[:, 0] + 0.5 * tw
    tcy = targets[:, 1] + 0.5 * th
    return torch.stack([
        (tcx - acx) / aw.clamp_min(1e-6),
        (tcy - acy) / ah.clamp_min(1e-6),
        torch.log(tw.clamp_min(1e-6) / aw.clamp_min(1e-6)),
        torch.log(th.clamp_min(1e-6) / ah.clamp_min(1e-6)),
    ], dim=-1)


def assign_fpn_levels(boxes: torch.Tensor, min_level: int = 2, max_level: int = 5,
                      canonical_level: int = 4, canonical_size: float = 224.0) -> torch.Tensor:
    """FPN level per box (detectron2's assign_boxes_to_levels):
    floor(k0 + log2(sqrt(area) / s0)), clamped to [min_level, max_level]."""
    area = box_area(boxes)
    lvl = torch.floor(canonical_level + torch.log2(
        torch.sqrt(area.clamp_min(1e-6)) / canonical_size + 1e-8))
    return lvl.clamp(min_level, max_level).to(torch.int32)


def _sample_points(boxes: torch.Tensor, out_size: int, stride: int, offsets, device):
    """The bilinear sample of each output cell of each box: (floor y, floor
    x, fraction y, fraction x), each [N, S, S]."""
    x0, y0, x1, y1 = (boxes.float() / stride).unbind(dim=1)
    bw = (x1 - x0).clamp_min(1e-6)[:, None]
    bh = (y1 - y0).clamp_min(1e-6)[:, None]
    cells = torch.arange(out_size, dtype=torch.float32, device=device) + 0.5
    # the reference's compiler divides by the constant as a product with its
    # float32 reciprocal
    inv = float(np.float32(1.0 / out_size))
    gy = y0[:, None] + cells * bh * inv - 0.5  # [N, S]
    gx = x0[:, None] + cells * bw * inv - 0.5
    yy = gy[:, :, None].expand(-1, -1, out_size)  # [N, S, S]
    xx = gx[:, None, :].expand(-1, out_size, -1)
    if offsets is not None:
        yy = yy + offsets[..., 0] * bh[:, :, None]
        xx = xx + offsets[..., 1] * bw[:, :, None]
    y0i, x0i = torch.floor(yy), torch.floor(xx)
    return y0i, x0i, yy - y0i, xx - x0i


def roi_align(features: torch.Tensor, boxes: torch.Tensor, out_size: int = 14,
              stride: int = 1, offsets: torch.Tensor | None = None) -> torch.Tensor:
    """ROI-align with one bilinear sample per output cell (detectron2's
    aligned=True convention: cell centres at half pixels, minus half a pixel),
    zero outside the map.

    features [C, H, W] at `stride`; boxes [N, 4] XYXY in image pixels;
    offsets [N, S, S, 2] optional learned (dy, dx) per cell, in units of the
    box's height and width (the deformable variant). Returns
    [N, C, out_size, out_size]."""
    c, h, w = features.shape
    y0i, x0i, dy, dx = _sample_points(boxes, out_size, stride, offsets, features.device)
    flat = features.reshape(c, h * w)

    def gather(cy, cx):
        inb = (cy >= 0) & (cy < h) & (cx >= 0) & (cx < w)
        idx = cy.clamp(0, h - 1).long() * w + cx.clamp(0, w - 1).long()
        vals = flat[:, idx.reshape(-1)].reshape(c, *idx.shape).transpose(0, 1)
        return vals * inb[:, None].to(features.dtype)

    return (gather(y0i, x0i) * ((1 - dy) * (1 - dx))[:, None]
            + gather(y0i, x0i + 1) * ((1 - dy) * dx)[:, None]
            + gather(y0i + 1, x0i) * (dy * (1 - dx))[:, None]
            + gather(y0i + 1, x0i + 1) * (dy * dx)[:, None])


def roi_align_each(maps: torch.Tensor, boxes: torch.Tensor, out_size: int) -> torch.Tensor:
    """Each map of a stack [N, H, W] through its own box [N, 4] -> [N,
    out_size, out_size]: roi_align of map i alone through box i, in one
    gather."""
    n, h, w = maps.shape
    y0i, x0i, dy, dx = _sample_points(boxes, out_size, 1, None, maps.device)
    flat = maps.reshape(n, h * w)

    def gather(cy, cx):
        inb = (cy >= 0) & (cy < h) & (cx >= 0) & (cx < w)
        idx = cy.clamp(0, h - 1).long() * w + cx.clamp(0, w - 1).long()
        return torch.gather(flat, 1, idx.reshape(n, -1)).reshape(idx.shape) * inb.to(maps.dtype)

    return (gather(y0i, x0i) * ((1 - dy) * (1 - dx))
            + gather(y0i, x0i + 1) * ((1 - dy) * dx)
            + gather(y0i + 1, x0i) * (dy * (1 - dx))
            + gather(y0i + 1, x0i + 1) * (dy * dx))


def roi_align_multilevel(features: dict, boxes: torch.Tensor, out_size: int, strides: dict,
                         min_level: int = 2, max_level: int = 5) -> torch.Tensor:
    """ROI-align from an FPN pyramid ({"p2": [C, H2, W2], ...}, strides
    {"p2": 4, ...}) with area-based level assignment: every box is aligned on
    every level and the assigned level's result kept by a one-hot mask, as
    the reference does. Returns [N, C, out_size, out_size]."""
    lvl = assign_fpn_levels(boxes, min_level, max_level)
    out = None
    for name, stride in strides.items():
        level_idx = int(name[1:])
        if not min_level <= level_idx <= max_level:
            continue
        sel = (lvl == level_idx).to(features[name].dtype)[:, None, None, None]
        pooled = roi_align(features[name], boxes, out_size=out_size, stride=stride)
        out = pooled * sel if out is None else out + pooled * sel
    return out

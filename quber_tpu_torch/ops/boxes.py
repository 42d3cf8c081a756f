"""Box operations (torch, on the tensors' device).

Port of the part of quber_tpu/ops/boxes.py that the UCN zoom-in stage
calls: the single-level ROI-align at stride 1. The rest of that module (the
stride and learned offsets of this function, box encoding, NMS, the FPN
levels) belongs to UOAIS-Net and is not ported yet.
"""

from __future__ import annotations

import torch


def roi_align(features: torch.Tensor, boxes: torch.Tensor, out_size: int = 14) -> torch.Tensor:
    """ROI-align with one bilinear sample per output cell (detectron2's
    aligned=True convention: cell centres at half pixels, minus half a pixel),
    zero outside the map.

    features [C, H, W] at stride 1; boxes [N, 4] XYXY in its pixels. Returns
    [N, C, out_size, out_size]."""
    c, h, w = features.shape
    x0, y0, x1, y1 = boxes.float().unbind(dim=1)
    bw = (x1 - x0).clamp_min(1e-6)[:, None]
    bh = (y1 - y0).clamp_min(1e-6)[:, None]
    cells = torch.arange(out_size, dtype=torch.float32, device=features.device) + 0.5
    gy = y0[:, None] + cells * bh / out_size - 0.5  # [N, S]
    gx = x0[:, None] + cells * bw / out_size - 0.5
    yy = gy[:, :, None].expand(-1, -1, out_size)  # [N, S, S]
    xx = gx[:, None, :].expand(-1, out_size, -1)
    y0i, x0i = torch.floor(yy), torch.floor(xx)
    dy, dx = yy - y0i, xx - x0i
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

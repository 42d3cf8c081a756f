"""Binary morphology and quadruple (TP/TN/FP/FN) error maps (plain torch).

Port of quber_tpu/ops/morphology.py. Eroding N times with a 3x3 all-ones
kernel equals one erosion with a (2N+1)x(2N+1) square, which is two
separable sliding-window minima. Outside the image counts as background
(0) for both erosion and dilation, so a mask touching the border erodes
inward: the input is padded with zeros explicitly.

All functions take [..., H, W] tensors and work on the last two axes.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _window_1d(x: torch.Tensor, size: int, axis: int, minimum: bool) -> torch.Tensor:
    """Sliding-window minimum or maximum of width `size` along `axis` (-1 or
    -2) of [..., H, W], zero border. The window grows by doubling: the
    extremum over [i, i + 2w) is that of the windows at i and i + w, so a
    width of 17 takes five passes of one elementwise op (on bool tensors a
    byte a pixel), where a pooling kernel would visit 17 taps a pixel."""
    if size <= 1:
        return x
    pad = size // 2
    x = F.pad(x, (pad, pad, 0, 0) if axis == -1 else (0, 0, pad, pad))
    if x.dtype == torch.bool:
        combine = torch.logical_and if minimum else torch.logical_or
    else:
        combine = torch.minimum if minimum else torch.maximum
    width = 1  # x[i] holds the extremum over [i, i + width) of the padded input
    while width < size:
        step = min(width, size - width)
        n = x.shape[axis] - step
        x = combine(x.narrow(axis, 0, n), x.narrow(axis, step, n))
        width += step
    return x


def erode(mask: torch.Tensor, iterations: int) -> torch.Tensor:
    """Erode a binary mask `iterations` times with a 3x3 all-ones kernel;
    out-of-image pixels count as background."""
    if iterations <= 0:
        return mask
    size = 2 * iterations + 1
    return _window_1d(_window_1d(mask, size, -2, minimum=True), size, -1, minimum=True)


def dilate(mask: torch.Tensor, iterations: int) -> torch.Tensor:
    """Dilate a binary mask `iterations` times with a 3x3 all-ones kernel."""
    if iterations <= 0:
        return mask
    size = 2 * iterations + 1
    return _window_1d(_window_1d(mask, size, -2, minimum=False), size, -1, minimum=False)


def boundary_width(height: int, width: int, dilation_ratio: float) -> int:
    """Boundary-band width in pixels: round(ratio * image diagonal), min 1."""
    diag = math.sqrt(height ** 2 + width ** 2)
    return max(1, int(round(dilation_ratio * diag)))


def mask_to_boundary(mask: torch.Tensor, dilation_ratio: float = 0.02) -> torch.Tensor:
    """Boundary band of a binary mask: mask - erode(mask, N) with N =
    round(dilation_ratio * diagonal). The band lies inside the mask."""
    n = boundary_width(mask.shape[-2], mask.shape[-1], dilation_ratio)
    if mask.dtype == torch.bool:
        return mask & ~erode(mask, n)
    return mask - erode(mask, n)


def masks_to_fg(masks: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
    """Union foreground of a padded stack [..., N, H, W] -> [..., H, W] f32;
    `valid` [..., N] marks the real instances."""
    m = masks > 0
    if valid is not None:
        m = m & valid[..., None, None]
    return m.any(dim=-3).float()


def masks_to_boundary(masks: torch.Tensor, valid: torch.Tensor | None = None,
                      dilation_ratio: float = 0.01) -> torch.Tensor:
    """Union of the per-mask boundary bands [..., N, H, W] -> [..., H, W] f32.
    (Ratio 0.01 for the union, 0.02 for the single-mask default, as in the
    reference.)"""
    n = boundary_width(masks.shape[-2], masks.shape[-1], dilation_ratio)
    m = masks > 0
    bnd = m & ~erode(m, n)
    if valid is not None:
        bnd = bnd & valid[..., None, None]
    return bnd.any(dim=-3).float()


def error_maps(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """TP/TN/FP/FN maps of two binary maps [..., H, W], stacked on a new
    axis before H -> [..., 4, H, W] f32: TP = gt & pred, TN = !gt & !pred,
    FP = !gt & pred, FN = gt & !pred."""
    g = gt > 0
    p = pred > 0
    return torch.stack([g & p, ~g & ~p, ~g & p, g & ~p], dim=-3).float()


def quadruple_error_maps(gt_masks: torch.Tensor, pred_masks: torch.Tensor,
                         gt_valid: torch.Tensor | None = None,
                         pred_valid: torch.Tensor | None = None,
                         boundary_dilation_ratio: float = 0.01) -> dict:
    """The quadruple-boundary-error target from GT and predicted instance
    stacks [..., N, H, W] (zero-padded, with optional validity [..., N]):
      'mask', 'boundary': [..., 4, H, W] f32 (TP, TN, FP, FN) of the
      foreground union and of the boundary-band union;
      'gt_fg', 'pred_fg', 'gt_boundary', 'pred_boundary': [..., H, W]."""
    gt_fg = masks_to_fg(gt_masks, gt_valid)
    pred_fg = masks_to_fg(pred_masks, pred_valid)
    gt_bnd = masks_to_boundary(gt_masks, gt_valid, boundary_dilation_ratio)
    pred_bnd = masks_to_boundary(pred_masks, pred_valid, boundary_dilation_ratio)
    return {
        "mask": error_maps(gt_fg, pred_fg),
        "boundary": error_maps(gt_bnd, pred_bnd),
        "gt_fg": gt_fg, "pred_fg": pred_fg,
        "gt_boundary": gt_bnd, "pred_boundary": pred_bnd,
    }


def seg2bmap(mask: torch.Tensor) -> torch.Tensor:
    """1-px inner boundary of a binary mask [..., H, W] -> f32: a pixel is
    boundary if any 4-neighbour is background or out of the image."""
    m = mask.float()
    up = F.pad(m, (0, 0, 1, 0))[..., :-1, :]
    down = F.pad(m, (0, 0, 0, 1))[..., 1:, :]
    left = F.pad(m, (1, 0, 0, 0))[..., :, :-1]
    right = F.pad(m, (0, 1, 0, 0))[..., :, 1:]
    interior = torch.minimum(torch.minimum(up, down), torch.minimum(left, right)) * m
    return m - interior

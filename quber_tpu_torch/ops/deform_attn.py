"""Multi-scale deformable attention (torch, on the tensors' device).

Port of quber_tpu/ops/deform_attn.py: for each query, head, level and
point, the level's value map is sampled bilinearly at a learned location
and the samples are summed with learned attention weights. A sample at
normalised (x, y) reads the map at pixel (x * W - 0.5, y * H - 0.5) with
zeros outside it, which is F.grid_sample with align_corners=False and zero
padding at grid = 2 * loc - 1, one call per level.

Shapes (the levels' maps flattened and concatenated):
  value             [B, S, nh, D]   S = sum of H_l * W_l
  spatial_shapes    sequence of (H_l, W_l)
  sampling_locs     [B, Q, nh, L, P, 2]  normalised (x, y)
  attention_weights [B, Q, nh, L, P]
returns             [B, Q, nh * D]
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def ms_deform_attn(value: torch.Tensor, spatial_shapes, sampling_locs: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    b, s, nh, d = value.shape
    _, q, _, nl, np_, _ = sampling_locs.shape
    sizes = [h * w for h, w in spatial_shapes]
    if sum(sizes) != s:
        raise ValueError(f"spatial shapes cover {sum(sizes)} tokens, value has {s}")
    out = None
    for lvl, (v, (h, w)) in enumerate(zip(value.split(sizes, dim=1), spatial_shapes)):
        # [B, HW, nh, D] -> [B * nh, D, H, W]
        v = v.permute(0, 2, 3, 1).reshape(b * nh, d, h, w)
        grid = 2 * sampling_locs[:, :, :, lvl] - 1  # [B, Q, nh, P, 2]
        grid = grid.permute(0, 2, 1, 3, 4).reshape(b * nh, q, np_, 2)
        sampled = F.grid_sample(v, grid, mode="bilinear", padding_mode="zeros",
                                align_corners=False)  # [B * nh, D, Q, P]
        att = attention_weights[:, :, :, lvl].permute(0, 2, 1, 3).reshape(b * nh, 1, q, np_)
        lvl_out = (sampled * att).sum(dim=3)  # [B * nh, D, Q]
        out = lvl_out if out is None else out + lvl_out
    return out.reshape(b, nh, d, q).permute(0, 3, 1, 2).reshape(b, q, nh * d)

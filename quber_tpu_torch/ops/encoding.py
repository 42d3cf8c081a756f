"""Centre-Gaussian / offset encodings of instance mask stacks (plain torch).

Port of quber_tpu/ops/encoding.py. `encode_from_stats` (and its
batched twin `encode_from_stats_batched`) is the plain version the CUDA
encode kernel (ops/kernels.py) is held against; it takes the same
arguments as the kernel: the mask stack, the instances to encode (valid
and non-empty) and their float centroids from `instance_stats`, which is
itself the plain version of the CUDA statistics kernel
(ops.kernels.instance_stats).

Semantics, per pixel p:
  * channel 0: exp(-min_k |p - round(c_k)|^2 / (2 sigma^2)) over the valid
    instances whose window |p - round(c_k)| <= 3 sigma + 1 (per axis) holds
    p; 0 where none does. Rounding is half to even (torch.round).
  * channels 1-2: (cy - y, cx - x) to the FLOAT centroid of the last-wins
    owner (the highest valid index whose mask covers p), divided by (H, W)
    when `normalize`; 0 where no valid mask covers p.

`panoptic_train_targets` builds the training targets of a batch of
ground-truth stacks with the same two rules (unnormalised offsets).
"""

from __future__ import annotations

import torch

_CHUNK = 65536


def instance_stats(masks: torch.Tensor, valid: torch.Tensor | None = None):
    """Areas and float centroids of a mask stack.

    masks [..., N, H, W] bool (a frame, or a batch [B, N, H, W]); valid
    [..., N] bool or None. Returns (areas [..., N] f32, centers_yx
    [..., N, 2] f32); empty or invalid instances get area 0 and centroid
    (0, 0). Per-row and per-column counts are integer sums and the moments
    run in float64, so they are exact; the JAX package sums in float32,
    whose centroids differ from these by up to ~1e-4 px at 480x640. The
    plain version of the CUDA statistics kernel, which returns these values
    bit for bit.
    """
    h, w = masks.shape[-2:]
    m = masks if valid is None else masks & valid[..., None, None]
    rows = m.sum(dim=-1).to(torch.float64)  # [..., N, H]
    cols = m.sum(dim=-2).to(torch.float64)  # [..., N, W]
    areas = rows.sum(dim=-1)
    denom = areas.clamp_min(1.0)
    ys = torch.arange(h, dtype=torch.float64, device=masks.device)
    xs = torch.arange(w, dtype=torch.float64, device=masks.device)
    cy = (rows * ys).sum(dim=-1) / denom
    cx = (cols * xs).sum(dim=-1) / denom
    return areas.float(), torch.stack([cy, cx], dim=-1).float()


def encode_from_stats(masks: torch.Tensor, ok: torch.Tensor, centers: torch.Tensor,
                      sigma: int = 10, normalize: bool = True) -> torch.Tensor:
    """[N, H, W] masks, ok [N] bool (valid and area > 0), centers [N, 2] f32
    -> [3, H, W] f32. The plain version of the CUDA encode kernel."""
    n, h, w = masks.shape
    dev = masks.device
    if n == 0:
        return torch.zeros((3, h, w), dtype=torch.float32, device=dev)
    lim = float(3 * sigma + 1)
    two_s2 = 2.0 * float(sigma) ** 2
    cy = torch.where(ok, centers[:, 0], 0.0).float()
    cx = torch.where(ok, centers[:, 1], 0.0).float()
    ry, rx = torch.round(cy), torch.round(cx)

    # heatmap: exp is monotone, so the max of the windowed Gaussians is the
    # Gaussian of the windowed min of d^2
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w).reshape(-1)
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w).reshape(-1)
    d2min = torch.empty(h * w, dtype=torch.float32, device=dev)
    for s in range(0, h * w, _CHUNK):
        dy = ys[s:s + _CHUNK, None] - ry[None, :]
        dx = xs[s:s + _CHUNK, None] - rx[None, :]
        d2 = dy * dy + dx * dx
        out = (dy.abs() > lim) | (dx.abs() > lim) | ~ok[None, :]
        d2min[s:s + _CHUNK] = torch.where(out, torch.inf, d2).amin(dim=1)
    # exp in float64, rounded once to float32: within 2 ulp of the kernel's
    # expf. (torch 2.13's float32 exp on the CPU has been seen to return
    # values 1e-4 off for part of a tensor on the first call in a process.)
    heat = torch.where(torch.isfinite(d2min),
                       torch.exp(-d2min.double() / two_s2).float(), 0.0)

    # offsets: owner = highest covering valid index (1-based, 0 = unowned)
    ids = torch.arange(1, n + 1, dtype=torch.int32, device=dev)[:, None, None]
    owner = ((masks & ok[:, None, None]).to(torch.int32) * ids).amax(dim=0)
    zero = torch.zeros(1, dtype=torch.float32, device=dev)
    cy_tab = torch.cat([zero, cy])
    cx_tab = torch.cat([zero, cx])
    sy = float(h) if normalize else 1.0
    sx = float(w) if normalize else 1.0
    owned = owner > 0
    owner = owner.long()
    off_y = torch.where(owned, (cy_tab[owner] - ys.view(h, w)) / sy, 0.0)
    off_x = torch.where(owned, (cx_tab[owner] - xs.view(h, w)) / sx, 0.0)
    return torch.stack([heat.view(h, w), off_y, off_x], dim=0)


def encode_from_stats_batched(masks: torch.Tensor, ok: torch.Tensor, centers: torch.Tensor,
                              sigma: int = 10, normalize: bool = True) -> torch.Tensor:
    """[B, N, H, W] masks, ok [B, N] bool, centers [B, N, 2] f32 ->
    [B, 3, H, W] f32, frame by frame. The plain version of the batched CUDA
    encode launch."""
    return torch.stack([encode_from_stats(m, o, c, sigma, normalize)
                        for m, o, c in zip(masks, ok, centers)])


def encode_initial_masks(masks: torch.Tensor, valid: torch.Tensor | None = None,
                         sigma: int = 10, normalize: bool = True) -> torch.Tensor:
    """Initial-prediction encoding: [N, H, W] bool masks -> [3, H, W] f32.
    Instances that are invalid or empty are skipped."""
    if valid is None:
        valid = torch.ones(masks.shape[0], dtype=torch.bool, device=masks.device)
    areas, centers = instance_stats(masks, valid)
    return encode_from_stats(masks, valid & (areas > 0), centers, sigma, normalize)


def panoptic_train_targets(masks: torch.Tensor, valid: torch.Tensor | None = None,
                           is_thing: torch.Tensor | None = None,
                           is_crowd: torch.Tensor | None = None, sigma: int = 10,
                           small_instance_area: int = 4096,
                           small_instance_weight: int = 3, stats=None) -> dict:
    """Panoptic-DeepLab training targets of ground-truth stacks, with the
    QuBER convention that "semantic" is the binary foreground of all segments.

    masks [B, N, H, W] bool (or a frame [N, H, W]); valid, is_thing, is_crowd
    [B, N] bool or None; `stats` = (areas, centers) of masks & valid where
    the caller has them already (ops.kernels.instance_stats), else they are
    computed here. Returns, with the batch axis of the input:
      sem_seg [B, H, W]           union foreground {0, 1}
      center [B, H, W]            max over things of the windowed Gaussian at
                                  the half-to-even rounded centroid
      offset [B, 2, H, W]         (dy, dx) to the float centroid of the last
                                  valid thing covering the pixel
      sem_seg_weights [B, H, W]   1, `small_instance_weight` on small things
      center_weights, offset_weights [B, 1, H, W]  union of non-crowd segments
      centers [B, N, 2], areas [B, N]
    Instances with no pixel count as invalid.
    """
    if masks.dim() == 3:
        one = lambda t: None if t is None else t[None]
        out = panoptic_train_targets(
            masks[None], one(valid), one(is_thing), one(is_crowd), sigma, small_instance_area,
            small_instance_weight, None if stats is None else tuple(t[None] for t in stats))
        return {k: v[0] for k, v in out.items()}
    b, n, h, w = masks.shape
    dev = masks.device
    masks = masks > 0
    if valid is None:
        valid = torch.ones((b, n), dtype=torch.bool, device=dev)
    areas, centers = instance_stats(masks, valid) if stats is None else stats
    valid = valid & (areas > 0)
    thing = valid if is_thing is None else valid & is_thing
    vm = masks & valid[..., None, None]

    sem_seg = vm.any(dim=1).float()
    noncrowd = vm if is_crowd is None else vm & ~is_crowd[..., None, None]
    loss_region = noncrowd.any(dim=1, keepdim=True).float()
    small = (areas < small_instance_area) & thing
    small_region = (vm & small[..., None, None]).any(dim=1)
    sem_weights = torch.where(small_region, float(small_instance_weight), 1.0)

    # centre heatmap: exp is monotone, so the max of the windowed Gaussians is
    # the Gaussian of the windowed min of d^2; the window is a square, so its
    # test and d^2 split into a row part and a column part
    lim = float(3 * sigma + 1)
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    dy = ys[None, None, :] - torch.round(centers[..., 0])[..., None]  # [B, N, H]
    dx = xs[None, None, :] - torch.round(centers[..., 1])[..., None]  # [B, N, W]
    inf = torch.tensor(torch.inf, device=dev)
    dy2 = torch.where((dy.abs() <= lim) & thing[..., None], dy * dy, inf)
    dx2 = torch.where(dx.abs() <= lim, dx * dx, inf)
    d2min = (dy2[..., :, None] + dx2[..., None, :]).amin(dim=1) if n else \
        torch.full((b, h, w), torch.inf, device=dev)
    # exp in float64, rounded once (see encode_from_stats)
    center = torch.where(torch.isfinite(d2min),
                         torch.exp(-d2min.double() / (2.0 * float(sigma) ** 2)).float(), 0.0)

    # offsets: the owner is the highest covering thing (1-based, 0 = unowned)
    ids = torch.arange(1, n + 1, dtype=torch.int16, device=dev)[:, None, None]
    owner = ((masks & thing[..., None, None]) * ids).amax(dim=1).long() if n else \
        torch.zeros((b, h, w), dtype=torch.long, device=dev)
    zero = torch.zeros((b, 1), dtype=torch.float32, device=dev)
    cy_tab = torch.cat([zero, centers[..., 0]], dim=1)
    cx_tab = torch.cat([zero, centers[..., 1]], dim=1)
    owned = owner > 0
    flat = owner.view(b, -1)
    off_y = torch.where(owned, cy_tab.gather(1, flat).view(b, h, w) - ys[:, None], 0.0)
    off_x = torch.where(owned, cx_tab.gather(1, flat).view(b, h, w) - xs[None, :], 0.0)
    return {
        "sem_seg": sem_seg, "center": center,
        "offset": torch.stack([off_y, off_x], dim=1),
        "sem_seg_weights": sem_weights,
        "center_weights": loss_region, "offset_weights": loss_region,
        "centers": centers, "areas": areas,
    }

"""Panoptic-DeepLab centre grouping (plain torch).

Port of quber_tpu/ops/grouping.py:
  1. centre NMS: threshold -> kxk max-pool -> equality keep -> top-k, with
     the survivors re-sorted row-major so instance ids follow scan order;
  2. pixel grouping: argmin over K of |coord + offset - centre|^2, the
     plain version the CUDA group kernel (ops/kernels.py) is held against;
  3. merge: area cull, id compaction, the leftover-foreground stuff blob;
  4. per-instance confidence = mean foreground prob x heatmap value at the
     truncated mask centroid.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_CHUNK = 65536


def nms_heatmap(heatmap: torch.Tensor, threshold: float = 0.1,
                nms_kernel: int = 3) -> torch.Tensor:
    """Suppress non-peak heatmap values to -1; heatmap [..., H, W]."""
    h, w = heatmap.shape[-2:]
    x = torch.where(heatmap > threshold, heatmap, -1.0)
    pooled = F.max_pool2d(x.reshape(-1, 1, h, w), nms_kernel, 1,
                          (nms_kernel - 1) // 2).reshape(x.shape)
    return torch.where(x == pooled, x, -1.0)


def find_instance_centers_batched(heatmaps: torch.Tensor, threshold: float = 0.1,
                                  nms_kernel: int = 3, top_k: int = 200):
    """Peak detection with a fixed-K result per frame: heatmaps [B, H, W] ->
    (centers [B, K, 2] int32 (y, x), valid [B, K] bool). Survivors are the
    NMS peaks strictly greater than max(K-th score, 0), which makes the set
    independent of how top-k breaks ties; they come first, in row-major
    order (a stable sort along the pixel axis of each frame)."""
    b, h, w = heatmaps.shape
    kept = nms_heatmap(heatmaps, threshold, nms_kernel).reshape(b, -1)
    k = min(top_k, kept.shape[1])
    vals, idx = torch.topk(kept, k, dim=1)
    bound = vals[:, k - 1:k].clamp_min(0.0)
    valid = vals > bound
    sort_key = torch.where(valid, idx, torch.iinfo(torch.int64).max)
    order = torch.argsort(sort_key, dim=1, stable=True)
    idx, valid = idx.gather(1, order), valid.gather(1, order)
    centers = torch.stack([idx // w, idx % w], dim=-1).to(torch.int32)
    centers = torch.where(valid[..., None], centers, 0)
    return centers, valid


def find_instance_centers(heatmap: torch.Tensor, threshold: float = 0.1,
                          nms_kernel: int = 3, top_k: int = 200):
    """find_instance_centers_batched for one heatmap [H, W] -> (centers
    [K, 2] int32 (y, x), valid [K] bool)."""
    centers, valid = find_instance_centers_batched(heatmap[None], threshold,
                                                   nms_kernel, top_k)
    return centers[0], valid[0]


def group_pixels(centers: torch.Tensor, valid: torch.Tensor,
                 offsets: torch.Tensor) -> torch.Tensor:
    """1-based id of each pixel's nearest valid centre -> [H, W] int32.

    centers [K, 2] int (y, x); valid [K] bool; offsets [2, H, W] f32. Ties go
    to the lowest index (torch.argmin returns the first minimum), and a
    pixel with every centre invalid gets id 1. The plain version of the
    CUDA group kernel."""
    h, w = offsets.shape[1], offsets.shape[2]
    dev = offsets.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    ly = (ys + offsets[0]).reshape(-1)
    lx = (xs + offsets[1]).reshape(-1)
    cy = centers[:, 0].float()
    cx = centers[:, 1].float()
    pen = torch.where(valid, 0.0, torch.inf)
    ids = torch.empty(h * w, dtype=torch.int64, device=dev)
    for s in range(0, h * w, _CHUNK):
        dy = ly[s:s + _CHUNK, None] - cy[None, :]
        dx = lx[s:s + _CHUNK, None] - cx[None, :]
        ids[s:s + _CHUNK] = torch.argmin(dy * dy + dx * dx + pen[None, :], dim=1)
    return (ids.view(h, w) + 1).to(torch.int32)


def group_pixels_batched(centers: torch.Tensor, valid: torch.Tensor,
                         offsets: torch.Tensor) -> torch.Tensor:
    """centers [B, K, 2], valid [B, K], offsets [B, 2, H, W] -> [B, H, W]
    int32, frame by frame. The plain version of the batched CUDA group
    launch."""
    return torch.stack([group_pixels(c, v, o) for c, v, o in zip(centers, valid, offsets)])


def merge_and_score(fg: torch.Tensor, foreground_prob: torch.Tensor,
                    center_heatmap: torch.Tensor, raw: torch.Tensor,
                    cvalid: torch.Tensor, min_instance_area: int = 512,
                    stuff_area: int = 2048) -> dict:
    """Area cull + id compaction + stuff blob + confidence scores.

    fg [H, W] int {0,1}; raw [H, W] 1-based grouped ids; cvalid [K] bool.
    Per-id statistics are one index_add_ over the columns [count, fg_prob,
    y, x, fg, fg*fg_prob, fg*y, fg*x]; the fg-gated columns of id 0 are the
    stuff region's. Sums run in float64, so counts and coordinate sums are
    exact; centroid means are then taken in float32, as the JAX package does,
    and truncated toward zero."""
    h, w = fg.shape
    k = cvalid.shape[0]
    dev = fg.device
    ins = torch.where(cvalid.any(), raw, 0) * fg  # 0 = no instance
    flat = ins.reshape(-1).long()

    f64 = torch.float64
    ys = torch.arange(h, dtype=f64, device=dev)[:, None].expand(h, w).reshape(-1)
    xs = torch.arange(w, dtype=f64, device=dev)[None, :].expand(h, w).reshape(-1)
    fgf = fg.reshape(-1).to(f64)
    fgp = foreground_prob.reshape(-1).to(f64)
    cols = torch.stack([torch.ones_like(fgf), fgp, ys, xs,
                        fgf, fgf * fgp, fgf * ys, fgf * xs], dim=-1)
    stats = torch.zeros((k + 1, 8), dtype=f64, device=dev).index_add_(0, flat, cols)

    areas = stats[:, 0].to(torch.int32)
    inst_ok = (areas >= min_instance_area) & (torch.arange(k + 1, device=dev) > 0)
    new_ids = torch.where(inst_ok, torch.cumsum(inst_ok.to(torch.int32), 0), 0)
    pan = new_ids[flat].view(h, w)
    num_inst = inst_ok.sum().to(torch.int32)

    stuff_stats = stats[0, 4:]
    stuff_ok = stuff_stats[0] >= stuff_area
    stuff_id = num_inst + 1
    leftover = (fg > 0) & (ins == 0)
    pan = torch.where(stuff_ok & leftover, stuff_id, pan)
    num_total = num_inst + stuff_ok.to(torch.int32)

    m = k + 2
    compact = torch.zeros((m, 4), dtype=f64, device=dev)
    compact.index_add_(0, new_ids.long(), stats[:, :4] * inst_ok[:, None].to(f64))
    compact.index_add_(0, stuff_id.long().view(1),
                       (stuff_stats * stuff_ok.to(f64)).view(1, 4))
    comp = compact.float()
    cnt = comp[:, 0]
    denom = cnt.clamp_min(1.0)
    iy = (comp[:, 2] / denom).to(torch.int32).clamp(0, h - 1).long()
    ix = (comp[:, 3] / denom).to(torch.int32).clamp(0, w - 1).long()
    scores = (comp[:, 1] / denom) * center_heatmap[iy, ix]
    scores = torch.where(torch.arange(m, device=dev) <= num_total, scores, 0.0)
    scores[0] = 0.0
    return {
        "panoptic": pan.to(torch.int32),
        "num_instances": num_total,
        "scores": scores.float(),
        "areas": cnt.to(torch.int32),
    }

"""Mean-shift clustering of per-pixel embeddings with fixed iteration counts.

Port of quber_tpu/ops/meanshift.py (torch, on the tensors' device). Every
data-dependent loop of the UCN clustering is a fixed number of steps, so a
call enqueues its work without waiting on the device:
  * seeds: farthest-point sampling under cosine distance, K - 1 steps of an
    argmin of the running largest similarity;
  * mean-shift: T iterations of ball means, two [N, K] / [K, D] products
    each;
  * seed merging: connected components of the K x K similarity graph by K
    steps of min-label propagation;
  * assignment: the most similar surviving seed above a threshold, then
    clusters below `min_pixels` dropped and the ids compacted.
Embeddings are unit-normalised, so a similarity is a dot product. argmin and
argmax take the first index on a tie, as jnp's do. The Euclidean twins
cluster 3-D centre votes (UOIS-Net-3D).
"""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(dim=dim, keepdim=True) + eps)


def farthest_point_seeds(x: torch.Tensor, num_seeds: int, first=0) -> torch.Tensor:
    """Cosine farthest-point sampling: x [N, D] unit-norm -> int64 indices
    [num_seeds], the first one `first` (an int or a 0-d tensor)."""
    first = torch.as_tensor(first, device=x.device)
    idx = torch.zeros(num_seeds, dtype=torch.int64, device=x.device)
    idx[0] = first
    max_sim = x @ x[first]
    for i in range(1, num_seeds):
        # the next seed: the point least similar to every seed chosen so far
        nxt = torch.argmin(max_sim)
        max_sim = torch.maximum(max_sim, x @ x[nxt])
        idx[i] = nxt
    return idx


def mean_shift(x: torch.Tensor, seeds: torch.Tensor, num_iters: int = 10,
               bandwidth: float = 0.5) -> torch.Tensor:
    """Ball-kernel mean-shift on the unit sphere: x [N, D] unit-norm, seeds
    [K, D]; the ball is {cosine similarity > 1 - bandwidth}. A seed whose
    ball is empty stays. Returns the converged seeds [K, D]."""
    thresh = 1.0 - bandwidth
    seeds = l2_normalize(seeds)
    for _ in range(num_iters):
        w = (x @ seeds.T > thresh).to(x.dtype)  # [N, K]
        num = w.T @ x  # [K, D]
        cnt = w.sum(dim=0)[:, None]
        seeds = l2_normalize(torch.where(cnt > 0, num / cnt.clamp_min(1.0), seeds))
    return seeds


def _min_label_components(adj: torch.Tensor):
    """Connected components of a [K, K] bool graph (self edges included):
    (labels [K] int64, each the component's smallest index; the
    representatives [K] bool)."""
    k = adj.shape[0]
    labels = torch.arange(k, device=adj.device)
    never = torch.full_like(labels, k)
    for _ in range(k):
        labels = torch.where(adj, labels[None, :], never[None, :]).min(dim=1).values
    return labels, labels == torch.arange(k, device=adj.device)


def merge_seeds(seeds: torch.Tensor, merge_threshold: float = 0.9):
    """Connected components over the seeds' similarity graph (an edge where
    the similarity exceeds merge_threshold): (labels [K] int64 in 0..K-1,
    the smallest index of each component; representatives [K] bool)."""
    return _min_label_components(seeds @ seeds.T > merge_threshold)


def farthest_point_seeds_euclidean(x: torch.Tensor, num_seeds: int, first=0) -> torch.Tensor:
    """Euclidean farthest-point sampling: x [N, D] -> int64 indices [num_seeds]."""
    first = torch.as_tensor(first, device=x.device)
    idx = torch.zeros(num_seeds, dtype=torch.int64, device=x.device)
    idx[0] = first
    min_d2 = ((x - x[first]) ** 2).sum(dim=-1)
    for i in range(1, num_seeds):
        nxt = torch.argmax(min_d2)
        min_d2 = torch.minimum(min_d2, ((x - x[nxt]) ** 2).sum(dim=-1))
        idx[i] = nxt
    return idx


def mean_shift_euclidean(x: torch.Tensor, seeds: torch.Tensor, num_iters: int = 10,
                         bandwidth: float = 0.05) -> torch.Tensor:
    """Flat-ball mean-shift in Euclidean space: x [N, D], seeds [K, D]."""
    bw2 = bandwidth * bandwidth
    for _ in range(num_iters):
        d2 = ((x[:, None, :] - seeds[None, :, :]) ** 2).sum(dim=-1)  # [N, K]
        w = (d2 < bw2).to(x.dtype)
        num = w.T @ x
        cnt = w.sum(dim=0)[:, None]
        seeds = torch.where(cnt > 0, num / cnt.clamp_min(1.0), seeds)
    return seeds


def label_counts(labels: torch.Tensor, length: int) -> torch.Tensor:
    """Pixels per label of int64 labels in 0..length-1 (a bincount of fixed
    length, which on the card does not wait for the labels' maximum)."""
    flat = labels.reshape(-1)
    return torch.zeros(length, dtype=torch.int64, device=labels.device).index_add_(
        0, flat, torch.ones_like(flat))


def _compact(raw: torch.Tensor, num_seeds: int, min_pixels: int, shape):
    """Raw labels (0 = background, 1 + seed) -> clusters of >= min_pixels
    pixels renumbered 1..M in seed order, and M as a 0-d tensor."""
    counts = label_counts(raw, num_seeds + 1)
    ok = counts >= min_pixels
    ok[0] = False
    new_ids = torch.where(ok, torch.cumsum(ok.to(torch.int32), 0), 0).to(torch.int32)
    return new_ids[raw].reshape(shape), ok.sum().to(torch.int32)


def cluster_points_euclidean(points: torch.Tensor, fg_mask: torch.Tensor,
                             num_seeds: int = 32, num_iters: int = 10,
                             bandwidth: float = 0.06, merge_distance: float = 0.04,
                             min_pixels: int = 256) -> dict:
    """Centre votes [H, W, 3] and a foreground mask [H, W] -> {"labels" [H, W]
    int32, "num_instances" 0-d int32, "seeds" [K, 3]}: FPS seeds on the
    foreground votes, flat-ball mean-shift, seeds closer than merge_distance
    merged, each foreground pixel given its nearest surviving seed within two
    bandwidths."""
    h, w, d = points.shape
    x = points.reshape(-1, d)
    fg = fg_mask.reshape(-1) > 0

    first = torch.argmax(fg.to(torch.int32))
    far = x + (~fg[:, None]) * 1e6  # background out of the sampling's way
    seeds = x[farthest_point_seeds_euclidean(far, num_seeds, first=first)]
    seeds = mean_shift_euclidean(torch.where(fg[:, None], x, 1e6), seeds, num_iters, bandwidth)

    d2 = ((seeds[:, None] - seeds[None, :]) ** 2).sum(dim=-1)
    _, reps = _min_label_components(d2 < merge_distance ** 2)

    dist = ((x[:, None] - seeds[None]) ** 2).sum(dim=-1)
    dist = torch.where(reps[None, :], dist, torch.inf)
    best_d = dist.min(dim=1).values
    best = torch.argmin(dist, dim=1)
    assigned = fg & (best_d < bandwidth ** 2 * 4)
    raw = torch.where(assigned, best + 1, 0)
    labels, n = _compact(raw, num_seeds, min_pixels, (h, w))
    return {"labels": labels, "num_instances": n, "seeds": seeds}


def cluster_embeddings(embeddings: torch.Tensor, fg_mask: torch.Tensor | None = None,
                       num_seeds: int = 32, num_iters: int = 10, bandwidth: float = 0.5,
                       merge_threshold: float = 0.9, assign_threshold: float = 0.6,
                       min_pixels: int = 256) -> dict:
    """Embeddings [H, W, D] -> {"labels" [H, W] int32 (0 = background,
    1..M in seed order), "num_instances" 0-d int32, "seeds" [K, D]}.
    `fg_mask` [H, W] restricts the clustering to the foreground: background
    pixels are zero for the seed sampling and the mean-shift and get no
    label."""
    h, w, d = embeddings.shape
    x = l2_normalize(embeddings.reshape(-1, d))
    if fg_mask is None:
        fg = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    else:
        fg = fg_mask.reshape(-1) > 0

    # background collapsed onto the zero vector, so the sampling picks
    # foreground structure
    first = torch.argmax(fg.to(torch.int32))
    x_fg = torch.where(fg[:, None], x, 0.0)
    seeds = x[farthest_point_seeds(x_fg, num_seeds, first=first)]
    seeds = mean_shift(x * fg[:, None].to(x.dtype), seeds, num_iters, bandwidth)
    _, reps = merge_seeds(seeds, merge_threshold)

    # a merged seed's pixels go to its component's representative
    rep_sim = torch.where(reps[None, :], x @ seeds.T, -torch.inf)  # [N, K]
    best_sim = rep_sim.max(dim=1).values
    best = torch.argmax(rep_sim, dim=1)
    assigned = fg & (best_sim > assign_threshold)
    raw = torch.where(assigned, best + 1, 0)
    labels, n = _compact(raw, num_seeds, min_pixels, (h, w))
    return {"labels": labels, "num_instances": n, "seeds": seeds}

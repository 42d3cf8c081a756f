"""RICE-class refiner: candidate graph operations on the mask set, a learned
node scorer and a search over the operations (torch, NCHW).

Port of quber_tpu/models/rice.py:
  * NodeScorer: a small GN CNN over a 64x64 [rgb | depth | mask | union of
    the masks] crop of each mask, one plausibility logit each (the SGS-Net
    role), and node_scorer_loss, its training objective;
  * the operations on a fixed stack of MAX_INST slots: merge (of adjacent
    masks), split (2-means on the pixel coordinates), delete;
  * a hypothesis scores the SUM of its valid nodes' logits (a mean would
    reward deleting any below-average node);
  * two searches: greedy (ROUNDS rounds, each trying every delete, split and
    ring-neighbour merge and taking the best only when it beats the
    incumbent by MARGIN) and CEM (CEM_ROUNDS rounds of SAMPLES trajectories
    of DEPTH random operations, the operation distribution refitted to the
    ELITES best, the best hypothesis seen kept when it beats the incumbent
    by MARGIN).

Masks are bool stacks; every sum that a tie can decide is taken in the
reference's order (the hypothesis score slot by slot). The CEM's draws are
Gumbel noise (jax.random.categorical draws argmax(logits + Gumbel)):
`draw_cem_noise` makes it from a torch.Generator, and a caller may hand over
another's.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from quber_tpu_torch.models.layers import ConvNorm, Dense, reset_lecun
from quber_tpu_torch.ops.boxes import roi_align, roi_align_each
from quber_tpu_torch.ops.morphology import dilate
from quber_tpu_torch.ops.zoom import instance_boxes_from_labels


class NodeScorer(nn.Module):
    """Per-mask plausibility from [N, 6, 64, 64] crops -> logits [N]."""

    def __init__(self, norm: str = "GN"):
        super().__init__()
        c = 6
        for i, ch in enumerate((32, 64, 128)):
            self.add_module(f"conv{i}", ConvNorm(c, ch, 3, strides=2, norm=norm, act=F.relu))
            c = ch
        self.fc1 = Dense(128, 64)
        self.fc2 = Dense(64, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_lecun(self, generator)

    def forward(self, x):
        y = self.conv2(self.conv1(self.conv0(x)))
        return self.fc2(F.relu(self.fc1(y.mean(dim=(2, 3)))))[:, 0]


def node_scorer_loss(good_scores, good_valid, bad_scores, bad_valid, margin: float = 0.3):
    """Per-node BCE (plausible nodes -> 1, implausible -> 0) and a hinge
    that the mean plausible score beats the mean implausible one by
    `margin`: {"loss_node_bce", "loss_rank"}."""
    def _mean(x, v):
        v = v.float()
        return (x * v).sum() / v.sum().clamp_min(1.0)

    bce = _mean(F.softplus(-good_scores), good_valid) + _mean(F.softplus(bad_scores), bad_valid)
    rank = (margin - (_mean(good_scores, good_valid) - _mean(bad_scores, bad_valid))).clamp_min(0)
    return {"loss_node_bce": bce, "loss_rank": rank}


def hypothesis_node_crops(image6, masks, valid, crop: int = 64):
    """The scorer's crops of one hypothesis: image6 [6, H, W] in [0, 1],
    masks [N, H, W], valid [N] -> (crops [N, 6, crop, crop]: the first four
    image channels, the mask and the union of the masks through each mask's
    box of the label map; ok [N] bool: valid with a box)."""
    n = masks.shape[0]
    m = masks.float()
    ids = torch.arange(1, n + 1, dtype=torch.int32, device=m.device)
    labels = (m.to(torch.int32) * ids[:, None, None]).amax(dim=0)
    boxes, bvalid = instance_boxes_from_labels(labels, n)
    union = (m.sum(dim=0) > 0).float()
    rgbd = roi_align(image6[:4], boxes, out_size=crop)
    mm = roi_align_each(m, boxes, crop)[:, None]
    uu = roi_align(union[None], boxes, out_size=crop)
    return torch.cat([rgbd, mm, uu], dim=1), valid & bvalid


def split_mask_2means(mask, iters: int = 8):
    """2-means on the pixel coordinates of masks [..., H, W] (each map on its
    own), started on either side of the centroid along the axis of larger
    variance. Returns two disjoint float masks covering each input."""
    h, w = mask.shape[-2:]
    dev = mask.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    m = mask.float()

    def total(t):
        return t.sum(dim=(-2, -1))

    area = total(m).clamp_min(1.0)
    cy, cx = total(m * ys) / area, total(m * xs) / area
    vy = total(m * (ys - cy[..., None, None]) ** 2) / area
    vx = total(m * (xs - cx[..., None, None]) ** 2) / area
    dy, dx = vy.clamp_min(1.0).sqrt(), vx.clamp_min(1.0).sqrt()
    use_y = vy > vx
    c0 = (torch.where(use_y, cy - dy, cy), torch.where(use_y, cx, cx - dx))
    c1 = (torch.where(use_y, cy + dy, cy), torch.where(use_y, cx, cx + dx))

    def near0(c0, c1):
        d0 = (ys - c0[0][..., None, None]) ** 2 + (xs - c0[1][..., None, None]) ** 2
        d1 = (ys - c1[0][..., None, None]) ** 2 + (xs - c1[1][..., None, None]) ** 2
        return d0 <= d1

    for _ in range(iters):
        side = near0(c0, c1)
        a0, a1 = m * side, m * ~side
        s0, s1 = total(a0).clamp_min(1.0), total(a1).clamp_min(1.0)
        c0 = (total(a0 * ys) / s0, total(a0 * xs) / s0)
        c1 = (total(a1 * ys) / s1, total(a1 * xs) / s1)
    side = near0(c0, c1)
    return m * side, m * ~side


def masks_adjacent(masks, dilate_px: int = 5):
    """[..., N, H, W] -> [..., N, N] bool: a mask's dilation meets the other
    mask (never itself)."""
    m = masks.float()
    inter = torch.einsum("...ahw,...bhw->...ab", dilate(m, dilate_px), m)
    n = masks.shape[-3]
    return (inter > 0) & ~torch.eye(n, dtype=torch.bool, device=masks.device)


def _seq_sum(x):
    """The sum over the last axis, element by element in order."""
    s = x[..., 0]
    for k in range(1, x.shape[-1]):
        s = s + x[..., k]
    return s


def _apply_merge(masks, valid, i, j):
    out = masks.clone()
    out[i] = masks[i] | masks[j]
    out[j] = False
    v = valid.clone()
    v[j] = False
    return out, v


def _apply_delete(masks, valid, i):
    out = masks.clone()
    out[i] = False
    v = valid.clone()
    v[i] = False
    return out, v


def _apply_split(masks, valid, i, halves=None):
    """Mask i's 2-means halves into slot i and the first free slot (no
    change when every slot is taken). `halves` may carry the split already
    computed."""
    a, b = split_mask_2means(masks[i]) if halves is None else halves
    slot = int(torch.argmin(valid.to(torch.int32)))
    if valid[slot]:
        return masks.clone(), valid.clone()
    out = masks.clone()
    out[i], out[slot] = a > 0, b > 0
    v = valid.clone()
    v[slot] = True
    return out, v


def draw_cem_noise(generator: torch.Generator, n: int, rounds: int, samples: int,
                   depth: int) -> dict:
    """Gumbel noise for the CEM search, drawn on the generator's device:
    {"op": [rounds, samples, depth, 4], "i": and "j": [rounds, samples,
    depth, n]}, each -log(-log(u)) of u uniform in [tiny, 1)."""
    tiny = float(np.finfo(np.float32).tiny)

    def gumbel(*shape):
        u = torch.rand(shape, generator=generator, device=generator.device)
        return -torch.log(-torch.log(u.clamp_min(tiny)))

    return {"op": gumbel(rounds, samples, depth, 4), "i": gumbel(rounds, samples, depth, n),
            "j": gumbel(rounds, samples, depth, n)}


class RICERefiner:
    """Evaluation wrapper: predict(rgb_path, depth_path, initial_masks,
    fg_mask) -> (refined [N, H, W] bool, None, seconds, fg_mask).

    `params` is a state dict or a flax-layout tree of the NodeScorer; without
    it the scorer is initialised from `seed`. `search` is "greedy" or "cem";
    the CEM's noise comes from a torch.Generator seeded with `seed` on the
    wrapper's device, one for each frame, unless `predict` or `search` is
    handed noise. The seconds count the device work and the copy to the
    host."""

    MAX_INST = 16
    CROP = 64
    ROUNDS = 3       # greedy rounds
    CEM_ROUNDS = 2   # CEM refits
    SAMPLES = 8      # trajectories a CEM round
    DEPTH = 3        # operations a trajectory
    ELITES = 3       # the refit's elite set
    # a hypothesis replaces the incumbent only when it scores this much more
    # (a structural repair moves the summed score by ~+4 to +6, deleting a
    # true object the scorer is unsure of gains < 2)
    MARGIN = 2.0

    def __init__(self, params=None, dataset: str = "OSD", seed: int = 0, search: str = "cem",
                 device="cuda"):
        from quber_tpu_torch.models.from_jax import as_state_dict

        if search not in ("greedy", "cem"):
            raise ValueError(f"search {search}: greedy or cem")
        self.device = torch.device(device)
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        scorer = NodeScorer()
        if params is None:
            scorer.reset_parameters(torch.Generator().manual_seed(seed))
        else:
            scorer.load_state_dict(as_state_dict(params), strict=True)
        self.scorer = scorer.to(self.device).eval()
        self.dataset = dataset
        self.search_mode = search
        self.seed = seed

    def score_hypotheses(self, image6, masks, valid):
        """Summed node scores of hypotheses masks [K, N, H, W] bool, valid
        [K, N] -> [K]."""
        crops, oks = zip(*(hypothesis_node_crops(image6, m, v, crop=self.CROP)
                           for m, v in zip(masks, valid)))
        k, n = valid.shape
        scores = self.scorer(torch.cat(crops)).reshape(k, n)
        return _seq_sum(scores * torch.stack(oks).float())

    def greedy(self, image6, masks, valid):
        """The greedy hill-climb: masks [N, H, W] bool, valid [N] -> the
        refined (masks, valid)."""
        n = self.MAX_INST
        for _ in range(self.ROUNDS):
            base = self.score_hypotheses(image6, masks[None], valid[None])[0]
            halves = split_mask_2means(masks)
            # the gates on the host, in one copy
            v = valid.cpu().tolist()
            area = masks.flatten(1).sum(dim=1).cpu().tolist()
            adj = masks_adjacent(masks).cpu()
            count = sum(v)
            cands, ok = [], []
            for i in range(n):
                cands.append(_apply_delete(masks, valid, i))
                ok.append(v[i] and count > 1)
            for i in range(n):
                cands.append(_apply_split(masks, valid, i, (halves[0][i], halves[1][i])))
                ok.append(v[i] and area[i] > 512 and count < n)
            for i in range(n):
                j = (i + 1) % n
                cands.append(_apply_merge(masks, valid, i, j))
                ok.append(v[i] and v[j] and bool(adj[i, j]))
            scores = torch.full((3 * n,), -torch.inf, device=masks.device)
            idx = [c for c in range(3 * n) if ok[c]]
            if idx:
                scores[idx] = self.score_hypotheses(
                    image6, torch.stack([cands[c][0] for c in idx]),
                    torch.stack([cands[c][1] for c in idx]))
            best = int(torch.argmax(scores))
            if bool(scores[best] > base + self.MARGIN):
                masks, valid = cands[best]
        return masks, valid

    def cem(self, image6, masks, valid, noise: dict):
        """The CEM sampling-tree search with the Gumbel `noise` of
        draw_cem_noise: masks [N, H, W] bool, valid [N] -> (masks, valid)."""
        n, b, t, e = self.MAX_INST, self.SAMPLES, self.DEPTH, self.ELITES
        dev = masks.device
        base = self.score_hypotheses(image6, masks[None], valid[None])[0]
        theta = torch.log(torch.tensor([0.1, 0.3, 0.3, 0.3], device=dev))
        best = (base, masks, valid)
        zero = torch.tensor(0.0, device=dev)
        for r in range(self.CEM_ROUNDS):
            h_masks, h_valid, h_ops = [], [], []
            for s in range(b):
                m, v, ops = masks, valid, []
                for step in range(t):
                    op = int(torch.argmax(noise["op"][r, s, step] + theta))
                    node_logits = torch.where(v, zero, -torch.inf)
                    i = int(torch.argmax(noise["i"][r, s, step] + node_logits))
                    partners = masks_adjacent(m)[i] & v
                    has_partner = bool(partners.any())
                    j = int(torch.argmax(noise["j"][r, s, step]
                                         + torch.where(partners, zero, -torch.inf))) \
                        if has_partner else i
                    can = {1: bool(v[i]) and int(v.sum()) > 1,
                           2: bool(v[i]) and int(m[i].sum()) > 512 and not bool(v.all()),
                           3: bool(v[i]) and has_partner}
                    if op and not can[op]:
                        op = 0
                    if op == 1:
                        m, v = _apply_delete(m, v, i)
                    elif op == 2:
                        m, v = _apply_split(m, v, i)
                    elif op == 3:
                        m, v = _apply_merge(m, v, i, j)
                    ops.append(op)
                h_masks.append(m)
                h_valid.append(v)
                h_ops.append(ops)
            scores = self.score_hypotheses(image6, torch.stack(h_masks), torch.stack(h_valid))
            # the elites: lax.top_k's order (the larger score first, the
            # lower index first on ties)
            elite = torch.sort(-scores, stable=True).indices[:e].tolist()
            ops = torch.tensor([h_ops[k] for k in elite], device=dev)
            freq = F.one_hot(ops, 4).float().mean(dim=(0, 1))
            theta = torch.log(freq + 0.05)
            top = int(torch.argmax(scores))
            if bool(scores[top] > best[0] + self.MARGIN):
                best = (scores[top], h_masks[top], h_valid[top])
        return best[1], best[2]

    @torch.inference_mode()
    def search(self, image6, masks, valid, noise: dict | None = None):
        """image6 [6, H, W] in [0, 1], masks [N, H, W] bool, valid [N] bool on
        the device -> (masks, valid) of the search."""
        if self.search_mode == "greedy":
            return self.greedy(image6, masks, valid)
        if noise is None:
            g = torch.Generator(device=self.device).manual_seed(self.seed)
            noise = draw_cem_noise(g, self.MAX_INST, self.CEM_ROUNDS, self.SAMPLES, self.DEPTH)
        return self.cem(image6, masks, valid, noise)

    def _load(self, rgb_path, depth_path):
        """(BGR, normalised inpainted depth, zero-depth mask) at 640x480."""
        from quber_tpu_torch.evaluation.datasets import EVAL_H, EVAL_W
        from quber_tpu_torch.ops.preprocess import load_rgbd

        return load_rgbd(rgb_path, depth_path, (EVAL_H, EVAL_W))

    def predict(self, rgb_path, depth_path, initial_masks, fg_mask, noise: dict | None = None):
        rgb, depth_n, _ = self._load(rgb_path, depth_path)
        h, w = rgb.shape[:2]
        image6 = np.concatenate([rgb.astype(np.float32) / 255.0,
                                 depth_n.astype(np.float32) / 255.0], -1)
        n = self.MAX_INST
        masks = np.zeros((n, h, w), bool)
        count = min(len(initial_masks), n)
        for i in range(count):
            masks[i] = np.asarray(initial_masks[i]) > 0
        valid = np.zeros((n,), bool)
        valid[:count] = True
        t0 = time.time()
        out_masks, out_valid = self.search(
            torch.from_numpy(np.ascontiguousarray(image6.transpose(2, 0, 1))).to(self.device),
            torch.from_numpy(masks).to(self.device), torch.from_numpy(valid).to(self.device),
            noise)
        out_masks, out_valid = out_masks.cpu().numpy(), out_valid.cpu().numpy()
        out_valid = out_valid & (out_masks.sum(axis=(1, 2)) > 0)
        elapsed = time.time() - t0
        return out_masks[out_valid], None, elapsed, fg_mask

"""MSMFormer base segmenter: a deformable pixel decoder and a mean-shift
query decoder (torch, NCHW).

Port of quber_tpu/models/msmformer.py:
  * two GN ResNet-50 trunks (RGB and XYZ, DeepLab stem, res5 dilated) whose
    res2-res5 features are added;
  * res3-res5 projected to `dim` tokens, `encoder_layers` deformable
    self-attention layers over the concatenated levels (ops/deform_attn),
    then FPN fusion down to stride-4 mask features;
  * `num_queries` learned queries, each decoder layer a von-Mises-Fisher
    mean-shift step over the encoder tokens, self-attention and an FFN;
  * per query a mask (query embedding . mask features) and an objectness
    logit; `masks_from_queries` keeps the confident queries and resolves
    overlaps by the per-pixel argmax.

Modules are named after the flax scopes, so models/from_jax carries a flax
variable tree across by renaming. flax's defaults hold, not torch's: the
LayerNorms' eps is 1e-6, GELU is the tanh approximation, attention scales by
1 / sqrt(head_dim). With dtype bfloat16 every Dense, Conv and LayerNorm
computes in bfloat16 and the model upcasts where the reference does: the
sampling, the upsamples, the mean-shift kernel and the mask logits run in
float32, and the GroupNorms return float32.

The set loss matches queries to instances on the host with a copy of the
reference's `_lap_min_cost` (the shortest-augmenting-path algorithm of
scipy's linear_sum_assignment), under no_grad: it breaks ties as the
reference does, which a random init's saturated mask probabilities need.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from quber_tpu_torch.models.layers import (  # noqa: F401  (set_compute_dtype: callers import it here)
    Conv2d, ConvNorm, ConvTranspose2x2, Dense, LayerNorm, MultiHeadDotProductAttention,
    flax_softmax, set_compute_dtype, upsample_bilinear)
from quber_tpu_torch.models.resnet import ResNetTrunk
from quber_tpu_torch.ops.deform_attn import ms_deform_attn
from quber_tpu_torch.ops.meanshift import l2_normalize, label_counts


def gelu(x):
    """flax nn.gelu: the tanh approximation, op by op in the input's type
    with its constants in that type too (JAX casts them so); in bfloat16
    each step rounds, as XLA's do, jitted or not (torch's F.gelu rounds
    once)."""
    c = {v: torch.tensor(v, dtype=x.dtype, device=x.device)
         for v in (math.sqrt(2 / math.pi), 0.044715, 0.5, 1.0)}
    inner = c[math.sqrt(2 / math.pi)] * (x + c[0.044715] * x ** 3)
    return x * (c[0.5] * (c[1.0] + torch.tanh(inner)))


@torch.no_grad()
def reset_flax_init(model: nn.Module, generator: torch.Generator) -> None:
    """Random init after flax's defaults: LeCun-normal conv and dense kernels
    (std 1 / sqrt(fan_in)), zero biases, identity norms. Modules set their
    own special cases afterwards."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear, ConvTranspose2x2, nn.ConvTranspose2d)):
            w = mod.weight
            # nn.ConvTranspose2d keeps [in, out, kh, kw], the others [out, in, ...]
            fan_in = (w[:, 0].numel() if isinstance(mod, nn.ConvTranspose2d)
                      else w[0].numel())
            w.copy_(torch.randn(w.shape, generator=generator) / math.sqrt(fan_in))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.GroupNorm, LayerNorm, nn.LayerNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()


class DeformableEncoderLayer(nn.Module):
    """Pre-norm deformable self-attention over multi-scale tokens + FFN."""

    def __init__(self, dim: int = 256, num_heads: int = 8, num_points: int = 4,
                 num_levels: int = 3):
        super().__init__()
        self.num_heads, self.num_points, self.num_levels = num_heads, num_points, num_levels
        self.norm1 = LayerNorm(dim)
        self.value_proj = Dense(dim, dim)
        self.offsets = Dense(dim, num_heads * num_levels * num_points * 2)
        self.attn_weights = Dense(dim, num_heads * num_levels * num_points)
        self.out_proj = Dense(dim, dim)
        self.norm2 = LayerNorm(dim)
        self.ffn1 = Dense(dim, dim * 4)
        self.ffn2 = Dense(dim * 4, dim)

    def forward(self, tokens, ref_points, spatial_shapes):
        """tokens [B, S, C]; ref_points [B, S, 2] normalised (x, y)."""
        b, s, c = tokens.shape
        nh, nl, np_ = self.num_heads, self.num_levels, self.num_points
        x = self.norm1(tokens)
        value = self.value_proj(x).reshape(b, s, nh, c // nh)
        offsets = self.offsets(x).reshape(b, s, nh, nl, np_, 2)
        attn = self.attn_weights(x).reshape(b, s, nh, nl * np_)
        attn = flax_softmax(attn).reshape(b, s, nh, nl, np_)
        scales = torch.tensor([[1.0 / w, 1.0 / h] for h, w in spatial_shapes],
                              dtype=torch.float32, device=tokens.device)
        locs = (ref_points[:, :, None, None, None, :]
                + offsets.float() * scales[None, None, None, :, None, :])
        sampled = ms_deform_attn(value.float(), spatial_shapes, locs, attn.float())
        tokens = tokens + self.out_proj(sampled.to(value.dtype))
        y = gelu(self.ffn1(self.norm2(tokens)))
        return tokens + self.ffn2(y)


class MeanShiftDecoderLayer(nn.Module):
    """Query update: a vMF mean-shift step over the pixel embeddings, then
    self-attention and an FFN, each post-normed."""

    def __init__(self, dim: int = 256, num_heads: int = 8, kappa: float = 20.0):
        super().__init__()
        self.kappa = kappa
        self.q_proj = Dense(dim, dim)
        self.p_proj = Dense(dim, dim)
        self.ms_out = Dense(dim, dim)
        self.norm1 = LayerNorm(dim)
        self.self_attn = MultiHeadDotProductAttention(dim, num_heads)
        self.norm2 = LayerNorm(dim)
        self.ffn1 = Dense(dim, dim * 4)
        self.ffn2 = Dense(dim * 4, dim)
        self.norm3 = LayerNorm(dim)

    def forward(self, queries, pixels):
        qn = l2_normalize(self.q_proj(queries).float())
        pn = l2_normalize(self.p_proj(pixels).float())
        w = torch.softmax(self.kappa * torch.einsum("bqd,bsd->bqs", qn, pn), dim=-1)
        shifted = l2_normalize(torch.einsum("bqs,bsd->bqd", w, pn))
        queries = queries + self.ms_out(shifted.to(self.ms_out.compute_dtype))
        queries = self.norm1(queries)
        queries = self.norm2(queries + self.self_attn(queries))
        y = gelu(self.ffn1(queries))
        return self.norm3(queries + self.ffn2(y))


LEVELS = ("res3", "res4", "res5")


class MSMFormer(nn.Module):
    """forward(rgb [B, 3, H, W], xyz [B, 3, H, W]) -> {mask_logits
    [B, Q, H/4, W/4] float32, objectness [B, Q] float32}."""

    def __init__(self, dim: int = 256, num_queries: int = 50, encoder_layers: int = 3,
                 decoder_layers: int = 3, norm: str = "GN", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.num_queries, self.dtype = dim, num_queries, dtype
        self.encoder_layers, self.decoder_layers = encoder_layers, decoder_layers
        kw = dict(depth=50, out_features=("res2", "res3", "res4", "res5"), norm=norm)
        self.rgb_trunk = ResNetTrunk(3, **kw)
        self.depth_trunk = ResNetTrunk(3, **kw)
        ch = self.rgb_trunk.out_channels
        for f in LEVELS:
            self.add_module(f"input_proj_{f}", ConvNorm(ch[f], dim, 1, use_bias=True, norm="GN"))
        for i in range(encoder_layers):
            self.add_module(f"enc_{i}", DeformableEncoderLayer(dim, num_levels=len(LEVELS)))
        self.lateral_res2 = ConvNorm(ch["res2"], dim, 1, use_bias=True, norm="GN")
        self.mask_features = ConvNorm(dim, dim, 3, use_bias=True, norm="GN", act=F.relu)
        self.query_embed = nn.Parameter(torch.zeros(num_queries, dim))
        for i in range(decoder_layers):
            self.add_module(f"dec_{i}", MeanShiftDecoderLayer(dim))
        self.mask_embed = Dense(dim, dim)
        self.objectness = Dense(dim, 1)
        set_compute_dtype(self, dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random init after the flax module's: LeCun-normal kernels, zero
        sampling offsets, queries from N(0, 0.02^2)."""
        reset_flax_init(self, generator)
        for i in range(self.encoder_layers):
            getattr(self, f"enc_{i}").offsets.weight.zero_()
        self.query_embed.copy_(torch.randn(self.query_embed.shape, generator=generator) * 0.02)

    def forward(self, rgb, xyz):
        d = self.dtype
        f_rgb = self.rgb_trunk(rgb.to(d))
        f_xyz = self.depth_trunk(xyz.to(d))
        feats = {k: f_rgb[k] + f_xyz[k] for k in f_rgb}
        b = rgb.shape[0]
        dev = rgb.device
        shapes, tokens, refs = [], [], []
        for f in LEVELS:
            x = getattr(self, f"input_proj_{f}")(feats[f])
            h, w = x.shape[2], x.shape[3]
            shapes.append((h, w))
            tokens.append(x.flatten(2).transpose(1, 2))
            gy = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
            gx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
            refs.append(torch.stack([gx[None, :].expand(h, w), gy[:, None].expand(h, w)],
                                    dim=-1).reshape(-1, 2))
        tokens = torch.cat(tokens, dim=1)
        ref_points = torch.cat(refs, dim=0)[None].expand(b, -1, -1)
        for i in range(self.encoder_layers):
            tokens = getattr(self, f"enc_{i}")(tokens, ref_points, shapes)

        sizes = [h * w for h, w in shapes]
        maps = [t.transpose(1, 2).reshape(b, self.dim, h, w)
                for t, (h, w) in zip(tokens.split(sizes, dim=1), shapes)]
        y = maps[-1]
        for lower in reversed(maps[:-1]):
            y = upsample_bilinear(y.float(), size=lower.shape[2:]).to(d) + lower
        lat2 = self.lateral_res2(feats["res2"])
        y = upsample_bilinear(y.float(), size=lat2.shape[2:]).to(d)
        mask_features = self.mask_features(y + lat2)

        queries = self.query_embed[None].expand(b, -1, -1).to(d)
        for i in range(self.decoder_layers):
            queries = getattr(self, f"dec_{i}")(queries, tokens)
        mask_embed = self.mask_embed(queries)
        mask_logits = torch.einsum("bqc,bchw->bqhw", mask_embed.float(), mask_features.float())
        objectness = self.objectness(queries)[..., 0].float()
        return {"mask_logits": mask_logits, "objectness": objectness}


def _lap_min_cost(cost: np.ndarray) -> np.ndarray:
    """Exact rectangular min-cost assignment, the reference's fixed-shape
    shortest-augmenting-path solver (scipy's algorithm) step for step in
    float32 on the host: cost [N, Q] with N <= Q -> row2col [N], a distinct
    column per row. Following its arithmetic and its first-index argmin,
    it also breaks ties as the reference does."""
    cost = np.asarray(cost, np.float32)
    n, q = cost.shape
    inf = np.float32(3e38)
    u, v = np.zeros(n, np.float32), np.zeros(q, np.float32)
    col2row, row2col = np.full(q, -1), np.full(n, -1)
    for cur in range(n):
        # Dijkstra over reduced costs from row `cur` to a free column
        i, sink, minval = cur, -1, np.float32(0.0)
        d = np.full(q, inf, np.float32)
        visited = np.zeros(q, bool)
        path = np.full(q, -1)
        while sink < 0:
            r = minval + cost[i] - u[i] - v
            upd = ~visited & (r < d)
            d = np.where(upd, r, d)
            path = np.where(upd, i, path)
            masked = np.where(visited, inf, d)
            j = int(np.argmin(masked))
            minval = masked[j]
            visited[j] = True
            if col2row[j] < 0:
                sink = j
            else:
                i = col2row[j]
        # dual update over the alternating tree, then augment along the path
        jvec = np.clip(row2col, 0, q - 1)
        in_tree = (row2col >= 0) & visited[jvec]
        u = u + np.where(np.arange(n) == cur, minval, np.float32(0.0))
        u = u + np.where(in_tree, minval - d[jvec], np.float32(0.0))
        v = v + np.where(visited, d - minval, np.float32(0.0))
        j = sink
        while True:
            i = path[j]
            col2row[j] = i
            j, row2col[i] = row2col[i], j
            if i == cur:
                break
    return row2col


def hungarian_match(cost: torch.Tensor, valid_targets: torch.Tensor) -> torch.Tensor:
    """Min-cost assignment of queries to targets: cost [Q, N], valid_targets
    [N] bool -> match [N] int64, the query of each target (-1 for an invalid
    target). Invalid targets get constant rows, which take whatever column
    the valid rows leave and do not change their assignment. Solved on the
    host (_lap_min_cost) from one copy of the cost, under no_grad."""
    with torch.no_grad():
        rows = torch.where(valid_targets[:, None], cost.T.float(), 0.0)
        match = torch.from_numpy(_lap_min_cost(rows.cpu().numpy())).to(cost.device)
        return torch.where(valid_targets, match, -1)


def _bce_with_logits(x, t):
    return x.clamp_min(0) - x * t + torch.log1p(torch.exp(-x.abs()))


def msmformer_set_loss(outputs: dict, gt_masks: torch.Tensor, gt_valid: torch.Tensor,
                       mask_weight: float = 5.0, dice_weight: float = 5.0,
                       obj_weight: float = 2.0) -> dict:
    """Set-prediction loss (the Mask2Former criterion): queries matched to
    instances on dice + objectness costs, then mask BCE and dice on the
    matched pairs and objectness BCE on every query (1 where matched).

    gt_masks [B, N, h, w] at the mask-logit resolution; gt_valid [B, N]."""
    logits, obj = outputs["mask_logits"], outputs["objectness"]
    parts = []
    for lg, ob, gt, valid in zip(logits, obj, gt_masks, gt_valid):
        q, n = lg.shape[0], gt.shape[0]
        probs = torch.sigmoid(lg).reshape(q, -1)
        t = gt.reshape(n, -1).float()
        inter = probs @ t.T
        denom = probs.sum(-1)[:, None] + t.sum(-1)[None, :]
        cost = 1.0 - (2 * inter + 1) / (denom + 1) - F.logsigmoid(ob)[:, None]
        match = hungarian_match(cost.detach(), valid)
        sel = match.clamp(0, q - 1)
        ml = lg[sel].reshape(n, -1)
        w = valid.float()
        loss_mask = (_bce_with_logits(ml, t).mean(-1) * w).sum() / w.sum().clamp_min(1.0)
        p = torch.sigmoid(ml)
        dice = 1 - (2 * (p * t).sum(-1) + 1) / (p.sum(-1) + t.sum(-1) + 1)
        loss_dice = (dice * w).sum() / w.sum().clamp_min(1.0)
        is_matched = torch.zeros(q, dtype=torch.float32, device=lg.device).scatter_reduce(
            0, sel, w, reduce="amax")
        loss_obj = _bce_with_logits(ob, is_matched).mean()
        parts.append((loss_mask, loss_dice, loss_obj))
    lm, ld, lo = (torch.stack(x) for x in zip(*parts))
    return {"loss_mask": mask_weight * lm.mean(), "loss_dice": dice_weight * ld.mean(),
            "loss_objectness": obj_weight * lo.mean()}


def masks_from_queries(mask_logits: torch.Tensor, objectness: torch.Tensor,
                       score_threshold: float = 0.5, mask_threshold: float = 0.5,
                       min_pixels: int = 64):
    """Confident queries -> a disjoint label map: each pixel takes the
    accepted query of highest probability if it is above mask_threshold;
    queries with fewer than min_pixels pixels are dropped and the rest
    numbered 1.. in query order. Returns (labels [H, W] int32, count 0-d
    int32)."""
    q = mask_logits.shape[0]
    probs = torch.sigmoid(mask_logits)
    accept = torch.sigmoid(objectness) > score_threshold
    gated = torch.where(accept[:, None, None], probs, 0.0)
    best_p = gated.amax(dim=0)
    best = torch.argmax(gated, dim=0)  # the first of equal maxima, as jnp.argmax
    raw = torch.where(best_p > mask_threshold, best + 1, 0)
    counts = label_counts(raw, q + 1)
    ok = (counts >= min_pixels) & (torch.arange(q + 1, device=raw.device) > 0)
    new_ids = torch.where(ok, torch.cumsum(ok.to(torch.int32), 0), 0).to(torch.int32)
    return new_ids[raw], ok.to(torch.int32).sum()


def resize_labels_nearest(labels: torch.Tensor, size) -> torch.Tensor:
    """jax.image.resize(..., "nearest") of an int label map: row i reads
    floor((i + 0.5) * in / out), torch's "nearest-exact"."""
    out = F.interpolate(labels[None, None].float(), size=tuple(size), mode="nearest-exact")
    return out[0, 0].to(labels.dtype)


class MSMFormerBaseModel:
    """Evaluation wrapper: predict(rgb_path, depth_path) -> (masks [N, 480,
    640] bool, None, seconds).

    The reference's flow: the frame read as UCN reads it, a bfloat16 forward
    at 480x640, masks_from_queries at stride 4, nearest-resized to 480x640.
    With zoom-in a second stage runs the network on a 224x224 crop around
    each of up to 16 instances (ops/zoom.py) and keeps the refined query
    that covers most of the instance's own crop. `params` / `params_crop`
    are state dicts or flax-layout trees; without them the net is
    initialised from `seed`. The seconds count the device work and the copy
    of the labels to the host."""

    ZOOM = 224
    MAX_INST = 16
    H, W = 480, 640

    def __init__(self, params=None, dataset: str = "OSD", seed: int = 0, num_queries: int = 50,
                 zoom_in: bool = False, params_crop=None, device="cuda"):
        from quber_tpu_torch.models.from_jax import as_state_dict

        self.device = torch.device(device)
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False

        def make(p):
            model = MSMFormer(num_queries=num_queries, dtype=torch.bfloat16)
            if p is None:
                model.reset_parameters(torch.Generator().manual_seed(seed))
            else:
                model.load_state_dict(as_state_dict(p), strict=True)
            return model.to(self.device).eval()

        self.model = make(params)
        self.model_crop = self.model if params_crop is None else make(params_crop)
        self.dataset = dataset
        self.zoom_in = zoom_in

    def _refine_crops(self, rgb, xyz, full, boxes, valid, ids):
        from quber_tpu_torch.ops.boxes import roi_align

        z = self.ZOOM
        out = self.model_crop(roi_align(rgb, boxes, out_size=z), roi_align(xyz, boxes, out_size=z))
        crops = []
        for i in range(len(ids)):
            lab2, _ = masks_from_queries(out["mask_logits"][i], out["objectness"][i])
            lab2 = resize_labels_nearest(lab2, (z, z))
            crop_lab = roi_align((full == ids[i]).float()[None], boxes[i:i + 1], out_size=z)[0, 0]
            overlap = torch.where(crop_lab > 0.5, lab2, 0)
            counts = label_counts(overlap.long(), self.model_crop.num_queries + 1)
            counts[0] = 0
            main = torch.argmax(counts)
            crops.append(((lab2 == main) & (main > 0) & valid[i]).float())
        return torch.stack(crops)

    @torch.inference_mode()
    def segment(self, rgb: torch.Tensor, xyz: torch.Tensor):
        """Standardised RGB [3, H, W] and XYZ [3, H, W] on the model's device
        -> (labels [H, W] int32, instance count 0-d int32), on the device."""
        out = self.model(rgb[None], xyz[None])
        labels, n = masks_from_queries(out["mask_logits"][0], out["objectness"][0])
        full = resize_labels_nearest(labels, (self.H, self.W))
        if not self.zoom_in:
            return full, n
        from quber_tpu_torch.ops.zoom import zoom_refine_labels

        refined = zoom_refine_labels(
            full, lambda boxes, valid, ids: self._refine_crops(rgb, xyz, full, boxes, valid, ids),
            self.MAX_INST, self.ZOOM)
        return refined, n

    def predict(self, rgb_path, depth_path):
        from quber_tpu_torch.models.ucn import read_rgb_xyz

        rgb_in, xyz = read_rgb_xyz(rgb_path, depth_path, (self.H, self.W))
        t0 = time.time()
        rgb_t = torch.from_numpy(np.ascontiguousarray(rgb_in.transpose(2, 0, 1))).to(self.device)
        xyz_t = torch.from_numpy(np.ascontiguousarray(xyz.transpose(2, 0, 1))).to(self.device)
        labels, n = self.segment(rgb_t, xyz_t)
        labels, n = labels.cpu().numpy(), int(n)
        elapsed = time.time() - t0
        masks = labels[None] == np.arange(1, n + 1)[:, None, None]
        return masks, None, elapsed

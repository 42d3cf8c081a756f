"""MSMFormer in the layout of the reference's released checkpoints (torch,
NCHW).

Port of quber_tpu/models/msmformer_pretrained.py. The released MSMFormer
weights (norm_model_0069999.pth, crop_dec9_model_final.pth) belong to the
"pretrained" meta-architecture, not to models/msmformer.py:
  * the UCN embedding net (models/ucn.UCNEmbeddingNet, RGB and XYZ
    ResNet-34-8s branches added), its output normalised per pixel;
  * a single 3x3 conv to the mask features, the embedding itself as the one
    memory level;
  * `dec_layers` blocks of [mean-shift cross-attention -> mean-shift
    self-attention -> FFN -> row L2 normalisation], post-norm, with sine
    position encodings and learned query features, query positions and
    level embedding; the class and 3-layer mask-embedding heads run before
    the first block and after each.

Mean-shift attention is nn.MultiheadAttention with q and k L2-normalised per
head, logits kappa * cosine (kappa 30) and each head's output normalised
before the heads merge. torch defaults apply here (the reference is torch):
LayerNorm eps 1e-5, exact ReLU. import_zoo.import_msmformer maps a released
state dict onto this module.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from quber_tpu_torch.models.ucn import UCNEmbeddingNet


def position_embedding_sine(h: int, w: int, num_pos_feats: int = 128,
                            temperature: float = 10000.0, device="cpu") -> torch.Tensor:
    """DETR's PositionEmbeddingSine(normalize=True) over an unpadded map:
    [H * W, 2 * num_pos_feats], the y channels first, row-major."""
    scale = 2 * math.pi
    eps = 1e-6
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device)
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device)
    y = y / (y[-1] + eps) * scale
    x = x / (x[-1] + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / num_pos_feats)

    def interleave(v):
        ang = v[:, None] / dim_t
        return torch.stack([torch.sin(ang[:, 0::2]), torch.cos(ang[:, 1::2])],
                           dim=2).reshape(v.shape[0], num_pos_feats)

    pos_y, pos_x = interleave(y), interleave(x)
    grid = torch.cat([pos_y[:, None, :].expand(h, w, num_pos_feats),
                      pos_x[None, :, :].expand(h, w, num_pos_feats)], dim=-1)
    return grid.reshape(h * w, 2 * num_pos_feats)


def _l2n(v, dim=-1):
    return F.normalize(v, dim=dim, eps=1e-12)


class MeanShiftAttention(nn.Module):
    """Hypersphere attention in nn.MultiheadAttention's layout (q / k / v /
    out projections)."""

    def __init__(self, dim: int, heads: int, kappa: float = 30.0):
        super().__init__()
        self.heads, self.kappa = heads, kappa
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, q_in, k_in, v_in, mask=None):
        """q_in [B, L, E], k_in / v_in [B, S, E]; mask additive [B, 1, L, S]."""
        h = self.heads

        def split(t):
            b, l, e = t.shape
            return t.reshape(b, l, h, e // h).transpose(1, 2)

        q = _l2n(split(self.q_proj(q_in)))
        k = _l2n(split(self.k_proj(k_in)))
        v = split(self.v_proj(v_in))
        logits = self.kappa * (q @ k.transpose(-2, -1))
        if mask is not None:
            logits = logits + mask
        out = _l2n(torch.softmax(logits, dim=-1) @ v)
        b, _, l, hd = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, l, h * hd))


class _FFN(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.linear1 = nn.Linear(dim, hidden)
        self.linear2 = nn.Linear(hidden, dim)
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x):
        return self.norm(x + self.linear2(F.relu(self.linear1(x))))


class _MaskEmbedMLP(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.layers_0 = nn.Linear(dim, hidden)
        self.layers_1 = nn.Linear(hidden, hidden)
        self.layers_2 = nn.Linear(hidden, out)

    def forward(self, x):
        return self.layers_2(F.relu(self.layers_1(F.relu(self.layers_0(x)))))


class PretrainedMSMDecoder(nn.Module):
    """The mean-shift transformer decoder over one feature level."""

    def __init__(self, in_channels: int = 64, hidden_dim: int = 256, num_queries: int = 100,
                 nheads: int = 8, dim_feedforward: int = 2048, dec_layers: int = 6,
                 num_classes: int = 2, mask_dim: int = 256, kappa: float = 30.0):
        super().__init__()
        self.hidden_dim, self.num_queries, self.dec_layers = hidden_dim, num_queries, dec_layers
        self.input_proj_0 = nn.Conv2d(in_channels, hidden_dim, 1)
        self.level_embed = nn.Parameter(torch.zeros(1, hidden_dim))
        self.query_feat = nn.Parameter(torch.zeros(num_queries, hidden_dim))
        self.query_embed = nn.Parameter(torch.zeros(num_queries, hidden_dim))
        self.decoder_norm = nn.LayerNorm(hidden_dim, eps=1e-5)
        self.class_embed = nn.Linear(hidden_dim, num_classes + 1)
        self.mask_embed = _MaskEmbedMLP(hidden_dim, hidden_dim, mask_dim)
        for i in range(dec_layers):
            self.add_module(f"cross_attn_{i}", MeanShiftAttention(hidden_dim, nheads, kappa))
            self.add_module(f"cross_norm_{i}", nn.LayerNorm(hidden_dim, eps=1e-5))
            self.add_module(f"self_attn_{i}", MeanShiftAttention(hidden_dim, nheads, kappa))
            self.add_module(f"self_norm_{i}", nn.LayerNorm(hidden_dim, eps=1e-5))
            self.add_module(f"ffn_{i}", _FFN(hidden_dim, dim_feedforward))

    def _heads(self, out, mask_features):
        dec = self.decoder_norm(out)
        logits = self.class_embed(dec)
        masks = torch.einsum("bqc,bchw->bqhw", self.mask_embed(dec), mask_features)
        # keys where sigmoid(mask) < 0.5 are blocked; a row with every key
        # blocked is unblocked
        b, q = masks.shape[:2]
        blocked = torch.sigmoid(masks.reshape(b, q, -1)) < 0.5
        blocked = blocked & ~blocked.all(dim=-1, keepdim=True)
        attn_mask = torch.zeros(blocked.shape, dtype=masks.dtype, device=masks.device)
        attn_mask = attn_mask.masked_fill(blocked, -float("inf"))[:, None]
        return logits, masks, attn_mask.detach()

    def forward(self, feat, mask_features):
        """feat [B, Cin, H, W] (the normalised embedding); mask_features
        [B, mask_dim, H, W]. Returns (pred_logits [B, Q, C + 1], pred_masks
        [B, Q, H, W], aux list of the earlier (logits, masks))."""
        b, _, h, w = feat.shape
        dim = self.hidden_dim
        pos = position_embedding_sine(h, w, dim // 2, device=feat.device)[None]
        src = self.input_proj_0(feat).flatten(2).transpose(1, 2) + self.level_embed[0]
        output = self.query_feat[None].expand(b, -1, -1)
        qpos = self.query_embed[None]
        aux = []
        logits, masks, attn_mask = self._heads(output, mask_features)
        aux.append((logits, masks))
        for i in range(self.dec_layers):
            t2 = getattr(self, f"cross_attn_{i}")(output + qpos, src + pos, src, mask=attn_mask)
            output = getattr(self, f"cross_norm_{i}")(output + t2)
            t2 = getattr(self, f"self_attn_{i}")(output + qpos, output + qpos, output)
            output = getattr(self, f"self_norm_{i}")(output + t2)
            output = _l2n(getattr(self, f"ffn_{i}")(output))
            logits, masks, attn_mask = self._heads(output, mask_features)
            aux.append((logits, masks))
        return logits, masks, aux[:-1]


class PretrainedMSMFormer(nn.Module):
    """The released MSMFormer: UCN backbone, mask-feature conv, decoder.
    The widths are arguments so that tests can run it small; the released
    checkpoints use the defaults."""

    def __init__(self, embed_dim: int = 64, hidden_dim: int = 256, num_queries: int = 100,
                 nheads: int = 8, dim_feedforward: int = 2048, dec_layers: int = 6,
                 num_classes: int = 2, mask_dim: int = 256):
        super().__init__()
        self.backbone = UCNEmbeddingNet(embed_dim)
        self.mask_features = nn.Conv2d(embed_dim, mask_dim, 3, padding=1)
        self.predictor = PretrainedMSMDecoder(embed_dim, hidden_dim, num_queries, nheads,
                                              dim_feedforward, dec_layers, num_classes, mask_dim)

    def forward(self, rgb, xyz):
        """rgb, xyz [B, 3, H, W] -> {pred_logits, pred_masks, aux}."""
        emb = _l2n(self.backbone(rgb, xyz), dim=1)
        logits, masks, aux = self.predictor(emb, self.mask_features(emb))
        return {"pred_logits": logits, "pred_masks": masks, "aux": aux}


def mask_iou_nms(masks: np.ndarray, scores: np.ndarray, thresh: float) -> np.ndarray:
    """The reference wrapper's mask-IoU NMS: indices kept in score order
    (each drops the later ones above `thresh`), then sorted by area."""
    flat = masks.reshape(len(masks), -1).astype(np.float32)
    inter = flat @ flat.T
    areas = np.diag(inter)
    order = np.argsort(-scores)
    kept = []
    while order.size:
        i = order[0]
        kept.append(i)
        iou = inter[i, order[1:]] / (areas[i] + areas[order[1:]] - inter[i, order[1:]] + 1e-9)
        order = order[1:][iou <= thresh]
    kept = np.asarray(kept, int)
    return kept[np.argsort(areas[kept])]


class PretrainedMSMFormerBaseModel:
    """Evaluation wrapper over released MSMFormer weights: predict(rgb_path,
    depth_path) -> (masks [N, H, W] bool, foreground [H, W] bool, seconds).

    The reference wrapper's flow: the frame read as UCN reads it, a forward,
    the queries of class 1 with a score above 0.7 and a non-empty mask
    (sigmoid > 0.5), mask-IoU NMS at 0.7 and the masks sorted by area.
    `params` is a state dict of this module (import_zoo.import_msmformer);
    without it the net is initialised from `seed`. The seconds count the
    forward and the copy of its outputs to the host."""

    def __init__(self, params=None, dataset: str = "OSD", score_thresh: float = 0.7,
                 nms_thresh: float = 0.7, height: int = 480, width: int = 640, seed: int = 0,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        model = PretrainedMSMFormer()
        if params is None:
            from quber_tpu_torch.models.msmformer import reset_flax_init

            reset_flax_init(model, torch.Generator().manual_seed(seed))
            model.backbone.reset_parameters(torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(params, strict=True)
        self.model = model.to(self.device).eval()
        self.dataset = dataset
        self.score_thresh, self.nms_thresh = score_thresh, nms_thresh
        self.height, self.width = height, width

    @torch.inference_mode()
    def segment(self, rgb: torch.Tensor, xyz: torch.Tensor):
        """RGB / XYZ [3, H, W] on the device -> (scores [Q], class [Q], masks
        [Q, H, W] bool) on the device."""
        out = self.model(rgb[None], xyz[None])
        probs = torch.softmax(out["pred_logits"][0], dim=-1)
        return probs[:, 1], torch.argmax(probs, dim=-1), torch.sigmoid(out["pred_masks"][0]) > 0.5

    def predict(self, rgb_path, depth_path):
        from quber_tpu_torch.models.ucn import read_rgb_xyz

        h, w = self.height, self.width
        rgb_in, xyz = read_rgb_xyz(rgb_path, depth_path, (h, w))
        t0 = time.time()
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(2, 0, 1))).to(self.device)  # noqa: E731
        scores, cls, masks = (t.cpu().numpy() for t in self.segment(to(rgb_in), to(xyz)))
        elapsed = time.time() - t0
        keep = (cls == 1) & (scores > self.score_thresh) & masks.any((1, 2))
        masks, scores = masks[keep], scores[keep]
        if not len(masks):
            return np.zeros((0, h, w), bool), np.zeros((h, w), bool), elapsed
        masks = masks[mask_iou_nms(masks, scores, self.nms_thresh)]
        return masks.astype(bool), masks.any(0), elapsed

"""UOAIS-Net base segmenter: an RGB-D FPN Mask R-CNN with amodal heads
(torch, NCHW).

Port of quber_tpu/models/uoais_net.py, a two-stage detector:
  * two standard ResNet-50 trunks (7x7 stem, strided res5) fused per level
    by CBAM attention over their concatenation and a 1x1 conv;
  * FPN p2-p6 (1x1 laterals, nearest top-down, 3x3 outputs, p6 = p5 taken
    every second pixel);
  * a shared RPN head over p2-p6, one anchor size per level, a per-level
    top-k and NMS (ops/boxes.nms_fixed), the kept proposals first;
  * the box head on 7x7 level-assigned ROI-align features, class and box
    regression, NMS on the regressed boxes and the top detections;
  * multi-level coding (the box head's first-conv features, upsampled, fed
    into every mask head) and hierarchical occlusion modelling: visible ->
    amodal -> occlusion heads, each seeing the previous heads' features.

Every shape is fixed: proposals padded to max_proposals and detections to
max_detections, with validity masks. Orders follow the reference on ties:
the per-level top-k and the selections after NMS are stable sorts (lower
index first). Modules are named after the flax scopes (models/from_jax).
With dtype bfloat16 the convolutions and dense layers compute in bfloat16;
the RPN and box outputs, the ROI features and the mask logits are float32,
as in the reference.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from quber_tpu_torch.models.layers import (
    Conv2d, ConvNorm, ConvTranspose2x2, Dense, set_compute_dtype)
from quber_tpu_torch.models.msmformer import reset_flax_init
from quber_tpu_torch.models.resnet import ResNetTrunk
from quber_tpu_torch.ops import boxes as box_ops

FPN_STRIDES = {"p2": 4, "p3": 8, "p4": 16, "p5": 32, "p6": 64}
ANCHOR_SIZES = {"p2": 16, "p3": 32, "p4": 64, "p5": 128, "p6": 256}
ASPECT_RATIOS = (0.5, 1.0, 2.0)
ROI_STRIDES = {k: FPN_STRIDES[k] for k in ("p2", "p3", "p4", "p5")}
LEVELS = ("res2", "res3", "res4", "res5")


def _conv(cin, cout, k, bias=True):
    """flax nn.Conv with SAME-style symmetric padding and a bias."""
    return Conv2d(cin, cout, k, padding=(k - 1) // 2, bias=bias)


def stable_topk(x: torch.Tensor, k: int):
    """(values, indices) of the k largest, ties to the lower index (lax.top_k)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def stable_argsort_desc(x: torch.Tensor) -> torch.Tensor:
    """jnp.argsort(-x): descending, ties to the lower index."""
    return torch.argsort(-x, stable=True)


class CBAM(nn.Module):
    """Channel gate (shared MLP over the mean and max) then spatial gate (7x7
    conv over the channel mean and max)."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = Dense(channels, channels // reduction)
        self.fc2 = Dense(channels // reduction, channels)
        self.spatial = _conv(2, 1, 7)

    def forward(self, x):
        mlp = lambda v: self.fc2(F.relu(self.fc1(v)))  # noqa: E731
        gate_c = torch.sigmoid(mlp(x.mean(dim=(2, 3))) + mlp(x.amax(dim=(2, 3))))
        x = x * gate_c[:, :, None, None]
        s = torch.cat([x.mean(dim=1, keepdim=True), x.amax(dim=1, keepdim=True)], dim=1)
        return x * torch.sigmoid(self.spatial(s))


class RGBDFPN(nn.Module):
    """Dual standard R50 trunks, CBAM concat fusion per level, FPN p2-p6."""

    def __init__(self, dim: int = 256, norm: str = "FrozenBN"):
        super().__init__()
        kw = dict(depth=50, stem_type="basic", stem_out_channels=64, res5_dilation=1,
                  res5_multi_grid=(1, 1, 1), out_features=LEVELS, norm=norm)
        self.rgb_trunk = ResNetTrunk(3, **kw)
        self.depth_trunk = ResNetTrunk(3, **kw)
        ch = self.rgb_trunk.out_channels
        for f in LEVELS:
            self.add_module(f"cbam_{f}", CBAM(2 * ch[f]))
            self.add_module(f"fuse_{f}", ConvNorm(2 * ch[f], ch[f], 1, use_bias=True))
            self.add_module(f"lateral_{f}", _conv(ch[f], dim, 1))
        for p in ("p2", "p3", "p4", "p5"):
            self.add_module(f"output_{p}", _conv(dim, dim, 3))

    def forward(self, rgb, depth):
        f_rgb, f_dep = self.rgb_trunk(rgb), self.depth_trunk(depth)
        lat = {}
        for f in LEVELS:
            y = getattr(self, f"cbam_{f}")(torch.cat([f_rgb[f], f_dep[f]], dim=1))
            lat[f] = getattr(self, f"lateral_{f}")(getattr(self, f"fuse_{f}")(y))
        outs = {}
        y = lat["res5"]
        outs["p5"] = y
        for f, p in (("res4", "p4"), ("res3", "p3"), ("res2", "p2")):
            y = F.interpolate(y.float(), size=lat[f].shape[2:], mode="nearest-exact").to(y.dtype)
            y = y + lat[f]
            outs[p] = y
        outs = {p: getattr(self, f"output_{p}")(v) for p, v in outs.items()}
        outs["p6"] = outs["p5"][:, :, ::2, ::2]
        return outs


class RPNHead(nn.Module):
    """Shared-across-levels RPN head: 3x3 conv + ReLU, 1x1 objectness and
    1x1 deltas."""

    def __init__(self, dim: int = 256, num_anchors: int = 3):
        super().__init__()
        self.conv = _conv(dim, dim, 3)
        self.objectness = _conv(dim, num_anchors, 1)
        self.deltas = _conv(dim, num_anchors * 4, 1)

    def forward(self, x):
        y = F.relu(self.conv(x))
        return self.objectness(y), self.deltas(y)


class MLCBoxHead(nn.Module):
    """Four 3x3 convs; returns (the last's features, the first's)."""

    def __init__(self, dim: int = 256):
        super().__init__()
        for i in range(1, 5):
            self.add_module(f"conv{i}", _conv(dim, dim, 3))

    def forward(self, x):
        first = F.relu(self.conv1(x))
        y = first
        for i in range(2, 5):
            y = F.relu(getattr(self, f"conv{i}")(y))
        return y, first


class MLCExtraction(nn.Module):
    """Deconv 7 -> 14 and two 3x3 convs over the box head's first-conv
    features: the guidance fed into every mask head."""

    def __init__(self, dim: int = 256):
        super().__init__()
        self.deconv = ConvTranspose2x2(dim, dim)
        self.conv1 = _conv(dim, dim, 3)
        self.conv2 = _conv(dim, dim, 3)

    def forward(self, x):
        return F.relu(self.conv2(F.relu(self.conv1(self.deconv(x)))))


class _GuidedHead(nn.Module):
    """The shared front of the HOM heads: the pooled features concatenated
    with the previous heads' features through 3 guidance convs, conv1, the
    MLC features concatenated, 3 MLC convs."""

    def __init__(self, dim: int, n_guidance: int):
        super().__init__()
        self.n_guidance = n_guidance
        if n_guidance:
            gdim = (1 + n_guidance) * dim
            for i, (ci, co) in enumerate(((gdim, gdim), (gdim, gdim), (gdim, dim))):
                self.add_module(f"guide{i}", _conv(ci, co, 3))
        self.conv1 = _conv(dim, dim, 3)
        for i, (ci, co) in enumerate(((2 * dim, 2 * dim), (2 * dim, 2 * dim), (2 * dim, dim))):
            self.add_module(f"mlc{i}", _conv(ci, co, 3))

    def front(self, x, guidance, mlc):
        if self.n_guidance:
            x = torch.cat([x] + list(guidance), dim=1)
            for i in range(3):
                x = F.relu(getattr(self, f"guide{i}")(x))
        x = torch.cat([F.relu(self.conv1(x)), mlc], dim=1)
        for i in range(3):
            x = F.relu(getattr(self, f"mlc{i}")(x))
        return x


class HOMMaskHead(_GuidedHead):
    """One hierarchical mask head: the guided front, conv2-4, deconv and a
    1x1 predictor. Returns (28x28 logits float32, the pre-deconv features)."""

    def __init__(self, dim: int = 256, n_guidance: int = 0):
        super().__init__(dim, n_guidance)
        for i in range(2, 5):
            self.add_module(f"conv{i}", _conv(dim, dim, 3))
        self.deconv = ConvTranspose2x2(dim, dim)
        self.predictor = _conv(dim, 1, 1)

    def forward(self, x, guidance, mlc):
        x = self.front(x, guidance, mlc)
        for i in range(2, 5):
            x = F.relu(getattr(self, f"conv{i}")(x))
        logits = self.predictor(F.relu(self.deconv(x)))[:, 0]
        return logits.float(), x


class OccClsMaskHead(_GuidedHead):
    """The occlusion classifier: the guided front, mean pool, fc + ReLU and a
    2-way predictor. Returns (logits [D, 2] float32, features)."""

    def __init__(self, dim: int = 256, n_guidance: int = 2):
        super().__init__(dim, n_guidance)
        self.fc = Dense(dim, dim)
        self.predictor = Dense(dim, 2)

    def forward(self, x, guidance, mlc):
        x = self.front(x, guidance, mlc)
        y = F.relu(self.fc(x.mean(dim=(2, 3))))
        return self.predictor(y).float(), x


def multilevel_anchors(h: int, w: int, device="cpu") -> dict:
    """Anchors of every FPN level at image size (h, w): {level: [A_l, 4]}."""
    return {name: box_ops.generate_anchors(-(-h // s), -(-w // s), s, sizes=(ANCHOR_SIZES[name],),
                                           aspect_ratios=ASPECT_RATIOS, device=device)
            for name, s in FPN_STRIDES.items()}


class UOAISNet(nn.Module):
    """forward(rgb [1, 3, H, W], depth [1, 3, H, W], gt_proposals=None) ->
    dict of fixed-shape detections: boxes [D, 4], scores [D], valid [D],
    visible / amodal mask logits [D, 28, 28], occlusion logits [D, 2], and
    the training intermediates. H and W are multiples of 64.

    gt_proposals [G, 4] (training): ground-truth boxes spliced into the last
    G proposal slots and ranked into the detections (the reference's
    add_ground_truth_to_proposals), an empty box marking an unused slot."""

    def __init__(self, max_proposals: int = 128, max_detections: int = 32,
                 pre_nms_topk_per_level: int = 128, norm: str = "FrozenBN",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.max_proposals, self.max_detections = max_proposals, max_detections
        self.pre_nms_topk_per_level = pre_nms_topk_per_level
        self.dtype = dtype
        self.backbone = RGBDFPN(norm=norm)
        self.rpn = RPNHead(num_anchors=len(ASPECT_RATIOS))
        self.box_head = MLCBoxHead()
        self.cls = Dense(256, 1)
        self.box_deltas = Dense(256, 4)
        self.mlc = MLCExtraction()
        self.visible_head = HOMMaskHead(n_guidance=0)
        self.amodal_head = HOMMaskHead(n_guidance=1)
        self.occ_head = OccClsMaskHead(n_guidance=2)
        set_compute_dtype(self, dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random init after flax's defaults (LeCun-normal kernels, zero
        biases, identity norms)."""
        reset_flax_init(self, generator)

    def forward(self, rgb, depth, gt_proposals=None):
        d = self.dtype
        h, w = rgb.shape[2], rgb.shape[3]
        dev = rgb.device
        fpn = self.backbone(rgb.to(d), depth.to(d))

        anchors = multilevel_anchors(h, w, dev)
        lvl_scores, lvl_boxes, all_obj, all_deltas = [], [], [], []
        for name in FPN_STRIDES:
            obj, deltas = self.rpn(fpn[name])
            obj = obj[0].permute(1, 2, 0).reshape(-1).float()  # (h, w, a) order
            deltas = deltas[0].permute(1, 2, 0).reshape(-1, 4).float()
            props = box_ops.apply_deltas(anchors[name], deltas, clip_hw=(h, w))
            s, idx = stable_topk(obj, min(self.pre_nms_topk_per_level, obj.shape[0]))
            lvl_scores.append(s)
            lvl_boxes.append(props[idx])
            all_obj.append(obj)
            all_deltas.append(deltas)

        cand_scores = torch.cat(lvl_scores)
        cand_boxes = torch.cat(lvl_boxes)
        keep = box_ops.nms_fixed(cand_boxes.detach(), cand_scores.detach(), 0.7)
        neg_inf = torch.tensor(-float("inf"), device=dev)
        order = stable_argsort_desc(torch.where(keep, cand_scores, neg_inf).detach())
        p = self.max_proposals
        prop_boxes = cand_boxes[order][:p]
        prop_valid = keep[order][:p]
        det_boost = torch.zeros(p, dtype=torch.float32, device=dev)
        if gt_proposals is not None:
            g = gt_proposals.shape[0]
            gt_ok = (gt_proposals[:, 2] > gt_proposals[:, 0]) & (gt_proposals[:, 3] > gt_proposals[:, 1])
            prop_boxes = torch.cat([prop_boxes[:p - g], gt_proposals.float()])
            prop_valid = torch.cat([prop_valid[:p - g], gt_ok])
            det_boost[p - g:] = torch.where(gt_ok, 2.0, 0.0)

        feats = {k: fpn[k][0].float() for k in ROI_STRIDES}
        roi7 = box_ops.roi_align_multilevel(feats, prop_boxes, 7, ROI_STRIDES)
        box_feat, first_feat = self.box_head(roi7.to(d))
        pooled = box_feat.mean(dim=(2, 3))
        cls_logit = self.cls(pooled)[:, 0].float()
        box_deltas = self.box_deltas(pooled).float()
        final_boxes = box_ops.apply_deltas(prop_boxes, box_deltas, clip_hw=(h, w))
        cls_scores = torch.where(prop_valid, torch.sigmoid(cls_logit), 0.0)

        rank_scores = cls_scores + det_boost
        det_keep = box_ops.nms_fixed(final_boxes.detach(),
                                     torch.where(prop_valid, rank_scores, -1.0).detach(), 0.5)
        det_keep = det_keep & prop_valid
        det_order = stable_argsort_desc(torch.where(det_keep, rank_scores, neg_inf).detach())
        det_idx = det_order[:self.max_detections]
        det_boxes = final_boxes[det_idx]
        det_scores = torch.where(det_keep[det_idx], cls_scores[det_idx], 0.0)
        det_valid = det_keep[det_idx]

        mlc = self.mlc(first_feat[det_idx])
        roi14 = box_ops.roi_align_multilevel(feats, det_boxes, 14, ROI_STRIDES).to(d)
        visible, v_feat = self.visible_head(roi14, [], mlc)
        amodal, a_feat = self.amodal_head(roi14, [v_feat], mlc)
        occlusion, _ = self.occ_head(roi14, [v_feat, a_feat], mlc)
        return {
            "boxes": det_boxes, "scores": det_scores, "valid": det_valid,
            "visible_masks": visible, "amodal_masks": amodal, "occlusion": occlusion,
            "anchors": torch.cat(list(anchors.values())),
            "rpn_objectness": torch.cat(all_obj), "rpn_deltas": torch.cat(all_deltas),
            "proposal_boxes": prop_boxes, "proposal_valid": prop_valid,
            "cls_logit": cls_logit, "box_deltas": box_deltas, "det_index": det_idx,
        }


def paste_masks(mask_logits: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
                h: int, w: int, threshold: float = 0.5) -> torch.Tensor:
    """[P, M, M] ROI mask logits -> [P, h, w] bool: each mask sampled
    bilinearly into its box (the inverse mapping, clamped at the mask's
    edges), thresholded after the sigmoid, nothing outside the box or for an
    invalid detection."""
    p, mh, mw = mask_logits.shape
    dev = mask_logits.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    x0, y0, x1, y1 = (c[:, None, None] for c in boxes.float().unbind(dim=1))
    bw = (x1 - x0).clamp_min(1e-3)
    bh = (y1 - y0).clamp_min(1e-3)
    gy = (ys + 0.5 - y0) / bh * mh - 0.5  # [P, h, 1]
    gx = (xs + 0.5 - x0) / bw * mw - 0.5  # [P, 1, w]
    y0i = torch.floor(gy).clamp(0, mh - 1)
    x0i = torch.floor(gx).clamp(0, mw - 1)
    y1i = (y0i + 1).clamp(0, mh - 1)
    x1i = (x0i + 1).clamp(0, mw - 1)
    dy = (gy - y0i).clamp(0, 1)
    dx = (gx - x0i).clamp(0, 1)
    pi = torch.arange(p, device=dev)[:, None, None]

    def at(cy, cx):
        return mask_logits[pi, cy.long(), cx.long()]

    val = (at(y0i, x0i) * (1 - dy) * (1 - dx) + at(y0i, x1i) * (1 - dy) * dx
           + at(y1i, x0i) * dy * (1 - dx) + at(y1i, x1i) * dy * dx)
    inside = (ys >= y0) & (ys < y1) & (xs >= x0) & (xs < x1)
    return (torch.sigmoid(val) > threshold) & inside & valid[:, None, None]


def forced_positives(iou: torch.Tensor, gt_valid: torch.Tensor) -> torch.Tensor:
    """[A] bool: the best anchor of each ground truth (the first of an
    [A, N] IoU column's maxima), set to that ground truth's validity. Where
    two ground truths name one anchor the later one decides, as the
    reference's scatter: an invalid slot's column is all zero, so it names
    anchor 0 and clears it even where a valid ground truth named it."""
    dev = iou.device
    per_gt_best = torch.argmax(iou, dim=0)
    last = torch.full((iou.shape[0],), -1, dtype=torch.long, device=dev).scatter_reduce(
        0, per_gt_best, torch.arange(iou.shape[1], device=dev), reduce="amax")
    return (last >= 0) & gt_valid[last.clamp_min(0)]


def _smooth_l1(x):
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def _bce_with_logits(x, t):
    return x.clamp_min(0) - x * t + torch.log1p(torch.exp(-x.abs()))


def rpn_losses(outputs: dict, gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
               pos_iou: float = 0.7, neg_iou: float = 0.3):
    """(objectness, box) losses of the RPN: anchors above `pos_iou` with a
    ground truth, and each ground truth's best anchor (forced_positives),
    are positive, those below `neg_iou` negative; BCE with positives and
    negatives weighted 1:1, and the smooth-L1 deltas of the positives to
    their best ground truth."""
    anchors = outputs["anchors"]
    iou = torch.where(gt_valid[None, :], box_ops.box_iou(anchors, gt_boxes), 0.0)
    best_iou, best_gt = iou.max(dim=1).values, torch.argmax(iou, dim=1)
    pos = (best_iou > pos_iou) | forced_positives(iou, gt_valid)
    t, fn_ = pos.float(), (best_iou < neg_iou).float()
    w = 0.5 * t / t.sum().clamp_min(1.0) + 0.5 * fn_ / fn_.sum().clamp_min(1.0)
    loss_obj = (_bce_with_logits(outputs["rpn_objectness"], t) * w).sum()
    target_deltas = box_ops.boxes_to_deltas(anchors, gt_boxes[best_gt])
    pw = t[:, None]
    loss_box = (_smooth_l1(outputs["rpn_deltas"] - target_deltas) * pw).sum() / \
        (pw.sum() * 4).clamp_min(1.0)
    return loss_obj, loss_box


def match_proposals(outputs: dict, gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                    pos_iou: float = 0.5):
    """(each proposal's best ground truth [P], whether it is a valid
    proposal matching it above `pos_iou` [P])."""
    piou = torch.where(gt_valid[None, :], box_ops.box_iou(outputs["proposal_boxes"], gt_boxes),
                       0.0)
    p_best, p_gt = piou.max(dim=1).values, torch.argmax(piou, dim=1)
    return p_gt, (p_best > pos_iou) & outputs["proposal_valid"]


def box_regression_loss(outputs: dict, gt_boxes: torch.Tensor, p_gt: torch.Tensor,
                        p_pos: torch.Tensor):
    """Smooth-L1 of the box head's deltas to the matched proposals' ground
    truths."""
    roi_t = box_ops.boxes_to_deltas(outputs["proposal_boxes"], gt_boxes[p_gt])
    rw = p_pos.float()[:, None]
    return (_smooth_l1(outputs["box_deltas"] - roi_t) * rw).sum() / (rw.sum() * 4).clamp_min(1.0)


def uoais_losses(outputs: dict, gt_boxes: torch.Tensor, gt_visible: torch.Tensor,
                 gt_amodal: torch.Tensor, gt_valid: torch.Tensor, rpn_pos_iou: float = 0.7,
                 rpn_neg_iou: float = 0.3, roi_pos_iou: float = 0.5,
                 occluded_rate_threshold: float = 0.05) -> dict:
    """The two-stage detector's losses with IoU-based target assignment, as
    the reference's UOAIS-Net recipe: RPN objectness BCE (positives and
    negatives weighted 1:1) and smooth-L1 deltas on positive anchors; ROI
    classification BCE (1:3) and box regression on matched proposals;
    visible and amodal mask BCE against the ROI-aligned masks of the matched
    instance; a class-balanced 2-way occlusion CE (occluded when 1 -
    |visible| / |amodal| >= 0.05).

    gt_boxes [N, 4] XYXY; gt_visible / gt_amodal [N, H, W]; gt_valid [N]."""
    dev = outputs["anchors"].device
    loss_rpn_obj, loss_rpn_box = rpn_losses(outputs, gt_boxes, gt_valid, rpn_pos_iou,
                                            rpn_neg_iou)
    p_gt, p_pos = match_proposals(outputs, gt_boxes, gt_valid, roi_pos_iou)
    cls = outputs["cls_logit"]
    tc = p_pos.float()
    cv = outputs["proposal_valid"].float()
    cp, cn = tc * cv, (1.0 - tc) * cv
    cw = 0.25 * cp / cp.sum().clamp_min(1.0) + 0.75 * cn / cn.sum().clamp_min(1.0)
    loss_cls = (_bce_with_logits(cls, tc) * cw).sum()
    loss_box = box_regression_loss(outputs, gt_boxes, p_gt, p_pos)

    det_idx = outputs["det_index"]
    d_gt = p_gt[det_idx]
    d_pos = p_pos[det_idx] & outputs["valid"]
    det_boxes = outputs["boxes"]
    n_pos = d_pos.sum().clamp_min(1)

    def mask_loss(logits, gt_masks):
        m = logits.shape[-1]
        # every ground-truth mask aligned on every detection's box, then the
        # matched one taken
        aligned = box_ops.roi_align(gt_masks.float(), det_boxes.detach(), out_size=m)
        target = (aligned[torch.arange(len(d_gt), device=dev), d_gt] > 0.5).float()
        per = _bce_with_logits(logits, target).mean(dim=(1, 2)) * d_pos.float()
        return per.sum() / n_pos

    loss_visible = mask_loss(outputs["visible_masks"], gt_visible)
    loss_amodal = mask_loss(outputs["amodal_masks"], gt_amodal)

    vis_area = gt_visible.float().sum(dim=(1, 2))
    amo_area = gt_amodal.float().sum(dim=(1, 2)).clamp_min(1.0)
    occluded = (1.0 - vis_area / amo_area) >= occluded_rate_threshold
    t_occ = occluded[d_gt].long()
    logp = torch.log_softmax(outputs["occlusion"], dim=-1)
    picked = logp.gather(1, t_occ[:, None])[:, 0]
    n_occ = ((t_occ == 1) & d_pos).sum()
    n_noocc = ((t_occ == 0) & d_pos).sum()
    w_occ = torch.where(t_occ == 1, n_noocc / n_occ.clamp_min(1), 1.0) * d_pos.float()
    loss_occ = -(picked * w_occ).sum() / w_occ.sum().clamp_min(1.0)
    return {
        "loss_rpn_objectness": loss_rpn_obj, "loss_rpn_box": loss_rpn_box,
        "loss_cls": loss_cls, "loss_box": loss_box,
        "loss_visible_mask": loss_visible, "loss_amodal_mask": loss_amodal,
        "loss_occlusion": loss_occ,
    }


def read_bgr_depth(rgb_path: str, depth_path: str, size=(480, 640)):
    """A frame as the reference's UOAIS-Net wrappers read it: BGR uint8
    (cv2.imread, bilinear-resized) and the normalised uint8 depth x3,
    nearest-resized and Telea-inpainted; zeros without a depth."""
    from quber_tpu_torch.data import png
    from quber_tpu_torch.ops.preprocess import load_rgbd, resize_linear

    if not depth_path:
        return (resize_linear(png.imread(rgb_path, bgr=True), size),
                np.zeros(tuple(size) + (3,), np.uint8))
    rgb, depth, _ = load_rgbd(rgb_path, depth_path, size)
    return rgb, depth


class UOAISNetBaseModel:
    """Evaluation wrapper: predict(rgb_path, depth_path) -> (masks [N, 480,
    640] bool, None, seconds): a bfloat16 UOAIS-Net on the raw BGR frame and
    its inpainted normalised depth, the detections with a score above
    `score_threshold` pasted at 480x640 (their visible masks, or with
    `amodal` the amodal ones). The seconds count the device work and the
    copy of the masks to the host, not the host's reading and inpainting."""

    H, W = 480, 640

    def __init__(self, params=None, dataset: str = "OSD", seed: int = 0,
                 score_threshold: float = 0.5, amodal: bool = False, device="cuda"):
        from quber_tpu_torch.models.from_jax import as_state_dict

        self.device = torch.device(device)
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        model = UOAISNet(dtype=torch.bfloat16)
        if params is None:
            model.reset_parameters(torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(as_state_dict(params), strict=True)
        self.model = model.to(self.device).eval()
        self.dataset = dataset
        self.score_threshold = score_threshold
        self.amodal = amodal

    @torch.inference_mode()
    def segment(self, rgb: torch.Tensor, depth: torch.Tensor):
        """BGR [3, H, W] and depth [3, H, W] float32 on the model's device ->
        (masks [D, H, W] bool, ok [D] bool, scores [D]) on the device."""
        out = self.model(rgb[None], depth[None])
        ok = out["valid"] & (out["scores"] > self.score_threshold)
        logits = out["amodal_masks"] if self.amodal else out["visible_masks"]
        return paste_masks(logits, out["boxes"], ok, self.H, self.W), ok, out["scores"]

    def predict(self, rgb_path, depth_path):
        rgb, depth = read_bgr_depth(rgb_path, depth_path, (self.H, self.W))
        t0 = time.time()
        to = lambda a: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a.transpose(2, 0, 1), np.float32)).to(self.device)
        masks, ok, _ = self.segment(to(rgb), to(depth))
        masks, ok = masks.cpu().numpy(), ok.cpu().numpy()
        elapsed = time.time() - t0
        return masks[ok], None, elapsed

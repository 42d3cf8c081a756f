"""The open-vocabulary base segmenters, Detic-class and GroundedSAM-class
(torch, NCHW).

Port of quber_tpu/models/open_vocab.py:
  * hash_tokenize and TextEncoder: the hash-bucket text tower (FNV-1a word
    ids, learned embeddings, masked pre-norm transformer blocks, a masked
    mean pool in float32, L2-normalised); with a CLIP merges file
    (`bpe_path`) make_text_tower builds CLIP's tokenizer and text tower
    (models/clip_text) instead;
  * SingleFPN: the basic-stem R50 trunk, 1x1 laterals, a nearest top-down
    path (jax.image.resize's nearest takes half-pixel centres: torch's
    "nearest-exact"), 3x3 outputs, p6 = p5 taken every second pixel;
  * DeticDetector: the shared RPN over p2-p6 (models/uoais_net), a
    per-level top-k and NMS, the ground-truth boxes spliced into the
    proposals in training, a box head whose class logits are the
    L2-normalised ROI embedding times the text embeddings (scaled by
    exp(logit_scale)), the class-agnostic box regression, NMS, the top
    detections and their 28x28 mask logits;
  * detic_losses: RPN objectness and deltas, the per-class sigmoid BCE
    over the text-similarity logits, box regression and the mask BCE;
  * DeticBaseModel and GroundedSAMBaseModel, the evaluation wrappers.

The detector computes in bfloat16 where the wrappers and the recipe set it
(`dtype`), its RPN outputs, ROI features, embeddings and mask logits in
float32, as the reference's; the text towers compute in float32. Orders
follow the reference on ties (stable top-k and argsorts, the first index of
an argmax). Modules are named after the flax scopes (models/from_jax).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from quber_tpu_torch.models.layers import (
    Conv2d, ConvTranspose2x2, Dense, LayerNorm, MultiHeadDotProductAttention, resize_bilinear,
    set_compute_dtype)
from quber_tpu_torch.models.msmformer import gelu, reset_flax_init
from quber_tpu_torch.models.resnet import ResNetTrunk
from quber_tpu_torch.models.sam_refiner import EVAL_H, EVAL_W, read_bgr
from quber_tpu_torch.models.uoais_net import (
    ASPECT_RATIOS, FPN_STRIDES, ROI_STRIDES, RPNHead, _bce_with_logits, box_regression_loss,
    match_proposals, multilevel_anchors, paste_masks, rpn_losses, stable_argsort_desc,
    stable_topk)
from quber_tpu_torch.ops import boxes as box_ops

# the reference wrapper's per-dataset custom vocabularies
VOCABULARIES = {
    "OCID": (
        "food_box shampoo lemon peach food_can potato flashlight orange pear "
        "sponge ball bowl hand_towel toothpaste apple banana soda_can "
        "cereal_box coffee_mug food_bag keyboard stapler tomato bell_pepper "
        "binder glue_stick instant_noodles kleenex lime marker pitcher_base "
        "master_chef_can tuna_fish_can mini_soccer_ball softball baseball "
        "tennis_ball racquetball golf_ball mug bleach_cleanser drill clamp "
        "chips_can cracker_box pudding_box gelatin_box wood_block sugar_box "
        "foam_brick rubiks_cube lego_duplo nine_hole_peg_test timer"
    ).split(),
    "OSD": (
        "box cereal_box food_box block chips_can mug bowl cookie_can "
        "cylindric_object book cd drinks bottle"
    ).split(),
}

GROUNDING_PROMPT = "A rigid object."  # the reference wrapper's phrase


def hash_tokenize(texts, vocab_size: int = 16384, max_len: int = 16):
    """Words (split at whitespace, '_' and '.') hashed with FNV-1a into ids
    1..vocab_size-1, 0 padding. Returns (ids [B, max_len] int32, mask
    [B, max_len] bool) as numpy arrays."""
    ids = np.zeros((len(texts), max_len), np.int32)
    mask = np.zeros((len(texts), max_len), bool)
    for b, text in enumerate(texts):
        words = text.lower().replace("_", " ").replace(".", " ").split()
        for i, wrd in enumerate(words[:max_len]):
            h = 14695981039346656037
            for ch in wrd.encode():
                h = ((h ^ ch) * 1099511628211) & 0xFFFFFFFFFFFFFFFF
            ids[b, i] = h % (vocab_size - 1) + 1
            mask[b, i] = True
    return ids, mask


class TextEncoder(nn.Module):
    """The hash-token transformer text tower: forward(ids [B, L], mask [B, L])
    -> L2-normalised [B, out_dim] float32. Attention is masked both ways
    (a padding query attends uniformly, flax's lowest-logit mask), the MLP
    takes flax's tanh GELU and the pool is the mean over the real tokens."""

    def __init__(self, vocab_size: int = 16384, dim: int = 256, out_dim: int = 256,
                 depth: int = 2, num_heads: int = 8, max_len: int = 16):
        super().__init__()
        self.depth = depth
        self.token_embed = nn.Embedding(vocab_size, dim)
        self.pos_embed = nn.Parameter(torch.empty(max_len, dim))
        for i in range(depth):
            self.add_module(f"ln_a{i}", LayerNorm(dim))
            self.add_module(f"attn{i}", MultiHeadDotProductAttention(dim, num_heads))
            self.add_module(f"ln_m{i}", LayerNorm(dim))
            self.add_module(f"mlp_up{i}", Dense(dim, 4 * dim))
            self.add_module(f"mlp_down{i}", Dense(4 * dim, dim))
        self.proj = Dense(dim, out_dim)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initialisers: LeCun-normal kernels, zero biases, unit
        norms, the embedding N(0, 1 / dim), the positions N(0, 0.02^2)."""
        reset_flax_init(self, generator)
        w = self.token_embed.weight
        w.copy_(torch.randn(w.shape, generator=generator) / math.sqrt(w.shape[1]))
        self.pos_embed.copy_(torch.randn(self.pos_embed.shape, generator=generator) * 0.02)

    def forward(self, ids, mask):
        ids = ids.long()
        x = self.token_embed(ids) + self.pos_embed[None, :ids.shape[1]]
        attn_mask = mask[:, None, None, :] & mask[:, None, :, None]
        for i in range(self.depth):
            y = getattr(self, f"ln_a{i}")(x)
            x = x + getattr(self, f"attn{i}")(y, attn_mask)
            y = getattr(self, f"mlp_up{i}")(getattr(self, f"ln_m{i}")(x))
            x = x + getattr(self, f"mlp_down{i}")(gelu(y))
        w = mask.float()[..., None]
        pooled = (x.float() * w).sum(dim=1) / w.sum(dim=1).clamp_min(1.0)
        out = self.proj(pooled).float()
        return out / out.norm(dim=-1, keepdim=True).clamp_min(1e-6)


def make_text_tower(texts, bpe_path=None, clip_config=None):
    """The text tower of a vocabulary: CLIP's tokenizer and text tower
    (models/clip_text) when a merges file is given, else the hash tower.
    Returns (module, inputs): `module(*inputs)` embeds `texts`; the inputs
    are CPU tensors, moved with the module."""
    if bpe_path is not None:
        from quber_tpu_torch.models.clip_text import CLIPTextEncoder, CLIPTokenizer

        encoder = CLIPTextEncoder(**(clip_config or {}))
        tokenizer = CLIPTokenizer(bpe_path, context_length=encoder.context_length)
        ids = tokenizer([t.replace("_", " ") for t in texts])
        return encoder, (torch.from_numpy(ids),)
    ids, mask = hash_tokenize(texts)
    return TextEncoder(), (torch.from_numpy(ids), torch.from_numpy(mask))


class SingleFPN(nn.Module):
    """RGB-only R50 (basic stem, strided res5) and FPN p2-p6."""

    def __init__(self, dim: int = 256, norm: str = "FrozenBN"):
        super().__init__()
        levels = ("res2", "res3", "res4", "res5")
        self.levels = levels
        self.trunk = ResNetTrunk(3, depth=50, stem_type="basic", stem_out_channels=64,
                                 res5_dilation=1, res5_multi_grid=(1, 1, 1),
                                 out_features=levels, norm=norm)
        for f in levels:
            self.add_module(f"lateral_{f}", Conv2d(self.trunk.out_channels[f], dim, 1))
        for p in ("p2", "p3", "p4", "p5"):
            self.add_module(f"output_{p}", Conv2d(dim, dim, 3, padding=1))

    def forward(self, rgb):
        feats = self.trunk(rgb)
        lat = {f: getattr(self, f"lateral_{f}")(feats[f]) for f in self.levels}
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


class DeticDetector(nn.Module):
    """forward(rgb [1, 3, H, W], text_embeds [C, D], gt_proposals=None) ->
    dict of fixed-shape detections: boxes [K, 4], scores [K] (the best
    class probability), classes [K], valid [K], masks [K, 28, 28] (logits),
    and the training intermediates detic_losses reads. H and W are
    multiples of 64.

    gt_proposals [G, 4] (training): ground-truth boxes spliced into the
    last G proposal slots, ranked into the detections with a boost of 2, an
    empty box marking an unused slot."""

    def __init__(self, max_proposals: int = 128, max_detections: int = 32,
                 pre_nms_topk_per_level: int = 128, embed_dim: int = 256,
                 norm: str = "FrozenBN", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.max_proposals, self.max_detections = max_proposals, max_detections
        self.pre_nms_topk_per_level = pre_nms_topk_per_level
        self.backbone = SingleFPN(norm=norm)
        self.rpn = RPNHead(num_anchors=len(ASPECT_RATIOS))
        for i in range(4):
            self.add_module(f"conv{i}", Conv2d(256, 256, 3, padding=1))
        self.embed = Dense(256, embed_dim)
        self.logit_scale = nn.Parameter(torch.tensor(4.6))
        self.box_deltas = Dense(256, 4)
        for i in range(4):
            self.add_module(f"mask{i}", Conv2d(256, 256, 3, padding=1))
        self.mask_deconv = ConvTranspose2x2(256, 256)
        self.mask_pred = Conv2d(256, 1, 1)
        set_compute_dtype(self, dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's defaults (LeCun-normal kernels, zero biases, identity
        norms), logit_scale 4.6."""
        reset_flax_init(self, generator)
        self.logit_scale.fill_(4.6)

    def forward(self, rgb, text_embeds, gt_proposals=None):
        d = self.dtype
        h, w = rgb.shape[2], rgb.shape[3]
        dev = rgb.device
        fpn = self.backbone(rgb.to(d))

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
        x = box_ops.roi_align_multilevel(feats, prop_boxes, 7, ROI_STRIDES).to(d)
        for i in range(4):
            x = F.relu(getattr(self, f"conv{i}")(x))
        pooled = x.mean(dim=(2, 3))
        emb = self.embed(pooled).float()
        emb = emb / emb.norm(dim=-1, keepdim=True).clamp_min(1e-6)
        cls_logits = torch.exp(self.logit_scale) * emb @ text_embeds.T  # [P, C]
        box_deltas = self.box_deltas(pooled).float()
        final_boxes = box_ops.apply_deltas(prop_boxes, box_deltas, clip_hw=(h, w))

        cls_prob = torch.sigmoid(cls_logits)
        best_score, best_cls = cls_prob.max(dim=-1).values, torch.argmax(cls_prob, dim=-1)
        best_score = torch.where(prop_valid, best_score, 0.0)
        rank = (best_score + det_boost).detach()
        det_keep = box_ops.nms_fixed(final_boxes.detach(), torch.where(prop_valid, rank, -1.0),
                                     0.5) & prop_valid
        det_idx = stable_argsort_desc(torch.where(det_keep, rank, neg_inf))[:self.max_detections]

        det_boxes = final_boxes[det_idx]
        y = box_ops.roi_align_multilevel(feats, det_boxes, 14, ROI_STRIDES).to(d)
        for i in range(4):
            y = F.relu(getattr(self, f"mask{i}")(y))
        y = F.relu(self.mask_deconv(y))
        mask_logits = self.mask_pred(y)[:, 0]
        return {
            "boxes": det_boxes, "scores": best_score[det_idx], "classes": best_cls[det_idx],
            "valid": det_keep[det_idx], "masks": mask_logits.float(),
            "anchors": torch.cat(list(anchors.values())),
            "rpn_objectness": torch.cat(all_obj), "rpn_deltas": torch.cat(all_deltas),
            "proposal_boxes": prop_boxes, "proposal_valid": prop_valid,
            "cls_logits": cls_logits, "box_deltas": box_deltas, "det_index": det_idx,
        }


def detic_losses(outputs: dict, gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
                 gt_masks: torch.Tensor, gt_valid: torch.Tensor, rpn_pos_iou: float = 0.7,
                 rpn_neg_iou: float = 0.3, roi_pos_iou: float = 0.5) -> dict:
    """The open-vocabulary detector's losses: RPN objectness BCE (positives
    and negatives weighted 1:1) and smooth-L1 deltas on positive anchors;
    per-class sigmoid BCE on the text-similarity logits (a matched proposal
    targets its ground truth's class, the others all zero; 1:3), box
    regression on matched proposals, and the 28x28 mask BCE of the matched
    detections against their ground truth aligned on their boxes.

    gt_boxes [N, 4] XYXY, gt_classes [N] int, gt_masks [N, H, W], gt_valid [N]."""
    loss_rpn_obj, loss_rpn_box = rpn_losses(outputs, gt_boxes, gt_valid, rpn_pos_iou,
                                            rpn_neg_iou)
    p_gt, p_pos = match_proposals(outputs, gt_boxes, gt_valid, roi_pos_iou)
    logits = outputs["cls_logits"]
    # jax.nn.one_hot: a class outside [0, C) is all zero (the one-phrase
    # grounder of the gsam recipe sees its colour classes 1-6 so)
    onehot = (gt_classes[p_gt].long()[:, None]
              == torch.arange(logits.shape[-1], device=logits.device)).float()
    tcls = torch.where(p_pos[:, None], onehot, 0.0)
    cv = outputs["proposal_valid"].float()[:, None]
    cp, cn = tcls * cv, (1.0 - tcls) * cv
    cw = 0.25 * cp / cp.sum().clamp_min(1.0) + 0.75 * cn / cn.sum().clamp_min(1.0)
    loss_cls = (_bce_with_logits(logits, tcls) * cw).sum()
    loss_box = box_regression_loss(outputs, gt_boxes, p_gt, p_pos)

    det_idx = outputs["det_index"]
    d_gt = p_gt[det_idx]
    d_pos = p_pos[det_idx] & outputs["valid"]
    mask_logits = outputs["masks"]
    target = box_ops.roi_align_each(gt_masks[d_gt].float(), outputs["boxes"].detach(),
                                    mask_logits.shape[-1]) > 0.5
    per = _bce_with_logits(mask_logits, target.float()).mean(dim=(1, 2)) * d_pos.float()
    loss_mask = per.sum() / d_pos.sum().clamp_min(1)
    return {"loss_rpn_objectness": loss_rpn_obj, "loss_rpn_box": loss_rpn_box,
            "loss_cls": loss_cls, "loss_box": loss_box, "loss_mask": loss_mask}


def _load(module: nn.Module, params, generator) -> None:
    """`params` (a state dict or a flax-layout tree) into `module`, or a
    random init from `generator`."""
    from quber_tpu_torch.models.from_jax import as_state_dict

    if params is None:
        module.reset_parameters(generator)
    else:
        module.load_state_dict(as_state_dict(params), strict=True)


class DeticBaseModel:
    """Evaluation wrapper (the reference's Detic): predict(rgb_path,
    depth_path) -> (masks [N, 480, 640] bool, None, seconds): a bfloat16
    DeticDetector on the raw BGR frame (0-255) against the vocabulary's text
    embeddings (the dataset's custom vocabulary unless `vocabulary` is
    given; CLIP's tower with `bpe_path`), the detections scoring above
    `confidence_threshold` pasted at 480x640.

    params: {"text": ..., "detector": ...}, each a state dict or a
    flax-layout tree; a seeded init without. The text embeddings are
    computed once, here; `seconds` covers the detector, the pasting and the
    masks' copy to the host."""

    def __init__(self, params=None, dataset: str = "OSD", seed: int = 0,
                 confidence_threshold: float = 0.5, vocabulary=None, bpe_path=None,
                 clip_config=None, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.dataset = dataset
        self.vocabulary = vocabulary or VOCABULARIES.get(dataset, ["object"])
        generator = torch.Generator().manual_seed(seed)
        text, inputs = make_text_tower(self.vocabulary, bpe_path, clip_config)
        _load(text, None if params is None else params["text"], generator)
        self.text_encoder = text.to(self.device).eval()
        self.detector = DeticDetector(dtype=torch.bfloat16)
        _load(self.detector, None if params is None else params["detector"], generator)
        self.detector = self.detector.to(self.device).eval()
        with torch.no_grad():
            self.text_embeds = self.text_encoder(*(t.to(self.device) for t in inputs))
        self.confidence_threshold = confidence_threshold

    @torch.no_grad()
    def segment(self, bgr: torch.Tensor):
        """BGR [3, H, W] float32 (0-255) on the device -> (masks [K, H, W]
        bool, ok [K] bool, scores [K], classes [K]) on the device."""
        out = self.detector(bgr[None], self.text_embeds)
        ok = out["valid"] & (out["scores"] > self.confidence_threshold)
        masks = paste_masks(out["masks"], out["boxes"], ok, EVAL_H, EVAL_W)
        return masks, ok, out["scores"], out["classes"]

    def predict(self, rgb_path, depth_path=None):
        bgr = read_bgr(rgb_path).astype(np.float32)
        t0 = time.perf_counter()
        masks, ok, _, _ = self.segment(torch.from_numpy(bgr.transpose(2, 0, 1).copy())
                                       .to(self.device))
        masks, ok = masks.cpu().numpy(), ok.cpu().numpy()
        return masks[ok], None, time.perf_counter() - t0


def sam_frame(bgr: np.ndarray, size: int) -> np.ndarray:
    """The 640x480 BGR frame as GroundedSAM's SAM takes it: RGB float32
    resized to size x size by OpenCV's float32 bilinear (resize_linear_f32),
    SAM-normalised, [size, size, 3]."""
    from quber_tpu_torch.models.sam_hq import SAM_PIXEL_MEAN, SAM_PIXEL_STD
    from quber_tpu_torch.ops.preprocess import resize_linear_f32

    rgb = torch.from_numpy(np.ascontiguousarray(bgr[..., ::-1].transpose(2, 0, 1), np.float32))
    img = resize_linear_f32(rgb, (size, size)).numpy().transpose(1, 2, 0)
    return (img - SAM_PIXEL_MEAN) / SAM_PIXEL_STD


class GroundedSAMBaseModel:
    """Evaluation wrapper (the reference's GroundingDINO + SamPredictor):
    predict(rgb_path, depth_path) -> (masks [N, 480, 640] bool, None,
    seconds). A bfloat16 DeticDetector grounds `text_prompt` on the raw BGR
    frame (up to `max_boxes` boxes, those above `box_threshold` kept); each
    kept box, scaled into SAM's square frame, prompts a bfloat16 SAMHQ
    (ViT-B at `sam_img_size`, or `sam_arch`, the architecture a recipe
    trained: arch.json); the HQ logits go to 480x640 through
    jax.image.resize's bilinear (layers.resize_bilinear) and are
    thresholded at 0.

    params: {"text": ..., "grounder": ..., "sam": ...}; a seeded init
    without. The prompt's embedding is computed once, here, and only the
    kept boxes are decoded (the reference decodes all max_boxes and drops
    the others: the same masks)."""

    def __init__(self, params=None, dataset: str = "OSD", seed: int = 0,
                 text_prompt: str = GROUNDING_PROMPT, box_threshold: float = 0.10,
                 sam_img_size: int = 512, max_boxes: int = 16, bpe_path=None,
                 clip_config=None, sam_arch=None, device="cuda"):
        from quber_tpu_torch.models.sam_hq import SAMHQ

        self.device = torch.device(device)
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.dataset = dataset
        self.text_prompt = text_prompt
        generator = torch.Generator().manual_seed(seed)
        text, inputs = make_text_tower([text_prompt], bpe_path, clip_config)
        _load(text, None if params is None else params["text"], generator)
        self.text_encoder = text.to(self.device).eval()
        self.grounder = DeticDetector(max_detections=max_boxes, dtype=torch.bfloat16)
        _load(self.grounder, None if params is None else params["grounder"], generator)
        self.grounder = self.grounder.to(self.device).eval()
        if sam_arch is not None:
            arch = dict(sam_arch)
            arch["global_blocks"] = tuple(arch["global_blocks"])
            sam_img_size = arch["img_size"]
            self.sam = SAMHQ(**arch)
        else:
            self.sam = SAMHQ(img_size=sam_img_size)
        _load(self.sam, None if params is None else params["sam"], generator)
        set_compute_dtype(self.sam, torch.bfloat16)
        self.sam = self.sam.to(self.device).eval()
        self.sam_size = sam_img_size
        self.box_threshold = box_threshold
        with torch.no_grad():
            self.text_embeds = self.text_encoder(*(t.to(self.device) for t in inputs))

    @torch.no_grad()
    def segment(self, bgr: torch.Tensor, sam_rgb: torch.Tensor):
        """BGR [3, H, W] float32 (0-255) and SAM's frame [S, S, 3] on the
        device -> (masks [k, H, W] bool of the k kept boxes, ok [K] bool,
        scores [K]) on the device."""
        s = self.sam_size
        out = self.grounder(bgr[None], self.text_embeds)
        ok = out["valid"] & (out["scores"] > self.box_threshold)
        scale = torch.tensor([EVAL_W, EVAL_H, EVAL_W, EVAL_H], dtype=torch.float32,
                             device=bgr.device)
        boxes = out["boxes"][ok] / scale * s
        if not boxes.shape[0]:
            return torch.zeros(0, EVAL_H, EVAL_W, dtype=torch.bool, device=bgr.device), ok, \
                out["scores"]
        embed, interm = self.sam.encode(sam_rgb[None])
        masks_lr = self.sam.decode_box(embed, interm, boxes, False, True)[0][:, 0]
        return resize_bilinear(masks_lr.float(), (EVAL_H, EVAL_W)) > 0, ok, out["scores"]

    def predict(self, rgb_path, depth_path=None):
        bgr = read_bgr(rgb_path).astype(np.float32)
        sam_rgb = sam_frame(bgr, self.sam_size)
        t0 = time.perf_counter()
        masks, _, _ = self.segment(
            torch.from_numpy(bgr.transpose(2, 0, 1).copy()).to(self.device),
            torch.from_numpy(np.ascontiguousarray(sam_rgb)).to(self.device))
        masks = masks.cpu().numpy()
        return masks, None, time.perf_counter() - t0

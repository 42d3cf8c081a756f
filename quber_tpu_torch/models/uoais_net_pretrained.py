"""UOAIS-Net in the layout of the reference's released checkpoint (torch,
NCHW).

Port of quber_tpu/models/uoais_net_pretrained.py: the detectron2
GeneralizedRCNN of the released model_final.pth
(R50_rgbdconcat_mlc_occatmask_hom_concat):
  * two standard R50 trunks (FrozenBN) fused per stage by a 1x1 conv over
    their concatenation, an FPN p2-p5 and p6 = p5 taken every second pixel;
  * the StandardRPNHead over p2-p6 (anchor sizes 16-256, ratios 0.5 / 1 /
    2, offset 0), the top 1000 a level, NMS 0.7 per level, the top 1000
    overall;
  * the box head (4 convs, class and box layers over the NCHW flatten),
    deltas decoded with weights (10, 10, 5, 5), score threshold 0.5, NMS
    0.5, the top 100;
  * multi-level coding and the visible -> amodal -> occlusion heads, each
    seeing the ROI features and the previous heads' features.

Module names are the flax port's, which import_zoo.import_uoais_net fills
from a released state dict. The selections keep the reference's order on
ties (stable sorts). torch's ConvTranspose2d and the NCHW flatten are the
reference's own, so their weights are taken as they are.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from quber_tpu_torch.models.layers import ConvNorm
from quber_tpu_torch.models.resnet import ResNetTrunk
from quber_tpu_torch.models.uoais_net import stable_topk
from quber_tpu_torch.ops import boxes as box_ops

RPN_SIZES = {"p2": 16, "p3": 32, "p4": 64, "p5": 128, "p6": 256}
STRIDES = {"p2": 4, "p3": 8, "p4": 16, "p5": 32, "p6": 64}
ROI_STRIDES = {n: STRIDES[n] for n in ("p2", "p3", "p4", "p5")}
ASPECT_RATIOS = (0.5, 1.0, 2.0)
SCALE_CLAMP = 4.135166556742356  # log(1000 / 16), detectron2's Box2BoxTransform


def _cn(cin, cout, k=3, strides=1, act=F.relu):
    return ConvNorm(cin, cout, k, strides=strides, use_bias=True, act=act)


class MaskHeadHOM(nn.Module):
    """Visible / amodal head: guidance convs, fcn1, MLC fusion, fcn2-4,
    deconv and a 1x1 predictor."""

    def __init__(self, prefix: str, n_guidance: int, conv_dim: int = 256):
        super().__init__()
        c, g = conv_dim, n_guidance * conv_dim
        self.prefix = prefix
        for i, (ci, co) in enumerate(((g, g), (g, g), (g, c))):
            self.add_module(f"{prefix}_guidance_layer{i}", _cn(ci, co))
        self.add_module(f"{prefix}_mask_fcn1", _cn(c, c))
        for i, (ci, co) in enumerate(((2 * c, 2 * c), (2 * c, 2 * c), (2 * c, c))):
            self.add_module(f"{prefix}_mlc_layer{i}", _cn(ci, co))
        for k in range(2, 5):
            self.add_module(f"{prefix}_mask_fcn{k}", _cn(c, c))
        self.deconv = nn.ConvTranspose2d(c, c, 2, stride=2)
        self.predictor = _cn(c, 1, 1, act=None)

    def forward(self, x, mlc):
        p = self.prefix
        for i in range(3):
            x = getattr(self, f"{p}_guidance_layer{i}")(x)
        x = torch.cat([getattr(self, f"{p}_mask_fcn1")(x), mlc], dim=1)
        for i in range(3):
            x = getattr(self, f"{p}_mlc_layer{i}")(x)
        for k in range(2, 5):
            x = getattr(self, f"{p}_mask_fcn{k}")(x)
        logits = self.predictor(F.relu(self.deconv(x)))
        return logits[:, 0], x


class OccClsHead(nn.Module):
    """Occlusion classifier: guidance convs, fcn1, MLC fusion, fcn2 at
    stride 2, fcn3-4, the NCHW flatten and a 2-way linear layer."""

    def __init__(self, conv_dim: int = 256):
        super().__init__()
        c, g = conv_dim, 3 * conv_dim
        for i, (ci, co) in enumerate(((g, g), (g, g), (g, c))):
            self.add_module(f"occlusion_guidance_layer{i}", _cn(ci, co))
        self._occ_cls_fcn1 = _cn(c, c)
        for i, (ci, co) in enumerate(((2 * c, 2 * c), (2 * c, 2 * c), (2 * c, c))):
            self.add_module(f"occ_cls__mlc_layer{i}", _cn(ci, co))
        self._occ_cls_fcn2 = _cn(c, c, strides=2)
        self._occ_cls_fcn3 = _cn(c, c)
        self._occ_cls_fcn4 = _cn(c, c)
        self.predictor = nn.Linear(c * 7 * 7, 2)

    def forward(self, x, mlc):
        for i in range(3):
            x = getattr(self, f"occlusion_guidance_layer{i}")(x)
        x = torch.cat([self._occ_cls_fcn1(x), mlc], dim=1)
        for i in range(3):
            x = getattr(self, f"occ_cls__mlc_layer{i}")(x)
        x = self._occ_cls_fcn4(self._occ_cls_fcn3(self._occ_cls_fcn2(x)))
        return self.predictor(x.flatten(1))


class UOAISNetPretrained(nn.Module):
    """forward(x [6, H, W]: BGR + 3 x depth, pixel means subtracted; H and W
    multiples of 64) -> boxes [D, 4], scores [D], valid [D], visible /
    amodal mask logits [D, 28, 28], occlusion logits [D, 2]."""

    def __init__(self, fpn_dim: int = 256, conv_dim: int = 256, rpn_pre_nms_topk: int = 1000,
                 rpn_post_nms_topk: int = 1000, rpn_nms_thresh: float = 0.7,
                 score_thresh: float = 0.5, nms_thresh: float = 0.5, detections: int = 100):
        super().__init__()
        self.rpn_pre_nms_topk, self.rpn_post_nms_topk = rpn_pre_nms_topk, rpn_post_nms_topk
        self.rpn_nms_thresh, self.score_thresh = rpn_nms_thresh, score_thresh
        self.nms_thresh, self.detections = nms_thresh, detections
        kw = dict(depth=50, stem_type="basic", stem_out_channels=64, res5_dilation=1,
                  res5_multi_grid=(1, 1, 1), out_features=("res2", "res3", "res4", "res5"),
                  norm="FrozenBN")
        self.bottom_up_rgb = ResNetTrunk(3, **kw)
        self.bottom_up_depth = ResNetTrunk(3, **kw)
        ch = self.bottom_up_rgb.out_channels
        for s in (2, 3, 4, 5):
            c = ch[f"res{s}"]
            self.add_module(f"fusion_layer_{s}", _cn(2 * c, c, 1, act=None))
            self.add_module(f"fpn_lateral{s}", _cn(c, fpn_dim, 1, act=None))
            self.add_module(f"fpn_output{s}", _cn(fpn_dim, fpn_dim, 3, act=None))
        a = len(ASPECT_RATIOS)
        self.rpn_conv = _cn(fpn_dim, fpn_dim, 3)
        self.rpn_objectness = _cn(fpn_dim, a, 1, act=None)
        self.rpn_anchor_deltas = _cn(fpn_dim, a * 4, 1, act=None)
        for i in range(1, 5):
            self.add_module(f"box_head_conv{i}", _cn(fpn_dim if i == 1 else conv_dim, conv_dim))
        self.cls_score = nn.Linear(conv_dim * 7 * 7, 2)
        self.bbox_pred = nn.Linear(conv_dim * 7 * 7, 4)
        self.extraction_mlc_layer0 = nn.ConvTranspose2d(conv_dim, conv_dim, 2, stride=2)
        self.extraction_mlc_layer1 = _cn(conv_dim, conv_dim)
        self.extraction_mlc_layer2 = _cn(conv_dim, conv_dim)
        self.visible_mask_head = MaskHeadHOM("visible", 1, conv_dim)
        self.amodal_mask_head = MaskHeadHOM("amodal", 2, conv_dim)
        self.occ_cls_mask_head = OccClsHead(conv_dim)

    def forward(self, x):
        img_h, img_w = x.shape[1], x.shape[2]
        dev = x.device
        rgb = self.bottom_up_rgb(x[None, :3])
        dep = self.bottom_up_depth(x[None, 3:6])
        lat = {s: getattr(self, f"fpn_lateral{s}")(getattr(self, f"fusion_layer_{s}")(
            torch.cat([rgb[f"res{s}"], dep[f"res{s}"]], dim=1))) for s in (2, 3, 4, 5)}
        pyramid = {}
        prev = lat[5]
        pyramid["p5"] = self.fpn_output5(prev)
        for s in (4, 3, 2):
            prev = lat[s] + F.interpolate(prev, scale_factor=2, mode="nearest")
            pyramid[f"p{s}"] = getattr(self, f"fpn_output{s}")(prev)
        pyramid["p6"] = pyramid["p5"][:, :, ::2, ::2]

        level_boxes, level_scores = [], []
        for name in ("p2", "p3", "p4", "p5", "p6"):
            t = self.rpn_conv(pyramid[name])
            obj = self.rpn_objectness(t)[0].permute(1, 2, 0).reshape(-1)  # (h, w, a)
            deltas = self.rpn_anchor_deltas(t)[0].permute(1, 2, 0).reshape(-1, 4)
            anchors = box_ops.generate_anchors(t.shape[2], t.shape[3], STRIDES[name],
                                               sizes=(RPN_SIZES[name],),
                                               aspect_ratios=ASPECT_RATIOS, offset=0.0,
                                               device=dev)
            top_scores, top_idx = stable_topk(obj, min(self.rpn_pre_nms_topk, obj.shape[0]))
            props = box_ops.apply_deltas(anchors[top_idx], deltas[top_idx],
                                         clip_hw=(img_h, img_w), scale_clamp=SCALE_CLAMP)
            keep = box_ops.nms_fixed(props, top_scores, self.rpn_nms_thresh)
            level_boxes.append(props)
            level_scores.append(torch.where(keep, top_scores, -float("inf")))
        all_boxes = torch.cat(level_boxes)
        all_scores = torch.cat(level_scores)
        prop_scores, prop_idx = stable_topk(all_scores, min(self.rpn_post_nms_topk,
                                                            all_scores.shape[0]))
        proposals = all_boxes[prop_idx]
        prop_valid = torch.isfinite(prop_scores)

        feats = {n: pyramid[n][0] for n in ROI_STRIDES}
        bx = box_ops.roi_align_multilevel(feats, proposals, 7, ROI_STRIDES)
        first_feats = None
        for i in range(1, 5):
            bx = getattr(self, f"box_head_conv{i}")(bx)
            if i == 1:
                first_feats = bx
        flat = bx.flatten(1)
        cls_logits = self.cls_score(flat)
        box_deltas = self.bbox_pred(flat)
        det_boxes_all = box_ops.apply_deltas(proposals, box_deltas, clip_hw=(img_h, img_w),
                                             weights=(10.0, 10.0, 5.0, 5.0),
                                             scale_clamp=SCALE_CLAMP)
        probs = torch.softmax(cls_logits, dim=-1)[:, 0]
        cand = prop_valid & (probs > self.score_thresh)
        keep = box_ops.nms_fixed(det_boxes_all, torch.where(cand, probs, -1.0), self.nms_thresh)
        final = torch.where(keep & cand, probs, -1.0)
        det_scores, det_idx = stable_topk(final, self.detections)
        det_valid = det_scores > 0
        det_boxes = det_boxes_all[det_idx]

        mlc = F.relu(self.extraction_mlc_layer0(first_feats[det_idx]))
        mlc = self.extraction_mlc_layer2(self.extraction_mlc_layer1(mlc))
        pooled14 = box_ops.roi_align_multilevel(feats, det_boxes, 14, ROI_STRIDES)
        visible, v_feat = self.visible_mask_head(pooled14, mlc)
        amodal, a_feat = self.amodal_mask_head(torch.cat([pooled14, v_feat], dim=1), mlc)
        occ = self.occ_cls_mask_head(torch.cat([pooled14, v_feat, a_feat], dim=1), mlc)
        return {"boxes": det_boxes, "scores": det_scores, "valid": det_valid,
                "visible_logits": visible, "amodal_logits": amodal, "occ_logits": occ}


class UOAISNetPretrainedBaseModel:
    """Evaluation wrapper over released UOAIS-Net weights: predict(rgb_path,
    depth_path) -> (masks [N, 480, 640] bool, foreground [480, 640] bool,
    seconds).

    The reference wrapper's flow: the frame at 640x480 (BGR, normalised and
    inpainted depth), detectron2's test-time resize to an 800-pixel short
    edge padded to 800x1088, the pixel means subtracted, a forward, each
    valid detection's visible (or amodal) mask resized into its box and
    thresholded at 0.5, and with a foreground net (`fg_params`, CGNet) only
    the masks more than half inside its foreground kept. `params` is a state
    dict of this module (import_zoo.import_uoais_net); without it the net is
    initialised from `seed` (a timing run). The seconds count the forward
    and the copy of its outputs to the host."""

    PIXEL_MEAN = (103.53, 116.28, 123.675, 127.5, 127.5, 127.5)

    def __init__(self, params=None, dataset: str = "OSD", amodal: bool = False, fg_params=None,
                 height: int = 480, width: int = 640, test_size=(800, 1088),
                 score_thresh: float = 0.5, nms_thresh: float = 0.5, seed: int = 0,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        model = UOAISNetPretrained(score_thresh=score_thresh, nms_thresh=nms_thresh)
        if params is None:
            from quber_tpu_torch.models.msmformer import reset_flax_init

            reset_flax_init(model, torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(params, strict=True)
        self.model = model.to(self.device).eval()
        self.dataset, self.amodal = dataset, amodal
        self.height, self.width = height, width
        self.test_h, self.test_w = test_size
        self.fg = None
        if fg_params is not None:
            from quber_tpu_torch.models.fg_predictor import CGNetPredictor

            self.fg = CGNetPredictor(fg_params, device=device)

    def network_input(self, rgb: np.ndarray, depth: np.ndarray):
        """BGR uint8 and depth uint8 [480, 640, 3] -> (the padded 6-channel
        test-size input [800, 1088, 6] float32, the resize scale)."""
        from quber_tpu_torch.ops.preprocess import resize_linear, resize_nearest

        th, tw = self.test_h, self.test_w
        scale = th / self.height
        rw = int(round(self.width * scale))
        x = np.zeros((th, tw, 6), np.float32)
        x[:, :rw, :3] = resize_linear(rgb, (th, rw)).astype(np.float32)
        x[:, :rw, 3:] = resize_nearest(depth, (th, rw))
        x -= np.asarray(self.PIXEL_MEAN, np.float32)
        return x, scale

    @torch.inference_mode()
    def forward(self, x: np.ndarray) -> dict:
        out = self.model(torch.from_numpy(np.ascontiguousarray(x.transpose(2, 0, 1))).to(self.device))
        return {k: v.cpu().numpy() for k, v in out.items()}

    def paste(self, boxes, logits, valid) -> np.ndarray:
        """Each valid detection's mask resized into its box (bilinear, as
        cv2.resize) at 480x640, empty masks dropped."""
        from quber_tpu_torch.ops.preprocess import resize_linear

        h, w = self.height, self.width
        masks = []
        for box, logit, ok in zip(boxes, logits, valid):
            if not ok:
                continue
            x0, y0, x1, y1 = box
            bw, bh = int(round(x1 - x0)), int(round(y1 - y0))
            if bw < 1 or bh < 1:
                continue
            m = resize_linear(1.0 / (1.0 + np.exp(-logit)), (bh, bw)) > 0.5
            full = np.zeros((h, w), bool)
            ix0, iy0 = max(int(x0), 0), max(int(y0), 0)
            ix1, iy1 = min(int(x0) + bw, w), min(int(y0) + bh, h)
            full[iy0:iy1, ix0:ix1] = m[iy0 - int(y0):iy1 - int(y0), ix0 - int(x0):ix1 - int(x0)]
            if full.any():
                masks.append(full)
        return np.asarray(masks) if masks else np.zeros((0, h, w), bool)

    def predict(self, rgb_path, depth_path):
        from quber_tpu_torch.models.uoais_net import read_bgr_depth

        h, w = self.height, self.width
        x, scale = self.network_input(*read_bgr_depth(rgb_path, depth_path, (h, w)))
        t0 = time.time()
        out = self.forward(x)
        elapsed = time.time() - t0
        logits = out["amodal_logits"] if self.amodal else out["visible_logits"]
        masks = self.paste(out["boxes"] / scale, logits, out["valid"])
        fg_mask = None
        if self.fg is not None and len(masks):
            fg_mask = self.fg.predict(rgb_path, depth_path)
            keep = [m.sum() > 0 and (m & fg_mask).sum() / m.sum() > 0.5 for m in masks]
            masks = masks[np.asarray(keep, bool)]
        if fg_mask is None:
            fg_mask = masks.any(0) if len(masks) else np.zeros((h, w), bool)
        return masks.astype(bool), fg_mask, elapsed

"""CascadePSP-RGBD refiner baseline: PSPNet_UOAIS and its evaluation wrapper
(torch, NCHW).

Port of quber_tpu/models/cascadepsp.py:
  * PSPNetUOAIS: a ResNet-50 trunk over 7 channels (ImageNet-normalised
    RGB, depth in [0, 1], the mask in [-1, 1] three times; layer3 / layer4
    dilated, stride 8), a pyramid pooling module and three upsampling
    stages; its forward runs the trunk three times with tanh feedback
    (the s8 -> s4 -> s1 cascade). BatchNorms run from their running
    statistics (the module in eval mode), as the reference runs them;
  * CascadePSPRefiner: per mask a global pass at 224^2, then a local pass
    over the box of each mask of the global prediction, its logits pasted
    back at rounded inverse coordinates inside the box, the clipped logit of
    the global prediction outside it; on OCID the pixels of zero depth
    are cut last;
  * cascadepsp_refine_loss, the training objective.

Modules carry the flax scope names (which follow the reference's), so
models/from_jax carries a flax tree across by renaming and
models/import_zoo.import_cascadepsp fills it from a reference state dict.
Runs in float32, as the reference's wrapper does. The wrapper's shrinks
and its enlargement of the logits are jax.image.resize's antialiased
bilinear (layers.resize_bilinear); inside the network the upsamples are
the half-pixel bilinear of layers.upsample_bilinear.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from quber_tpu_torch.models.layers import (
    BatchNorm, Conv2d, reset_lecun, resize_bilinear, upsample_bilinear)

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


class Bottleneck(nn.Module):
    """torchvision's Bottleneck: 1x1, 3x3 (strided, dilated), 1x1 x4, each
    with a BatchNorm, and a projected shortcut where the shape changes."""

    def __init__(self, cin: int, planes: int, strides: int = 1, dilation: int = 1,
                 has_downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=strides, padding=dilation,
                            dilation=dilation, bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm(planes * 4)
        if has_downsample:
            self.downsample_conv = Conv2d(cin, planes * 4, 1, stride=strides, bias=False)
            self.downsample_bn = BatchNorm(planes * 4)
        self.has_downsample = has_downsample

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        sc = self.downsample_bn(self.downsample_conv(x)) if self.has_downsample else x
        return F.relu(y + sc)


class ResNetPSP(nn.Module):
    """ResNet_UOAIS: a 7-channel stem, layer3 / layer4 at stride 1 dilated 2
    / 4 (the first block of each layer undilated, as the reference's
    _make_layer builds it). Returns (layer4 at /8, 2048 channels; the stem
    conv's output at /2, 64 channels; layer1 at /4, 256 channels)."""

    SPECS = ((64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4))  # planes, stride, dilation

    def __init__(self, in_channels: int = 7, layers=(3, 4, 6, 3)):
        super().__init__()
        self.layers = tuple(layers)
        self.conv1 = Conv2d(in_channels, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        cin = 64
        for li, ((planes, stride, dil), n) in enumerate(zip(self.SPECS, self.layers)):
            for bi in range(n):
                self.add_module(f"layer{li + 1}_{bi}", Bottleneck(
                    cin, planes, strides=stride if bi == 0 else 1,
                    dilation=1 if bi == 0 else dil,
                    has_downsample=bi == 0 and (stride != 1 or li != 0 or planes * 4 != 64)))
                cin = planes * 4

    def forward(self, x):
        x1 = self.conv1(x)
        y = F.max_pool2d(F.relu(self.bn1(x1)), 3, 2, padding=1)
        feats = []
        for li, n in enumerate(self.layers):
            for bi in range(n):
                y = getattr(self, f"layer{li + 1}_{bi}")(y)
            feats.append(y)
        return feats[3], x1, feats[0]


class PSPModule(nn.Module):
    """Adaptive average pools (1, 2, 3, 6), a 1x1 conv each, upsampled and
    concatenated with the input, a 1x1 bottleneck with a bias and ReLU."""

    def __init__(self, channels: int = 2048, out_features: int = 1024, sizes=(1, 2, 3, 6)):
        super().__init__()
        self.sizes = tuple(sizes)
        for i in range(len(self.sizes)):
            self.add_module(f"stage_{i}", Conv2d(channels, channels, 1, bias=False))
        self.bottleneck = Conv2d(channels * (len(self.sizes) + 1), out_features, 1)

    def forward(self, x):
        h, w = x.shape[2:]
        priors = [upsample_bilinear(getattr(self, f"stage_{i}")(F.adaptive_avg_pool2d(x, s)),
                                    size=(h, w)) for i, s in enumerate(self.sizes)]
        return F.relu(self.bottleneck(torch.cat(priors + [x], dim=1)))


class PSPUpsample(nn.Module):
    """A 2x upsample, the skip concatenated, two BN-ReLU-conv pairs plus a
    1x1 shortcut of the upsampled input, then a second residual pair."""

    def __init__(self, cin: int, cskip: int, out_channels: int):
        super().__init__()
        cat = cin + cskip
        for prefix, c0 in (("conv", cat), ("conv2", out_channels)):
            self.add_module(f"{prefix}_bn0", BatchNorm(c0))
            self.add_module(f"{prefix}_conv0", Conv2d(c0, out_channels, 3, padding=1))
            self.add_module(f"{prefix}_bn1", BatchNorm(out_channels))
            self.add_module(f"{prefix}_conv1", Conv2d(out_channels, out_channels, 3, padding=1))
        self.shortcut = Conv2d(cin, out_channels, 1)

    def _block(self, y, prefix):
        y = getattr(self, f"{prefix}_conv0")(F.relu(getattr(self, f"{prefix}_bn0")(y)))
        return getattr(self, f"{prefix}_conv1")(F.relu(getattr(self, f"{prefix}_bn1")(y)))

    def forward(self, x, up):
        x = upsample_bilinear(x, size=(x.shape[2] * 2, x.shape[3] * 2))
        p = self._block(torch.cat([x, up], dim=1), "conv") + self.shortcut(x)
        return p + self._block(p, "conv2")


class PSPNetUOAIS(nn.Module):
    """The three-iteration cascade. rgb [B, 3, H, W] ImageNet-normalised,
    depth [B, 1, H, W] in [0, 1], seg [B, 1, H, W] in [-1, 1] -> {"out_28",
    "out_28_2", "out_28_3", "out_56", "out_56_2" (side outputs resized to
    H x W), "out_224" (the final logit), "pred_224" (its sigmoid)}, each
    [B, 1, H, W]."""

    def __init__(self, layers=(3, 4, 6, 3)):
        super().__init__()
        self.feats = ResNetPSP(7, layers)
        self.psp = PSPModule(2048, 1024)
        self.up_1 = PSPUpsample(1024, 256, 512)
        self.up_2 = PSPUpsample(512, 64, 256)
        self.up_3 = PSPUpsample(256, 3, 32)
        self.final_28_0 = Conv2d(1024, 32, 1)
        self.final_28_2 = Conv2d(32, 1, 1)
        self.final_56_0 = Conv2d(512, 32, 1)
        self.final_56_2 = Conv2d(32, 1, 1)
        self.final_11 = Conv2d(32 + 3, 32, 1)
        self.final_21 = Conv2d(32, 1, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_lecun(self, generator)

    def final_28(self, p):
        return self.final_28_2(F.relu(self.final_28_0(p)))

    def final_56(self, p):
        return self.final_56_2(F.relu(self.final_56_0(p)))

    def forward(self, rgb, depth, seg):
        h, w = rgb.shape[2:]
        up = lambda t: upsample_bilinear(t, size=(h, w))  # noqa: E731
        images = {}
        # iteration 1: s8
        f, _, _ = self.feats(torch.cat([rgb, depth, seg, seg, seg], dim=1))
        p = self.psp(f)
        r_s8 = up(self.final_28(p))
        images["out_28"] = r_s8
        # iteration 2: s4
        t_s8 = torch.tanh(r_s8)
        f, f_1, f_2 = self.feats(torch.cat([rgb, depth, seg, t_s8, t_s8], dim=1))
        p = self.psp(f)
        r_s8_2 = up(self.final_28(p))
        p = self.up_1(p, f_2)
        r_s4 = up(self.final_56(p))
        images["out_28_2"], images["out_56"] = r_s8_2, r_s4
        # iteration 3: s1
        f, f_1, f_2 = self.feats(torch.cat([rgb, depth, seg, torch.tanh(r_s8_2),
                                            torch.tanh(r_s4)], dim=1))
        p = self.psp(f)
        images["out_28_3"] = up(self.final_28(p))
        p = self.up_1(p, f_2)
        images["out_56_2"] = up(self.final_56(p))
        p = self.up_3(self.up_2(p, f_1), rgb)
        p = self.final_21(F.relu(self.final_11(torch.cat([p, rgb], dim=1))))
        images["out_224"] = p
        images["pred_224"] = torch.sigmoid(p)
        return images


class CascadePSPRefiner:
    """Evaluation wrapper: predict(rgb_path, depth_path, initial_masks,
    fg_mask) -> (refined [N, H, W] bool, None, seconds, fg_mask).

    The global predictions of all MAX_INSTANCES slots make the label map
    whose boxes the local pass crops, as in the reference, the empty slots'
    included: their one shared prediction is computed once. The local pass
    runs for the valid slots with a box, the only ones whose output keeps
    it. `params` is a state dict or a flax-layout tree; without it the net
    is initialised from `seed`. The seconds count the device work and the
    copy to the host."""

    GLOBAL = 224
    MAX_INSTANCES = 32
    CHUNK = 8  # slots through the network at once

    def __init__(self, params=None, dataset: str = "OSD", seed: int = 0, device="cuda"):
        from quber_tpu_torch.models.from_jax import as_state_dict

        self.device = torch.device(device)
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        model = PSPNetUOAIS()
        if params is None:
            model.reset_parameters(torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(as_state_dict(params), strict=True)
        self.model = model.to(self.device).eval()
        self.dataset = dataset

    def _apply(self, rgb, depth, seg):
        """The final logits [B, g, g] of the network, CHUNK at a time."""
        return torch.cat([self.model(rgb[i:i + self.CHUNK], depth[i:i + self.CHUNK],
                                     seg[i:i + self.CHUNK])["out_224"][:, 0]
                          for i in range(0, seg.shape[0], self.CHUNK)])

    @torch.inference_mode()
    def refine(self, image: torch.Tensor, masks: torch.Tensor, valid: torch.Tensor):
        """image [6, H, W] float32 0-255 (BGR + depth x3), masks [N, H, W]
        float32 in {0, 1}, valid [N] bool, on the device -> refined [N, H, W]
        bool."""
        from quber_tpu_torch.ops.boxes import roi_align, roi_align_each
        from quber_tpu_torch.ops.zoom import instance_boxes_from_labels

        g = self.GLOBAL
        n, h, w = masks.shape
        dev = masks.device
        mean = torch.from_numpy(IMAGENET_MEAN).to(dev)[:, None, None]
        std = torch.from_numpy(IMAGENET_STD).to(dev)[:, None, None]
        rgb = (image[:3] / 255.0 - mean) / std
        depth = image[3:4] / 255.0
        # the global pass of every slot: the empty slots share one input and
        # so one prediction, computed once
        filled = (masks.flatten(1).amax(dim=1) > 0).tolist()
        distinct = [i for i in range(n) if filled[i]]
        rows = torch.tensor([distinct.index(i) if filled[i] else len(distinct) for i in range(n)],
                            device=dev)
        if not all(filled):
            distinct.append(filled.index(False))
        seg = (resize_bilinear(masks[distinct], (g, g))[:, None] - 0.5) / 0.5
        k = len(distinct)
        logits = self._apply(resize_bilinear(rgb, (g, g))[None].expand(k, -1, -1, -1),
                             resize_bilinear(depth, (g, g))[None].expand(k, -1, -1, -1), seg)
        global_pred = torch.sigmoid(resize_bilinear(logits, (h, w)))[rows]
        p = global_pred.clamp(1e-6, 1 - 1e-6)
        out = torch.log(p / (1 - p))

        # the local pass: each slot's box of the global label map, refined in
        # detail and pasted over the global logits inside the box (only a
        # valid slot with a box keeps anything of it)
        ids = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
        labels = ((global_pred > 0.5).to(torch.int32) * ids[:, None, None]).amax(dim=0)
        boxes, bvalid = instance_boxes_from_labels(labels, n)
        local_slots = torch.nonzero(valid & bvalid).flatten().tolist()
        if local_slots:
            b = boxes[local_slots]
            seg = (roi_align_each(global_pred[local_slots], b, g)[:, None] - 0.5) / 0.5
            local = self._apply(roi_align(rgb, b, out_size=g), roi_align(depth, b, out_size=g),
                                seg)
            ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
            xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
            for j, i in enumerate(local_slots):
                box = boxes[i]
                gy = (ys + 0.5 - box[1]) / (box[3] - box[1]).clamp_min(1e-3) * g - 0.5
                gx = (xs + 0.5 - box[0]) / (box[2] - box[0]).clamp_min(1e-3) * g - 0.5
                inside = (gy >= 0) & (gy < g) & (gx >= 0) & (gx < g)
                val = local[j][torch.round(gy).clamp(0, g - 1).long(),
                               torch.round(gx).clamp(0, g - 1).long()]
                out[i] = torch.where(inside, val, out[i])
        return (torch.sigmoid(out) > 0.5) & valid[:, None, None]

    def _load(self, rgb_path, depth_path):
        """(BGR, normalised inpainted depth, zero-depth mask) at 640x480."""
        from quber_tpu_torch.evaluation.datasets import EVAL_H, EVAL_W
        from quber_tpu_torch.ops.preprocess import load_rgbd

        return load_rgbd(rgb_path, depth_path, (EVAL_H, EVAL_W))

    def predict(self, rgb_path, depth_path, initial_masks, fg_mask):
        from quber_tpu_torch.ops.preprocess import resize_nearest

        rgb, depth_n, zero_depth = self._load(rgb_path, depth_path)
        h, w = rgb.shape[:2]
        n = self.MAX_INSTANCES
        masks = np.zeros((n, h, w), np.float32)
        count = min(len(initial_masks), n)
        for i in range(count):
            masks[i] = np.asarray(initial_masks[i]) > 0
        valid = np.zeros((n,), bool)
        valid[:count] = True
        image = np.concatenate([rgb.astype(np.float32), depth_n.astype(np.float32)], -1)
        t0 = time.time()
        refined = self.refine(
            torch.from_numpy(np.ascontiguousarray(image.transpose(2, 0, 1))).to(self.device),
            torch.from_numpy(masks).to(self.device), torch.from_numpy(valid).to(self.device))
        refined = refined[:count].cpu().numpy()
        elapsed = time.time() - t0
        if self.dataset == "OCID" and len(refined):
            zd = resize_nearest(zero_depth.astype(np.uint8), (h, w)).astype(bool)
            refined = refined & ~zd[None]
        return refined, None, elapsed, fg_mask


def cascadepsp_refine_loss(images: dict, target: torch.Tensor) -> dict:
    """The training objective on a batch: sigmoid BCE on every side output
    of the cascade and on the final logit, L1, L2 and (x5) the first-
    difference gradient L1 of the final prediction. `images` is
    PSPNetUOAIS's output, `target` the ground-truth masks [B, H, W] in
    {0, 1}."""
    def bce(logit):
        z, t = logit[:, 0], target
        return (z.clamp_min(0) - z * t + torch.log1p(torch.exp(-z.abs()))).mean()

    losses = {f"bce_{k}": bce(images[k])
              for k in ("out_28", "out_28_2", "out_28_3", "out_56", "out_56_2")}
    losses["bce_224"] = bce(images["out_224"])
    pred = images["pred_224"][:, 0]
    losses["l1_224"] = (pred - target).abs().mean()
    losses["l2_224"] = ((pred - target) ** 2).mean()
    gy = (torch.diff(pred, dim=1) - torch.diff(target, dim=1)).abs().mean()
    gx = (torch.diff(pred, dim=2) - torch.diff(target, dim=2)).abs().mean()
    losses["grad_224"] = 5.0 * (gy + gx)
    return losses

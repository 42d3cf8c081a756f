"""The explicit-error-estimation study's late-fusion encoder-decoder
(torch, NCHW).

Port of quber_tpu/models/late_fusion.py: one small CNN encoder per input
modality (rgb, depth, fg_mask, boundary, the offset encoding), each level's
modality features concatenated and fused by a 1x1 conv, a U-Net decode
(bilinear upsampling, half-pixel centres, skip concatenation, 3x3 conv)
and two heads predicting the mask and boundary error maps (tp / fp / fn).
focal_loss and dice_ce_loss are the study's losses. Modules carry the flax
scopes' names (models/from_jax); GroupNorm by default.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from quber_tpu_torch.models.layers import Conv2d, ConvNorm, upsample_bilinear
from quber_tpu_torch.models.mask_refiner import dice_loss
from quber_tpu_torch.models.msmformer import reset_flax_init

MODALITIES = (("rgb", 3), ("depth", 3), ("fg_mask", 1), ("boundary", 1), ("offset", 3))


def _stage_channels(base: int, levels: int) -> list[int]:
    return [max(32, base * 2 ** i) for i in range(levels)]


class StageEncoder(nn.Module):
    """One modality's encoder: `levels` stages of a stride-2 3x3 conv and a
    3x3 conv (each norm + ReLU); returns every stage's features."""

    def __init__(self, in_channels: int, base: int = 16, levels: int = 4, norm: str = "GN"):
        super().__init__()
        self.levels = levels
        cin = in_channels
        for i, ch in enumerate(_stage_channels(base, levels)):
            self.add_module(f"down_{i}", ConvNorm(cin, ch, 3, strides=2, norm=norm, act=F.relu))
            self.add_module(f"conv_{i}", ConvNorm(ch, ch, 3, norm=norm, act=F.relu))
            cin = ch

    def forward(self, x):
        feats = []
        for i in range(self.levels):
            x = getattr(self, f"conv_{i}")(getattr(self, f"down_{i}")(x))
            feats.append(x)
        return feats


class LateFusionEncoderDecoder(nn.Module):
    """forward({modality: [B, C, H, W]}) -> {"mask": [B, num_classes, H, W],
    "boundary": [B, num_classes, H, W]} error logits (float32)."""

    def __init__(self, modalities=MODALITIES, num_classes: int = 3, levels: int = 4,
                 norm: str = "GN"):
        super().__init__()
        self.modalities = tuple(modalities)
        self.levels = levels
        chans = _stage_channels(16, levels)
        for name, c in self.modalities:
            self.add_module(f"enc_{name}", StageEncoder(c, levels=levels, norm=norm))
        n = len(self.modalities)
        for i, ch in enumerate(chans):
            self.add_module(f"fuse_{i}", ConvNorm(n * ch, ch, 1, use_bias=True, norm=norm,
                                                  act=F.relu))
        for i in reversed(range(levels - 1)):
            # the decoder's input: the level below (its decoder output, or
            # the deepest fused features) beside this level's fused features
            below = chans[i + 1]
            self.add_module(f"dec_{i}", ConvNorm(below + chans[i], chans[i], 3, norm=norm,
                                                 act=F.relu))
        for head in ("mask", "boundary"):
            self.add_module(f"{head}_head", ConvNorm(chans[0], 32, 3, norm=norm, act=F.relu))
            self.add_module(f"{head}_pred", Conv2d(32, num_classes, 1))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's defaults: LeCun-normal kernels, zero biases, unit norms."""
        reset_flax_init(self, generator)

    def forward(self, inputs: dict):
        per_stage = [[] for _ in range(self.levels)]
        for name, _ in self.modalities:
            for i, f in enumerate(getattr(self, f"enc_{name}")(inputs[name])):
                per_stage[i].append(f)
        fused = [getattr(self, f"fuse_{i}")(torch.cat(feats, dim=1))
                 for i, feats in enumerate(per_stage)]
        y = fused[-1]
        for i in reversed(range(self.levels - 1)):
            y = upsample_bilinear(y.float(), size=fused[i].shape[2:])
            y = getattr(self, f"dec_{i}")(torch.cat([y, fused[i]], dim=1))
        y = upsample_bilinear(y.float(), size=inputs[self.modalities[0][0]].shape[2:])
        return {head: getattr(self, f"{head}_pred")(getattr(self, f"{head}_head")(y)).float()
                for head in ("mask", "boundary")}


def focal_loss(logits, targets, gamma: float = 2.0, alpha: float = 0.25):
    """Multi-channel sigmoid focal loss (monai's), the mean over every
    element."""
    p = torch.sigmoid(logits)
    t = targets.float()
    ce = logits.clamp_min(0) - logits * t + torch.log1p(torch.exp(-logits.abs()))
    pt = p * t + (1 - p) * (1 - t)
    a = alpha * t + (1 - alpha) * (1 - t)
    return (a * (1 - pt) ** gamma * ce).mean()


def dice_ce_loss(logits, targets, dice_weight: float = 1.0, ce_weight: float = 1.0):
    """Softmax dice plus the cross entropy over the channel axis of [B, C,
    H, W] (targets one-hot or soft)."""
    ce = -(torch.log_softmax(logits, dim=1) * targets).sum(dim=1).mean()
    return dice_weight * dice_loss(logits, targets) + ce_weight * ce

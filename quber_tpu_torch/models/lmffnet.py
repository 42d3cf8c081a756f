"""LMFFNet foreground segmenter (torch, NCHW).

Port of quber_tpu/models/lmffnet.py, the lightweight multiscale-feature-
fusion net of the default evaluation-time foreground filter: 6-channel input
(ImageNet-standardised colour + depth / 255, three times) at 640x480, 3
classes (background / table / object); class 2 is the object foreground.
Height and width must be multiples of 16 (PMCA pools quadrants at stride
8). Submodules carry the flax scope names (see models/from_jax.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from quber_tpu_torch.models.layers import (BatchNorm, avg_pool_torch, reset_lecun,
                                           upsample_bilinear)


class BNPReLU(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.bn = BatchNorm(channels, eps=1e-3)
        self.act = nn.PReLU(channels, init=0.25)

    def forward(self, x):
        return self.act(self.bn(x))


class ConvUnit(nn.Module):
    """Conv with an optional BN + PReLU."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3, strides: int = 1,
                 padding: int = 1, dilation: int = 1, groups: int = 1, bn_acti: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, features, kernel, strides, padding, dilation,
                              groups, bias=False)
        self.bn_prelu = BNPReLU(features) if bn_acti else None

    def forward(self, x):
        x = self.conv(x)
        return self.bn_prelu(x) if self.bn_prelu is not None else x


class SEMB(nn.Module):
    """Split-extract-merge bottleneck block."""

    def __init__(self, features: int, dilation: int = 1):
        super().__init__()
        n = features
        self.conv3x3 = ConvUnit(n, n // 2, 3, 1, 1, bn_acti=True)
        self.dconv_left = ConvUnit(n // 4, n // 4, 3, 1, 1, groups=n // 4, bn_acti=True)
        self.dconv_right = ConvUnit(n // 4, n // 4, 3, 1, dilation, dilation=dilation,
                                    groups=n // 4, bn_acti=True)
        self.resume_3x3 = ConvUnit(n // 2, n // 2, 3, 1, 1, bn_acti=True)
        self.resume_1x1 = ConvUnit(n // 2, n, 1, 1, 0)
        self.bn_out = BNPReLU(n)
        self.quarter = n // 4

    def forward(self, x):
        y = self.conv3x3(x)
        left, right = y[:, :self.quarter], y[:, self.quarter:]
        y = torch.cat([self.dconv_left(left), self.dconv_right(right)], dim=1)
        y = self.resume_1x1(self.resume_3x3(y))
        return self.bn_out(y + x)


class DownSamplingBlock(nn.Module):
    """Strided conv (+ max-pool concat when widening)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.widen = in_channels < out_channels
        n_conv = out_channels - in_channels if self.widen else out_channels
        self.conv3x3 = ConvUnit(in_channels, n_conv, 3, 2, 1)
        self.bn_prelu = BNPReLU(out_channels)

    def forward(self, x):
        y = self.conv3x3(x)
        if self.widen:
            y = torch.cat([y, F.max_pool2d(x, 2, 2)], dim=1)
        return self.bn_prelu(y)


class SENetBlock(nn.Module):
    """SE gate with one shared PReLU slope, on [B, C, 1, 1]."""

    def __init__(self, channels: int, reduction: int = 8):
        super().__init__()
        self.fc1 = nn.Linear(channels, channels // reduction, bias=False)
        self.prelu_alpha = nn.Parameter(torch.full((1,), 0.25))
        self.fc2 = nn.Linear(channels // reduction, channels, bias=False)

    def forward(self, x):
        y = self.fc1(x.flatten(1))
        y = torch.where(y >= 0, y, y * self.prelu_alpha)
        return torch.sigmoid(self.fc2(y))[:, :, None, None]


class PMCA(nn.Module):
    """Partitioned multi-scale channel attention."""

    def __init__(self, channels: int, reduction: int = 8):
        super().__init__()
        self.conv2x2 = nn.Conv2d(channels, channels, 2, groups=channels, bias=False)
        self.se = SENetBlock(channels, reduction)

    def forward(self, x):
        b, c, h, w = x.shape
        # AdaptiveAvgPool2d((2, 2)): the means of the four quadrants
        q = x.reshape(b, c, 2, h // 2, 2, w // 2).mean(dim=(3, 5))
        return x * self.se(self.conv2x2(q) + x.mean(dim=(2, 3), keepdim=True))


class FFMA(nn.Module):
    """Feature fusion A: BNPReLU(concat) + 1x1 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.bn_prelu = BNPReLU(channels)
        self.conv1x1 = ConvUnit(channels, channels, 1, 1, 0)

    def forward(self, x1, x2):
        return self.conv1x1(self.bn_prelu(torch.cat([x1, x2], dim=1)))


class FFMB(nn.Module):
    """Feature fusion B with PMCA on the skip path."""

    def __init__(self, skip_channels: int, channels: int):
        super().__init__()
        self.pmca = PMCA(skip_channels, 8)
        self.bn_prelu = BNPReLU(channels)
        self.conv1x1 = ConvUnit(channels, channels, 1, 1, 0)

    def forward(self, x1, x2, x3):
        y = self.bn_prelu(torch.cat([x1, self.pmca(x2), x3], dim=1))
        return self.conv1x1(y)


class MAD(nn.Module):
    """Multi-attention decoder."""

    def __init__(self, mid_channels: int, deep_channels: int, classes: int = 3,
                 c1: int = 16, c2: int = 32):
        super().__init__()
        self.mid_1x1 = ConvUnit(mid_channels, c1, 1, 1, 0)
        self.deep_1x1 = ConvUnit(deep_channels, c2, 1, 1, 0)
        self.dw1 = ConvUnit(c1 + c2, c1 + c2, 3, 1, 1, groups=c1 + c2, bn_acti=True)
        self.pw1 = ConvUnit(c1 + c2, classes, 1, 1, 0)
        self.dw2 = ConvUnit(deep_channels, deep_channels, 3, 1, 1, groups=deep_channels,
                            bn_acti=True)
        self.pw2 = ConvUnit(deep_channels, classes, 1, 1, 0)

    def forward(self, x1, x2):
        h2, w2 = x2.shape[2:]
        b = upsample_bilinear(self.deep_1x1(x2), size=(h2 * 2, w2 * 2))
        att = torch.cat([self.mid_1x1(x1), b], dim=1)
        att = torch.sigmoid(self.pw1(self.dw1(att)))
        o = upsample_bilinear(self.pw2(self.dw2(x2)), size=(h2 * 2, w2 * 2))
        return upsample_bilinear(o * att, size=(h2 * 8, w2 * 8))


class LMFFNet(nn.Module):
    """LMFFNet(classes=3, block_1=3, block_2=8); forward takes [B, 6, H, W]
    and returns logits [B, classes, H, W]."""

    DILATIONS = (4, 4, 8, 8, 16, 16, 32, 32)

    def __init__(self, classes: int = 3, block_1: int = 3, block_2: int = 8,
                 in_channels: int = 6):
        super().__init__()
        self.block_1, self.block_2 = block_1, block_2
        self.init_0 = ConvUnit(in_channels, 32, 3, 2, 1, bn_acti=True)
        self.init_1 = ConvUnit(32, 32, 3, 1, 1, bn_acti=True)
        self.init_2 = ConvUnit(32, 32, 3, 1, 1, bn_acti=True)
        c_a = 32 + in_channels
        self.ffm_a = FFMA(c_a)
        self.downsample_1 = DownSamplingBlock(c_a, 64)
        for i in range(block_1):
            self.add_module(f"sem_b1_{i}", SEMB(64, 2))
        c_b1 = 64 + 64 + in_channels
        self.ffm_b1 = FFMB(64, c_b1)
        self.downsample_2 = DownSamplingBlock(c_b1, 128)
        for i in range(block_2):
            self.add_module(f"sem_b2_{i}", SEMB(128, self.DILATIONS[i]))
        c_b2 = 128 + 128 + in_channels
        self.ffm_b2 = FFMB(128, c_b2)
        self.mad = MAD(c_b1, c_b2, classes)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_lecun(self, generator)
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, SENetBlock):
                    mod.prelu_alpha.fill_(0.25)

    def forward(self, x):
        y = self.init_2(self.init_1(self.init_0(x)))
        down1 = avg_pool_torch(x)
        down2 = avg_pool_torch(down1)
        down3 = avg_pool_torch(down2)
        ds1 = self.downsample_1(self.ffm_a(y, down1))
        s1 = ds1
        for i in range(self.block_1):
            s1 = getattr(self, f"sem_b1_{i}")(s1)
        ffm_b1 = self.ffm_b1(s1, ds1, down2)
        ds2 = self.downsample_2(ffm_b1)
        s2 = ds2
        for i in range(self.block_2):
            s2 = getattr(self, f"sem_b2_{i}")(s2)
        ffm_b2 = self.ffm_b2(s2, ds2, down3)
        return self.mad(ffm_b1, ffm_b2)

"""CGNet foreground segmenter (torch, NCHW).

Port of quber_tpu/models/cgnet.py, the Context-Guided Network used as the
RGB-D foreground filter: 4-channel input (ImageNet-standardised colour +
depth / 255) at 320x240, 2 classes (background / object), logits upsampled
bilinearly to the input size. Submodules carry the flax scope names, so
models/from_jax.py carries a flax tree across by renaming.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from quber_tpu_torch.models.layers import (BatchNorm, avg_pool_torch, reset_lecun,
                                           upsample_bilinear)


class ConvBNPReLU(nn.Module):
    def __init__(self, in_channels: int, features: int, kernel: int = 3, strides: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, features, kernel, strides, (kernel - 1) // 2,
                              bias=False)
        self.bn = BatchNorm(features, eps=1e-3)
        self.act = nn.PReLU(features, init=0.25)

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class BNPReLU(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.bn = BatchNorm(channels, eps=1e-3)
        self.act = nn.PReLU(channels, init=0.25)

    def forward(self, x):
        return self.act(self.bn(x))


class FGlo(nn.Module):
    """Global-context SE gate."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Linear(channels, channels // reduction)
        self.fc2 = nn.Linear(channels // reduction, channels)

    def forward(self, x):
        y = torch.sigmoid(self.fc2(F.relu(self.fc1(x.mean(dim=(2, 3))))))
        return x * y[:, :, None, None]


def _depthwise(channels: int, dilation: int) -> nn.Conv2d:
    return nn.Conv2d(channels, channels, 3, padding=dilation, dilation=dilation,
                     groups=channels, bias=False)


class CGBlockDown(nn.Module):
    """Downsampling context-guided block."""

    def __init__(self, in_channels: int, features: int, dilation: int = 2, reduction: int = 16):
        super().__init__()
        n = features
        self.conv1x1 = ConvBNPReLU(in_channels, n, 3, 2)
        self.f_loc = _depthwise(n, 1)
        self.f_sur = _depthwise(n, dilation)
        self.bn = BatchNorm(2 * n, eps=1e-3)
        self.act = nn.PReLU(2 * n, init=0.25)
        self.reduce = nn.Conv2d(2 * n, n, 1, bias=False)
        self.f_glo = FGlo(n, reduction)

    def forward(self, x):
        x = self.conv1x1(x)
        joi = self.act(self.bn(torch.cat([self.f_loc(x), self.f_sur(x)], dim=1)))
        return self.f_glo(self.reduce(joi))


class CGBlock(nn.Module):
    """Residual context-guided block."""

    def __init__(self, features: int, dilation: int = 2, reduction: int = 16):
        super().__init__()
        n = features // 2
        self.conv1x1 = ConvBNPReLU(features, n, 1, 1)
        self.f_loc = _depthwise(n, 1)
        self.f_sur = _depthwise(n, dilation)
        self.bn_prelu = BNPReLU(2 * n)
        self.f_glo = FGlo(features, reduction)

    def forward(self, x):
        y = self.conv1x1(x)
        joi = self.bn_prelu(torch.cat([self.f_loc(y), self.f_sur(y)], dim=1))
        return x + self.f_glo(joi)


class CGNet(nn.Module):
    """Context_Guided_Network(classes, in_channel, M, N); forward takes
    [B, in_channels, H, W] and returns logits [B, classes, H, W]."""

    def __init__(self, classes: int = 2, in_channels: int = 4, m: int = 3, n: int = 21):
        super().__init__()
        self.level1_0 = ConvBNPReLU(in_channels, 32, 3, 2)
        self.level1_1 = ConvBNPReLU(32, 32, 3, 1)
        self.level1_2 = ConvBNPReLU(32, 32, 3, 1)
        self.b1 = BNPReLU(32 + in_channels)
        self.level2_0 = CGBlockDown(32 + in_channels, 64, 2, 8)
        self.m, self.n = m, n
        for i in range(1, m):
            self.add_module(f"level2_{i}", CGBlock(64, 2, 8))
        self.bn_prelu_2 = BNPReLU(128 + in_channels)
        self.level3_0 = CGBlockDown(128 + in_channels, 128, 4, 16)
        for i in range(1, n):
            self.add_module(f"level3_{i}", CGBlock(128, 4, 16))
        self.bn_prelu_3 = BNPReLU(256)
        self.classifier = nn.Conv2d(256, classes, 1, bias=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_lecun(self, generator)

    def forward(self, x):
        h, w = x.shape[2:]
        out0 = self.level1_2(self.level1_1(self.level1_0(x)))
        inp1 = avg_pool_torch(x)
        inp2 = avg_pool_torch(inp1)
        cat0 = self.b1(torch.cat([out0, inp1], dim=1))
        out1_0 = self.level2_0(cat0)
        out1 = out1_0
        for i in range(1, self.m):
            out1 = getattr(self, f"level2_{i}")(out1)
        cat1 = self.bn_prelu_2(torch.cat([out1, out1_0, inp2], dim=1))
        out2_0 = self.level3_0(cat1)
        out2 = out2_0
        for i in range(1, self.n):
            out2 = getattr(self, f"level3_{i}")(out2)
        cat2 = self.bn_prelu_3(torch.cat([out2_0, out2], dim=1))
        return upsample_bilinear(self.classifier(cat2), size=(h, w))

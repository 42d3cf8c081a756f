"""DeepLab ResNet trunks and the dual RGB-D fusion backbone (torch, NCHW).

Port of quber_tpu/models/resnet.py: two ResNet trunks with the 3-conv
DeepLab stem, res5 dilation 2 with multi-grid (1, 2, 4), and per-stage
concat fusion. The 3-channel offset encoding is appended to BOTH trunk
inputs, so each stem takes 6 channels when offsets are on. The
single-modality ablations (rgb-only, depth-only) run one trunk,
`SingleTrunkBackbone`.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from quber_tpu_torch.models.layers import ConvNorm, max_pool_same

# ResNet depth -> blocks per stage. Depth 14 is the one-bottleneck-per-stage
# variant the tests use.
BLOCKS_PER_STAGE = {
    14: (1, 1, 1, 1),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}

_STAGE = {"res2": 2, "res3": 3, "res4": 4, "res5": 5}


class DeepLabStem(nn.Module):
    """3x 3x3-conv stem + maxpool, stride 4."""

    def __init__(self, in_channels: int, out_channels: int = 128,
                 norm: str = "FrozenBN"):
        super().__init__()
        half = out_channels // 2
        self.conv1 = ConvNorm(in_channels, half, 3, strides=2, norm=norm, act=F.relu)
        self.conv2 = ConvNorm(half, half, 3, norm=norm, act=F.relu)
        self.conv3 = ConvNorm(half, out_channels, 3, norm=norm, act=F.relu)

    def forward(self, x):
        x = self.conv3(self.conv2(self.conv1(x)))
        return max_pool_same(x, 3, 2)


class BasicStem(nn.Module):
    """The standard 7x7 stride-2 stem + maxpool, stride 4 (detectron2's
    BasicStem)."""

    def __init__(self, in_channels: int, out_channels: int = 64, norm: str = "FrozenBN"):
        super().__init__()
        self.conv1 = ConvNorm(in_channels, out_channels, 7, strides=2, norm=norm, act=F.relu)

    def forward(self, x):
        return max_pool_same(self.conv1(x), 3, 2)


class Bottleneck(nn.Module):
    """detectron2 BottleneckBlock; stride_in_1x1 puts the stride on conv1."""

    def __init__(self, in_channels: int, out_channels: int,
                 bottleneck_channels: int, stride: int = 1, dilation: int = 1,
                 stride_in_1x1: bool = True, norm: str = "FrozenBN"):
        super().__init__()
        s1, s2 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = ConvNorm(in_channels, bottleneck_channels, 1, strides=s1,
                              norm=norm, act=F.relu)
        self.conv2 = ConvNorm(bottleneck_channels, bottleneck_channels, 3,
                              strides=s2, dilation=dilation, norm=norm, act=F.relu)
        self.conv3 = ConvNorm(bottleneck_channels, out_channels, 1, norm=norm)
        self.shortcut = None
        if in_channels != out_channels:
            self.shortcut = ConvNorm(in_channels, out_channels, 1, strides=stride,
                                     norm=norm)

    def forward(self, x):
        out = self.conv3(self.conv2(self.conv1(x)))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return F.relu(out + x)


class ResNetTrunk(nn.Module):
    """One DeepLab-ResNet trunk returning {res2, res3, res5} features:
    res4 strides by 2, res5 dilates by 2 with multi-grid and stride 1. With
    `remat`, a block's activations are recomputed in the backward pass and
    not kept (training memory for operations). stem_type "basic" with
    res5_dilation 1 is the standard detectron2 R50 (7x7 stem, strided res5)."""

    def __init__(self, in_channels: int, depth: int = 50, stem_type: str = "deeplab",
                 stem_out_channels: int = 128, res2_out_channels: int = 256,
                 res5_dilation: int = 2,
                 res5_multi_grid: Sequence[int] = (1, 2, 4),
                 out_features: Sequence[str] = ("res2", "res3", "res5"),
                 norm: str = "FrozenBN", remat: bool = False):
        super().__init__()
        self.remat = remat
        stem_cls = DeepLabStem if stem_type == "deeplab" else BasicStem
        self.stem = stem_cls(in_channels, stem_out_channels, norm)
        self.out_features = tuple(out_features)
        self.out_channels = {}
        num_blocks = BLOCKS_PER_STAGE[depth]
        out_channels = res2_out_channels
        bottleneck = out_channels // 4
        in_ch = stem_out_channels
        self.block_names = []
        max_stage = max(_STAGE[f] for f in self.out_features)
        for idx, stage_idx in enumerate(range(2, max_stage + 1)):
            name = f"res{stage_idx}"
            dilation = res5_dilation if stage_idx == 5 else 1
            first_stride = 1 if (idx == 0 or dilation > 1) else 2
            for b in range(num_blocks[idx]):
                block_dilation = (dilation * res5_multi_grid[b]
                                  if stage_idx == 5 else dilation)
                self.add_module(f"{name}_{b}", Bottleneck(
                    in_ch, out_channels, bottleneck,
                    stride=first_stride if b == 0 else 1,
                    dilation=block_dilation, norm=norm))
                self.block_names.append((name, f"{name}_{b}"))
                in_ch = out_channels
            self.out_channels[name] = out_channels
            out_channels *= 2
            bottleneck *= 2

    def forward(self, x):
        x = self.stem(x)
        outputs = {}
        remat = self.remat and torch.is_grad_enabled()
        for stage, block in self.block_names:
            if remat:
                x = checkpoint(getattr(self, block), x, use_reentrant=False)
            else:
                x = getattr(self, block)(x)
            if stage in self.out_features:
                outputs[stage] = x
        return outputs


class SingleTrunkBackbone(nn.Module):
    """One trunk, named `trunk`, over the whole input (one modality's three
    channels, plus the offset encoding when it is on)."""

    def __init__(self, in_channels: int, depth: int = 50,
                 out_features: Sequence[str] = ("res2", "res3", "res5"),
                 norm: str = "FrozenBN", remat: bool = False):
        super().__init__()
        self.trunk = ResNetTrunk(in_channels, depth, out_features=out_features, norm=norm,
                                 remat=remat)
        self.out_channels = {f: self.trunk.out_channels[f] for f in out_features}

    def forward(self, x):
        return self.trunk(x)


class RGBDFusionBackbone(nn.Module):
    """Dual-trunk RGB-D backbone with per-stage fusion.

    Input [B, 6 or 9, H, W]: rgb(3) + depth(3) [+ offset encoding(3)]. Fusion
    per stage: concat -> 1x1 conv + GN + ReLU (or elementwise add), then
    num_fusion_layers x (3x3 conv + GN + ReLU), skipped on res5.
    """

    def __init__(self, fusion_strategy: str = "concat", num_fusion_layers: int = 2,
                 depth: int = 50,
                 out_features: Sequence[str] = ("res2", "res3", "res5"),
                 norm: str = "FrozenBN", offset_input: bool = True,
                 remat: bool = False):
        super().__init__()
        if fusion_strategy not in ("concat", "add"):
            raise ValueError(fusion_strategy)
        self.fusion_strategy = fusion_strategy
        self.num_fusion_layers = num_fusion_layers
        self.offset_input = offset_input
        self.out_features = tuple(out_features)
        trunk_in = 6 if offset_input else 3
        self.rgb_trunk = ResNetTrunk(trunk_in, depth, out_features=out_features, norm=norm,
                                     remat=remat)
        self.depth_trunk = ResNetTrunk(trunk_in, depth, out_features=out_features, norm=norm,
                                       remat=remat)
        self.out_channels = {f: self.rgb_trunk.out_channels[f] for f in self.out_features}
        for f in self.out_features:
            c = self.out_channels[f]
            if fusion_strategy == "concat":
                self.add_module(f"fusion_{f}_reduce", ConvNorm(
                    2 * c, c, 1, use_bias=True, norm="GN", act=F.relu))
            if f != "res5":
                for i in range(num_fusion_layers):
                    self.add_module(f"fusion_{f}_conv{i}", ConvNorm(
                        c, c, 3, use_bias=True, norm="GN", act=F.relu))

    def forward(self, x):
        rgb, depth = x[:, 0:3], x[:, 3:6]
        if self.offset_input:
            offset = x[:, 6:]
            rgb = torch.cat([rgb, offset], dim=1)
            depth = torch.cat([depth, offset], dim=1)
        rgb_out = self.rgb_trunk(rgb)
        depth_out = self.depth_trunk(depth)
        fused = {}
        for f in self.out_features:
            if self.fusion_strategy == "concat":
                y = getattr(self, f"fusion_{f}_reduce")(
                    torch.cat([rgb_out[f], depth_out[f]], dim=1))
            else:
                y = rgb_out[f] + depth_out[f]
            if f != "res5":
                for i in range(self.num_fusion_layers):
                    y = getattr(self, f"fusion_{f}_conv{i}")(y)
            fused[f] = y
        return fused

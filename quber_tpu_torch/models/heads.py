"""DeepLabV3+ decoder and the hierarchical QuBER instance-embedding head.

Port of quber_tpu/models/heads.py (torch, NCHW):
  * decoder: ASPP on the deepest feature, then top-down project (1x1) +
    concat + fuse (2x 3x3) to stride `common_stride`;
  * five prediction heads (eee_mask, eee_boundary, foreground, center,
    offset): two 3x3 conv + GN + ReLU, then a 1x1 predictor;
  * hierarchical fusion: each level concatenates [decoder feature, previous
    level's head features, previous level's softmax/sigmoid predictions]
    and runs FusionLayers, whose norm is BatchNorm (batch statistics in
    training mode, running statistics in eval mode).
In bfloat16 the predictors return bfloat16 and the features float32 (their
norms do), so the concatenation promotes to float32, as jnp.concatenate does.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from quber_tpu_torch.models.layers import (
    ASPP,
    Conv2d,
    ConvNorm,
    DepthwiseSeparableConv,
    upsample_bilinear,
)

ERROR_TYPE_CHANNELS = {"e3": 4, "e33": 3, "e2": 2, "e32": 2}

HEAD_OUT_CHANNELS = {"foreground": 1, "center": 1, "offset": 2}


def head_out_channels(name: str, error_type: str) -> int:
    if "eee" in name:
        return ERROR_TYPE_CHANNELS[error_type]
    return HEAD_OUT_CHANNELS[name]


class SinglePredictionHead(nn.Module):
    """Two 3x3 convs (norm + ReLU), or a 5x5 depthwise-separable block."""

    def __init__(self, in_channels: int, head_channels: int = 32, norm: str = "GN",
                 use_depthwise_separable_conv: bool = False):
        super().__init__()
        self.dws = None
        if use_depthwise_separable_conv:
            self.dws = DepthwiseSeparableConv(in_channels, head_channels, 5, norm)
            return
        use_bias = norm == ""
        self.conv0 = ConvNorm(in_channels, in_channels, 3, use_bias=use_bias,
                              norm=norm, act=F.relu)
        self.conv1 = ConvNorm(in_channels, head_channels, 3, use_bias=use_bias,
                              norm=norm, act=F.relu)

    def forward(self, x):
        if self.dws is not None:
            return self.dws(x)
        return self.conv1(self.conv0(x))


class FusionLayers(nn.Module):
    """1x1 channel reduce + N x 3x3 refine, BatchNorm throughout."""

    def __init__(self, in_channels: int, out_channels: int = 128, num_layers: int = 3):
        super().__init__()
        self.num_layers = num_layers
        self.reduce = ConvNorm(in_channels, out_channels, 1, use_bias=True,
                               norm="BN", act=F.relu)
        for i in range(num_layers):
            self.add_module(f"conv{i}", ConvNorm(
                out_channels, out_channels, 3, use_bias=True, norm="BN", act=F.relu))

    def forward(self, x):
        x = self.reduce(x)
        for i in range(self.num_layers):
            x = getattr(self, f"conv{i}")(x)
        return x


class DeepLabV3PlusDecoder(nn.Module):
    """Top-down decoder: ASPP on the deepest feature, project + fuse on the
    others. `in_channels` maps each feature name to its channel count."""

    def __init__(self, in_channels: dict,
                 in_features: Sequence[str] = ("res2", "res3", "res5"),
                 project_channels: Sequence[int] = (32, 64),
                 aspp_channels: int = 256,
                 aspp_dilations: Sequence[int] = (6, 12, 18),
                 convs_dim: int = 128, norm: str = "GN",
                 use_depthwise_separable_conv: bool = False,
                 aspp_dropout: float = 0.1):
        super().__init__()
        use_bias = norm == ""
        self.names = list(in_features)
        self.dws = use_depthwise_separable_conv
        n = len(self.names)
        decoder_channels = [convs_dim] * (n - 1) + [aspp_channels]
        y_ch = None
        for idx in reversed(range(n)):
            f = self.names[idx]
            if idx == n - 1:
                self.add_module(f"aspp_{f}", ASPP(in_channels[f], aspp_channels,
                                                  aspp_dilations, norm, aspp_dropout))
            else:
                self.add_module(f"project_{f}", ConvNorm(
                    in_channels[f], project_channels[idx], 1, use_bias=use_bias,
                    norm=norm, act=F.relu))
                cat_ch = project_channels[idx] + y_ch
                if self.dws:
                    self.add_module(f"fuse_{f}", DepthwiseSeparableConv(
                        cat_ch, decoder_channels[idx], 5, norm))
                else:
                    self.add_module(f"fuse_{f}_0", ConvNorm(
                        cat_ch, decoder_channels[idx], 3, use_bias=use_bias,
                        norm=norm, act=F.relu))
                    self.add_module(f"fuse_{f}_1", ConvNorm(
                        decoder_channels[idx], decoder_channels[idx], 3,
                        use_bias=use_bias, norm=norm, act=F.relu))
            y_ch = decoder_channels[idx]
        self.out_channels = y_ch

    def forward(self, features: dict) -> torch.Tensor:
        n = len(self.names)
        y = None
        for idx in reversed(range(n)):
            f = self.names[idx]
            x = features[f]
            if idx == n - 1:
                y = getattr(self, f"aspp_{f}")(x)
                continue
            proj = getattr(self, f"project_{f}")(x)
            y = upsample_bilinear(y, size=(proj.shape[2], proj.shape[3]))
            y = torch.cat([proj, y], dim=1)
            if self.dws:
                y = getattr(self, f"fuse_{f}")(y)
            else:
                y = getattr(self, f"fuse_{f}_1")(getattr(self, f"fuse_{f}_0")(y))
        return y


class InsEmbedHead(nn.Module):
    """Hierarchical 5-head QuBER prediction head over the decoder feature.

    Returns stride-`common_stride` logits: foreground [B,1,h,w], center
    [B,1,h,w], offset [B,2,h,w], eee_mask / eee_boundary [B,C,h,w].
    """

    def __init__(self, in_channels: dict,
                 in_features: Sequence[str] = ("res2", "res3", "res5"),
                 project_channels: Sequence[int] = (32, 64),
                 aspp_channels: int = 256,
                 aspp_dilations: Sequence[int] = (6, 12, 18),
                 convs_dim: int = 128, head_channels: int = 32, norm: str = "GN",
                 use_depthwise_separable_conv: bool = False,
                 eee_mask_on: bool = True, eee_boundary_on: bool = True,
                 error_type: str = "e2", hierarchical_fusion_on: bool = True,
                 hierarchy: Sequence[Sequence[str]] = (
                     ("eee_mask",), ("eee_boundary",), ("foreground",),
                     ("center",), ("offset",)),
                 num_fusion_layers: int = 3,
                 fusion_target: Sequence[str] = ("feat", "pred"),
                 head_depthwise_separable: bool = False,
                 aspp_dropout: float = 0.1):
        super().__init__()
        self.decoder = DeepLabV3PlusDecoder(
            in_channels, in_features, project_channels, aspp_channels,
            aspp_dilations, convs_dim, norm, use_depthwise_separable_conv,
            aspp_dropout)
        y_ch = self.decoder.out_channels
        head_names = ["foreground", "center", "offset"]
        if eee_mask_on:
            head_names.insert(0, "eee_mask")
        if eee_boundary_on:
            head_names.insert(1 if eee_mask_on else 0, "eee_boundary")
        self.head_names = head_names
        self.hierarchical_fusion_on = hierarchical_fusion_on
        self.hierarchy = [list(level) for level in hierarchy]
        self.fusion_target = tuple(fusion_target)

        def add_head(name, src_ch):
            self.add_module(f"{name}_head", SinglePredictionHead(
                src_ch, head_channels, norm, head_depthwise_separable))
            self.add_module(f"{name}_predictor", Conv2d(
                head_channels, head_out_channels(name, error_type), 1, bias=True))

        if not hierarchical_fusion_on:
            for name in head_names:
                add_head(name, y_ch)
            return
        for i, level in enumerate(self.hierarchy):
            src_ch = y_ch
            if i > 0:
                cat_ch = y_ch
                prev = self.hierarchy[i - 1]
                if "feat" in self.fusion_target:
                    cat_ch += head_channels * len(prev)
                if "pred" in self.fusion_target:
                    cat_ch += sum(head_out_channels(p, error_type) for p in prev)
                self.add_module(f"fusion_{i}", FusionLayers(
                    cat_ch, convs_dim, num_fusion_layers))
                src_ch = convs_dim
            for name in level:
                add_head(name, src_ch)

    def _run_head(self, name, src):
        feat = getattr(self, f"{name}_head")(src)
        return feat, getattr(self, f"{name}_predictor")(feat)

    def forward(self, features: dict) -> dict:
        y = self.decoder(features)
        outputs = {}
        if not self.hierarchical_fusion_on:
            for name in self.head_names:
                outputs[name] = self._run_head(name, y)[1]
            return outputs
        feats = {}
        for i, level in enumerate(self.hierarchy):
            src = y
            if i > 0:
                prev = self.hierarchy[i - 1]
                parts = [y]
                if "feat" in self.fusion_target:
                    parts += [feats[p] for p in prev]
                if "pred" in self.fusion_target:
                    for p in prev:
                        o = outputs[p]
                        parts.append(torch.softmax(o, dim=1) if "eee" in p
                                     else torch.sigmoid(o))
                src = getattr(self, f"fusion_{i}")(torch.cat(parts, dim=1))
            for name in level:
                feats[name], outputs[name] = self._run_head(name, src)
        return outputs

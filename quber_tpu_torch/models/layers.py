"""Shared conv/norm building blocks (torch, NCHW).

Port of quber_tpu/models/layers.py. Submodules carry the flax scope names
(`conv`, and `norm` for flax's `GroupNorm_0` / `BatchNorm_0` /
`FrozenBatchNorm_0`) so that models/from_jax.py maps a flax variable tree
onto a state dict by renaming alone. A module's `training` flag is the flax
`train` attribute: in eval mode BatchNorm runs from its running statistics
and dropout is off; in training mode BatchNorm normalises with the batch's
statistics and updates the running ones, and the ASPP dropout draws its mask
from an explicit generator. FrozenBatchNorm is the same in both modes.

Compute type, as flax's modules treat it: a Conv2d casts its input, kernel
and bias to its `compute_dtype` (float32 unless the model sets bfloat16) and
returns that type; FrozenBatchNorm computes its scale and shift in float32
and applies them in the input's type; GroupNorm and BatchNorm, which have no
compute type in the reference, normalise in float32 and return float32.
Parameters stay float32 throughout.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def upsample_bilinear(x: torch.Tensor, scale: int | None = None,
                      size: tuple[int, int] | None = None) -> torch.Tensor:
    """Bilinear resize with half-pixel centres (align_corners=False), the
    convention of jax.image.resize for upsampling."""
    if size is None:
        size = (x.shape[2] * scale, x.shape[3] * scale)
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in `compute_dtype`, like flax's nn.Conv(dtype=...):
    input, kernel and bias are cast to it, and so is the output. Below
    float32 the bias is added to the rounded convolution, as flax adds it
    (oneDNN would fuse it into one rounding)."""

    compute_dtype = torch.float32

    def forward(self, x):
        dt = self.compute_dtype
        if dt == torch.float32 or self.bias is None:
            bias = None if self.bias is None else self.bias.to(dt)
            return self._conv_forward(x.to(dt), self.weight.to(dt), bias)
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        return y + self.bias.to(dt)[:, None, None]


class GroupNorm(nn.GroupNorm):
    """flax nn.GroupNorm without a dtype: statistics and output in float32,
    whatever the input's type."""

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps)


class FrozenBatchNorm(nn.Module):
    """detectron2 FrozenBN: y = x * scale + shift with scale = w / sqrt(var + eps)
    and shift = b - mean * scale, all four tensors fixed buffers."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


class BatchNorm(nn.Module):
    """flax nn.BatchNorm(momentum=0.9): in eval mode it normalises with the
    running statistics (flax `batch_stats`); in training mode with the
    batch's mean and biased variance, and the running statistics move by
    0.1 towards them. Unlike nn.BatchNorm2d it keeps no batch counter (a
    flax tree maps onto it one leaf per tensor) and the running variance
    takes the BIASED batch variance, as flax's does."""

    momentum = 0.1  # torch's convention: the weight of the new batch

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        x = x.float()
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, training=False, eps=self.eps)
        # F.batch_norm with momentum 1 leaves the batch's mean and UNBIASED
        # variance in the buffers it is given
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, training=True,
                         momentum=1.0, eps=self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var * ((n - 1) / n), self.momentum)
        return y


def make_norm(norm: str, channels: int) -> nn.Module | None:
    """The reference's norm names -> modules (GN: 32 groups, eps 1e-5)."""
    if norm == "" or norm is None:
        return None
    if norm == "GN":
        return GroupNorm(32, channels, eps=1e-5)
    if norm in ("BN", "SyncBN"):
        return BatchNorm(channels)
    if norm == "FrozenBN":
        return FrozenBatchNorm(channels)
    raise ValueError(f"Unknown norm: {norm}")


class ConvNorm(nn.Module):
    """Conv2d + optional norm + optional activation (detectron2 Conv2d), with
    symmetric padding ((k - 1) // 2) * dilation."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 strides: int = 1, dilation: int = 1, groups: int = 1,
                 use_bias: bool = False, norm: str = "",
                 act: Callable | None = None):
        super().__init__()
        pad = ((kernel_size - 1) // 2) * dilation
        self.conv = Conv2d(in_channels, features, kernel_size, stride=strides,
                           padding=pad, dilation=dilation, groups=groups, bias=use_bias)
        self.norm = make_norm(norm, features)
        self.act = act

    def forward(self, x):
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        if self.act is not None:
            x = self.act(x)
        return x


class DepthwiseSeparableConv(nn.Module):
    """5x5 depthwise + 1x1 pointwise, each with norm + ReLU."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 5,
                 norm: str = "GN"):
        super().__init__()
        self.depthwise = ConvNorm(in_channels, in_channels, kernel_size,
                                  groups=in_channels, norm=norm, act=F.relu)
        self.pointwise = ConvNorm(in_channels, features, 1, norm=norm, act=F.relu)

    def forward(self, x):
        return self.pointwise(self.depthwise(x))


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: 1x1 conv, three dilated 3x3 convs and a
    global-pool branch (mean -> 1x1 conv with bias, no norm), concat, 1x1
    projection, dropout. In training mode the dropout mask comes from
    `dropout_generator` (a torch.Generator on the input's device, set by the
    caller), so that a run is reproducible from its seed."""

    def __init__(self, in_channels: int, features: int = 256,
                 dilations: Sequence[int] = (6, 12, 18), norm: str = "GN",
                 dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.dropout_generator: torch.Generator | None = None
        use_bias = norm == ""
        self.conv1x1 = ConvNorm(in_channels, features, 1, use_bias=use_bias,
                                norm=norm, act=F.relu)
        self.dilations = tuple(dilations)
        for i, d in enumerate(self.dilations):
            self.add_module(f"conv3x3_{i}", ConvNorm(
                in_channels, features, 3, dilation=d, use_bias=use_bias,
                norm=norm, act=F.relu))
        self.pool_conv = ConvNorm(in_channels, features, 1, use_bias=True,
                                  norm="", act=F.relu)
        self.project = ConvNorm(features * (len(self.dilations) + 2), features, 1,
                                use_bias=use_bias, norm=norm, act=F.relu)

    def forward(self, x):
        branches = [self.conv1x1(x)]
        for i in range(len(self.dilations)):
            branches.append(getattr(self, f"conv3x3_{i}")(x))
        pooled = self.pool_conv(x.mean(dim=(2, 3), keepdim=True))
        branches.append(pooled.expand_as(branches[0]))
        x = self.project(torch.cat(branches, dim=1))
        if self.training and self.dropout > 0:
            if self.dropout_generator is None:
                raise RuntimeError("ASPP dropout in training mode needs dropout_generator")
            keep = torch.rand(x.shape, generator=self.dropout_generator,
                              device=x.device) >= self.dropout
            x = x * keep / (1.0 - self.dropout)
        return x


def max_pool_same(x, window: int, strides: int):
    """Max pool matching torch MaxPool2d(kernel, stride, padding=k // 2)."""
    return F.max_pool2d(x, window, strides, (window - 1) // 2)


def avg_pool_torch(x):
    """AvgPool2d(3, 2, padding=1) with count_include_pad=True."""
    return F.avg_pool2d(x, 3, 2, 1, count_include_pad=True)


def reset_lecun(model: nn.Module, generator: torch.Generator) -> None:
    """Random init from `generator` after the flax defaults: LeCun-normal
    convolution and dense kernels (std 1 / sqrt(fan_in)), zero biases, PReLU
    slopes 0.25, identity BatchNorm."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                std = 1.0 / math.sqrt(mod.weight[0].numel())
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=generator) * std)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, BatchNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
            elif isinstance(mod, nn.PReLU):
                mod.weight.fill_(0.25)

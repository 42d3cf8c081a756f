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
compute type in the reference, normalise in float32 and return float32 (a
GroupNorm its `out_dtype` where a model gives it flax's dtype). Parameters
stay float32 throughout. `resize_bilinear` is jax.image.resize's bilinear
(antialiased when it shrinks), for the wrappers that resize frames with it.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from quber_tpu_torch.parallel.mesh import all_reduce_sum


def upsample_bilinear(x: torch.Tensor, scale: int | None = None,
                      size: tuple[int, int] | None = None) -> torch.Tensor:
    """Bilinear resize with half-pixel centres (align_corners=False), the
    convention of jax.image.resize for upsampling."""
    if size is None:
        size = (x.shape[2] * scale, x.shape[3] * scale)
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)


@functools.lru_cache(maxsize=None)
def _jax_linear_weights(n_in: int, n_out: int) -> np.ndarray:
    """The [n_in, n_out] float32 weights of jax.image.resize's "bilinear"
    along one axis (jax.image.scale_and_translate with the triangle kernel,
    antialiased: a shrink widens the kernel by in / out), in float32 as the
    reference's compiled resize computes them at the evaluation wrappers'
    sizes (480 / 640 <-> 224): the sample position as one fused multiply-add
    and the division by the kernel's width as a product with its reciprocal."""
    f32 = np.float32
    scale = n_out / n_in
    inv_scale = f32(1.0 / scale)
    kernel_scale = f32(max(1.0 / scale, 1.0))
    cells = np.arange(n_out, dtype=f32) + f32(0.5)
    # a float32 product is exact in float64: one rounding, as a fused multiply-add
    sample = (cells.astype(np.float64) * np.float64(inv_scale) - 0.5).astype(f32)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) * (f32(1.0) / kernel_scale)
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= f32(-0.5)) & (sample <= f32(n_in - 0.5))
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """jax.image.resize(..., "bilinear") of the last two axes of a float
    tensor [..., H, W] -> [..., size[0], size[1]]: separable weight matrices
    (antialiased when shrinking, unlike F.interpolate), two float32 products."""
    h, w = x.shape[-2:]
    out = x.float()
    if size[0] != h:
        wh = torch.from_numpy(_jax_linear_weights(h, size[0])).to(x.device)
        out = torch.matmul(wh.T, out)
    if size[1] != w:
        ww = torch.from_numpy(_jax_linear_weights(w, size[1])).to(x.device)
        out = torch.matmul(out, ww)
    return out


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


def flax_softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """jax.nn.softmax in the input's type, op by op: exp(x - max) over its
    sum (in bfloat16 each step rounds, as XLA's do, jitted or not; torch's
    softmax rounds once)."""
    u = torch.exp(x - x.amax(dim=dim, keepdim=True).detach())
    return u / u.sum(dim=dim, keepdim=True)


class Dense(nn.Linear):
    """nn.Linear computing in `compute_dtype`, like flax's nn.Dense(dtype=...):
    input, kernel and bias are cast to it; below float32 the bias is added to
    the rounded product, as flax adds it."""

    compute_dtype = torch.float32

    def forward(self, x):
        dt = self.compute_dtype
        if dt == torch.float32 or self.bias is None:
            bias = None if self.bias is None else self.bias.to(dt)
            return F.linear(x.to(dt), self.weight.to(dt), bias)
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


def flax_layer_norm(x, weight, bias, eps: float):
    """flax nn.LayerNorm's arithmetic over the last axis, in float32: the
    variance as E[x^2] - E[x]^2, (x - mean) * (rsqrt(var + eps) * scale) +
    bias."""
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x * x).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0)
    return (x - mean) * (torch.rsqrt(var + eps) * weight) + bias


class LayerNorm(nn.Module):
    """flax nn.LayerNorm over the last axis (`flax_layer_norm`), the result
    in `compute_dtype` (float32 unless a model sets bfloat16). flax's
    default eps is 1e-6."""

    compute_dtype = torch.float32

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return flax_layer_norm(x, self.weight, self.bias, self.eps).to(self.compute_dtype)


class ConvTranspose2x2(nn.Module):
    """flax nn.ConvTranspose(features, (2, 2), strides=(2, 2)): each input
    pixel becomes a 2x2 block, out[2i + a, 2j + b] = x[i, j] . K[1 - a, 1 - b]
    (flax does not flip the kernel as torch's ConvTranspose2d does). The
    weight is [out, in, 2, 2], K transposed as models/from_jax carries a conv
    kernel; computes in `compute_dtype`, the bias added after rounding."""

    compute_dtype = torch.float32

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_channels, 2, 2))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        dt = self.compute_dtype
        w = self.weight.to(dt).flip(2, 3).transpose(0, 1)
        if dt == torch.float32:
            return F.conv_transpose2d(x.to(dt), w, self.bias, stride=2)
        return F.conv_transpose2d(x.to(dt), w, stride=2) + self.bias.to(dt)[:, None, None]


class MultiHeadDotProductAttention(nn.Module):
    """flax nn.MultiHeadDotProductAttention(num_heads) for self-attention on
    [B, L, E] (no dropout): query / key / value projections, logits
    q . k / sqrt(head_dim), softmax, the heads merged by `out`. flax keeps
    the projections as [E, heads, head_dim] (and `out` as [heads, head_dim,
    E]); here they are Dense layers over the flattened heads. Computes in
    `compute_dtype` (the Dense layers in their own, which a model sets to
    the same), as flax's dtype does, the softmax included. An optional
    boolean `mask` (broadcast to [B, heads, L, L], True = attend) sets the
    masked logits to the type's lowest finite value, as flax does: a query
    row masked whole gets a uniform, finite softmax (-inf would give NaN)."""

    compute_dtype = torch.float32

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = Dense(dim, dim)
        self.key = Dense(dim, dim)
        self.value = Dense(dim, dim)
        self.out = Dense(dim, dim)

    def forward(self, x, mask=None):
        b, l, e = x.shape
        nh, dt = self.num_heads, self.compute_dtype
        hd = e // nh
        q, k, v = (lin(x).reshape(b, l, nh, hd).transpose(1, 2)
                   for lin in (self.query, self.key, self.value))
        q = q / torch.tensor(hd, dtype=torch.float32).sqrt().to(dt)
        logits = q @ k.transpose(-2, -1)
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        attn = flax_softmax(logits)
        y = (attn @ v).transpose(1, 2).reshape(b, l, e)
        return self.out(y)


def set_compute_dtype(model: nn.Module, dtype: torch.dtype) -> None:
    """Give every Conv, Dense, LayerNorm, transposed conv and attention of
    `model` the compute type `dtype` (flax's module dtype), recorded as
    `model.dtype`."""
    for mod in model.modules():
        if isinstance(mod, (Conv2d, Dense, LayerNorm, ConvTranspose2x2,
                            MultiHeadDotProductAttention)):
            mod.compute_dtype = dtype
    model.dtype = dtype


class GroupNorm(nn.GroupNorm):
    """flax nn.GroupNorm: statistics and normalisation in float32, whatever
    the input's type; the output float32, or `out_dtype` where a model sets
    one (flax's GroupNorm given a dtype)."""

    out_dtype = None

    def forward(self, x):
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps)
        return y if self.out_dtype is None else y.to(self.out_dtype)


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
    takes the BIASED batch variance, as flax's does.

    Data parallel (`mesh`, set by `sync_batch_norm`): under a mesh of world
    size > 1 in training mode the batch moments are those of the GLOBAL
    batch, as the JAX package's BatchNorm computes them under jit over a
    sharded batch: the per-channel sum, sum of squares and count are summed
    over the ranks by a differentiable all-reduce (the gradient flows through
    the global moments), and flax's formula normalises with them (variance
    E[x^2] - E[x]^2, clamped at 0)."""

    momentum = 0.1  # torch's convention: the weight of the new batch

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.mesh = None
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def _global_moments(self, x):
        c = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        count = x.new_full((1,), x.numel() // c)
        sums = all_reduce_sum(torch.cat([x.sum(dims), (x * x).sum(dims), count]), self.mesh)
        n = sums[2 * c].detach()
        mean = sums[:c] / n
        var = (sums[c:2 * c] / n - mean * mean).clamp_min(0.0)
        return mean, var

    def forward(self, x):
        x = x.float()
        if self.training and self.mesh is not None and self.mesh.distributed:
            mean, var = self._global_moments(x)
            shape = (-1,) + (1,) * (x.dim() - 2)
            mul = torch.rsqrt(var + self.eps) * self.weight
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
            return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        if not self.training:
            if isinstance(self.running_mean, nn.Parameter):
                # statistics a recipe trains: flax's formula, differentiable in them
                shape = (-1,) + (1,) * (x.dim() - 2)
                mul = torch.rsqrt(self.running_var + self.eps) * self.weight
                return (x - self.running_mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
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


def sync_batch_norm(module: nn.Module, mesh) -> nn.Module:
    """Hands `mesh` (parallel.mesh.Mesh, or None for local moments) to every
    BatchNorm of `module`."""
    for mod in module.modules():
        if isinstance(mod, BatchNorm):
            mod.mesh = mesh
    return module


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

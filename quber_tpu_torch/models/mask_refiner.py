"""The QuBER MaskRefiner meta-architecture: config, forward and losses
(torch, NCHW).

Port of quber_tpu/models/mask_refiner.py. Defaults correspond to the
flagship config `mask_refiner_rgbd_concat_l2_gn_hf_m_b_f_c_o_l3_e2_b8.yaml`.
The forward runs in the config's `dtype`: float32 (the default), or
bfloat16 with float32 parameters, cast where the reference casts (the input
standardised in float32, then every convolution in bfloat16, the norms'
outputs in float32; models/layers.py), and the outputs cast to float32
before the x4 upsample. The losses keep the reference's channel order with
the channel axis moved to dim 1.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
from torch import nn

from quber_tpu_torch.models.heads import ERROR_TYPE_CHANNELS, InsEmbedHead
from quber_tpu_torch.models.layers import ASPP, Conv2d, upsample_bilinear
from quber_tpu_torch.models.resnet import RGBDFusionBackbone, SingleTrunkBackbone
from quber_tpu_torch.parallel.mesh import all_gather, all_reduce_sum


@dataclasses.dataclass(frozen=True)
class MaskRefinerConfig:
    # input
    height: int = 480
    width: int = 640
    rgb_on: bool = True
    depth_on: bool = True
    offset_input_on: bool = True
    pixel_mean: Sequence[float] = (103.530, 116.280, 123.675, 127.5, 127.5, 127.5)
    pixel_std: Sequence[float] = (1.0, 1.0, 1.0, 1.0, 1.0, 1.0)
    # backbone
    resnet_depth: int = 50
    backbone_norm: str = "FrozenBN"
    fusion_strategy: str = "concat"
    num_backbone_fusion_layers: int = 2
    # head
    in_features: Sequence[str] = ("res2", "res3", "res5")
    project_channels: Sequence[int] = (32, 64)
    aspp_channels: int = 256
    aspp_dilations: Sequence[int] = (6, 12, 18)
    aspp_dropout: float = 0.1
    convs_dim: int = 128
    head_channels: int = 32
    common_stride: int = 4
    norm: str = "GN"
    # the decoder and the prediction heads follow separate depthwise flags
    use_depthwise_separable_conv: bool = False
    head_depthwise_separable: bool = False
    # error estimation
    eee_mask_on: bool = True
    eee_boundary_on: bool = True
    error_type: str = "e2"
    hierarchical_fusion_on: bool = True
    hierarchy: Sequence[Sequence[str]] = (
        ("eee_mask",), ("eee_boundary",), ("foreground",), ("center",), ("offset",)
    )
    num_head_fusion_layers: int = 3
    fusion_target: Sequence[str] = ("feat", "pred")
    # losses
    foreground_loss_type: str = "hard_pixel_mining"
    foreground_loss_top_k: float = 1.0
    foreground_loss_weight: float = 1.0
    center_loss_weight: float = 200.0
    offset_loss_weight: float = 0.01
    eee_mask_loss_weight: float = 1.0
    eee_boundary_loss_weight: float = 1.0
    # post-processing
    center_threshold: float = 0.3
    nms_kernel: int = 7
    top_k_instances: int = 200
    stuff_area: int = 2048
    min_instance_area: int = 512
    # adaptive grouping: a frame whose NMS survivor count fits in fast_top_k
    # groups and merges at K = fast_top_k (the survivors are row-major
    # sorted with valids first, so the slice keeps them all); 0 disables
    fast_top_k: int = 32
    # compute
    dtype: str = "float32"
    # recompute the trunk blocks' activations in the backward pass
    remat_backbone: bool = False
    # the JAX package's Pallas switch; the port picks its kernel by the
    # device of the tensors, so this field is read by nothing here
    use_pallas_grouping: bool | None = None

    @property
    def eee_channels(self) -> int:
        return ERROR_TYPE_CHANNELS[self.error_type]

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def num_input_channels(self) -> int:
        return 3 * (int(self.rgb_on) + int(self.depth_on) + int(self.offset_input_on))


class MaskRefiner(nn.Module):
    """Backbone + hierarchical head.

    forward(images [B,6,H,W] (or [B,3,H,W] for a single-modality config),
    offset_enc [B,3,H,W] | None) -> dict of
    full-resolution outputs: foreground [B,1,H,W] logits, center [B,1,H,W],
    offset [B,2,H,W] in pixels, eee_mask / eee_boundary [B,C,H,W] logits.
    With full_res=False the stride-4 head outputs are returned.
    """

    def __init__(self, config: MaskRefinerConfig = MaskRefinerConfig()):
        super().__init__()
        cfg = config
        if not (cfg.rgb_on or cfg.depth_on):
            raise ValueError("a MaskRefiner needs rgb_on or depth_on")
        if cfg.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype {cfg.dtype}: float32 or bfloat16")
        self.config = cfg
        # the channels of a packed 6-channel frame (BGR, depth) the model reads
        self.channels = (0 if cfg.rgb_on else 3, 6 if cfg.depth_on else 3)
        self.register_buffer("pixel_mean", torch.tensor(cfg.pixel_mean, dtype=torch.float32)
                             .view(-1, 1, 1), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(cfg.pixel_std, dtype=torch.float32)
                             .view(-1, 1, 1), persistent=False)
        if cfg.rgb_on and cfg.depth_on:
            self.backbone = RGBDFusionBackbone(
                fusion_strategy=cfg.fusion_strategy,
                num_fusion_layers=cfg.num_backbone_fusion_layers,
                depth=cfg.resnet_depth, out_features=tuple(cfg.in_features),
                norm=cfg.backbone_norm, offset_input=cfg.offset_input_on,
                remat=cfg.remat_backbone,
            )
        else:
            self.backbone = SingleTrunkBackbone(
                3 + 3 * cfg.offset_input_on, depth=cfg.resnet_depth,
                out_features=tuple(cfg.in_features), norm=cfg.backbone_norm,
                remat=cfg.remat_backbone,
            )
        self.ins_embed_head = InsEmbedHead(
            self.backbone.out_channels,
            in_features=tuple(cfg.in_features),
            project_channels=tuple(cfg.project_channels),
            aspp_channels=cfg.aspp_channels,
            aspp_dilations=tuple(cfg.aspp_dilations),
            convs_dim=cfg.convs_dim, head_channels=cfg.head_channels,
            norm=cfg.norm,
            use_depthwise_separable_conv=cfg.use_depthwise_separable_conv,
            eee_mask_on=cfg.eee_mask_on, eee_boundary_on=cfg.eee_boundary_on,
            error_type=cfg.error_type,
            hierarchical_fusion_on=cfg.hierarchical_fusion_on,
            hierarchy=tuple(tuple(h) for h in cfg.hierarchy),
            num_fusion_layers=cfg.num_head_fusion_layers,
            fusion_target=tuple(cfg.fusion_target),
            head_depthwise_separable=cfg.head_depthwise_separable,
            aspp_dropout=cfg.aspp_dropout,
        )
        for mod in self.modules():
            if isinstance(mod, Conv2d):
                mod.compute_dtype = cfg.compute_dtype

    def set_dropout_generator(self, generator: torch.Generator | None) -> None:
        """The generator (on the model's device) that training-mode dropout
        draws its masks from."""
        for mod in self.modules():
            if isinstance(mod, ASPP):
                mod.dropout_generator = generator

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random init from `generator`, with the JAX package's initialisers:
        LeCun-normal convs (normal(0.001) for the 1x1 predictors), zero
        biases, unit norm scales and identity norm statistics."""
        reset_parameters(self, generator)

    def forward(self, images, offset_enc=None, full_res: bool = True):
        # a single-modality model takes its slice of a packed 6-channel frame;
        # a frame of its own channels alone passes through. Without
        # offset_input_on, offset_enc is not read.
        lo, hi = self.channels
        if images.shape[1] == 6 and (lo, hi) != (0, 6):
            images = images[:, lo:hi]
        c = images.shape[1]
        x = (images.float() - self.pixel_mean[lo:hi][:c]) / self.pixel_std[lo:hi][:c]
        if self.config.offset_input_on:
            if offset_enc is None:
                raise ValueError("offset_input_on needs offset_enc")
            x = torch.cat([x, offset_enc.float()], dim=1)
        outputs = self.ins_embed_head(self.backbone(x.to(self.config.compute_dtype)))
        outputs = {k: v.float() for k, v in outputs.items()}
        if not full_res:
            return outputs
        return upsample_outputs(outputs, self.config.common_stride)


@torch.no_grad()
def reset_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """MaskRefiner.reset_parameters for any module built of the refiner's
    layers (the Panoptic-DeepLab baseline too)."""
    for name, mod in model.named_modules():
        if isinstance(mod, nn.Conv2d):
            fan_in = mod.weight[0].numel()
            std = 0.001 if name.endswith("_predictor") else 1.0 / math.sqrt(fan_in)
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=generator) * std)
            if mod.bias is not None:
                mod.bias.zero_()
        elif hasattr(mod, "running_var") or isinstance(mod, nn.GroupNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            if hasattr(mod, "running_var"):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)


def upsample_outputs(outputs: dict, common_stride: int) -> dict:
    """x4 bilinear upsample of all heads; offsets scaled to pixel units."""
    up = {k: upsample_bilinear(v, scale=common_stride) for k, v in outputs.items()}
    if "offset" in up:
        up["offset"] = up["offset"] * common_stride
    return up


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def _bce_with_logits(logits, targets):
    return logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def foreground_loss(logits, targets, weights=None, top_k: float = 1.0, mesh=None):
    """Hard-pixel-mining BCE: logits [B, H, W] raw, targets {0, 1}, weights
    multiply the per-pixel losses; top_k < 1 keeps the largest top_k fraction
    of the pixel losses of the whole batch. Under a data-parallel `mesh`
    (parallel.mesh.Mesh) this rank's share of the global batch's loss: the
    local mean over the world size, or with top_k < 1 the rank's own pixels
    among the global top k of the gathered pixel losses, over k."""
    pixel = _bce_with_logits(logits, targets.float())
    if weights is not None:
        pixel = pixel * weights
    flat = pixel.reshape(-1)
    if mesh is not None and mesh.distributed:
        if top_k >= 1.0:
            return flat.mean() / mesh.world_size
        every, sizes = all_gather(flat, mesh)
        k = max(1, int(top_k * every.shape[0]))
        start = sum(sizes[:mesh.rank])
        idx = torch.topk(every, k, sorted=False).indices - start
        own = idx[(idx >= 0) & (idx < flat.shape[0])]
        return flat[own].sum() / k
    if top_k >= 1.0:
        return flat.mean()
    k = max(1, int(top_k * flat.shape[0]))
    return torch.topk(flat, k, sorted=False).values.mean()


def _weighted_mean(loss, weights, mesh=None):
    """sum(loss) / sum(weights), 0 when the weights sum to 0; under a
    data-parallel `mesh` the local sum over the weights' global sum."""
    wsum = weights.sum()
    if mesh is not None and mesh.distributed:
        wsum = all_reduce_sum(wsum.detach(), mesh)
    return torch.where(wsum > 0, loss.sum() / wsum.clamp_min(1.0), 0.0)


def weighted_mse_loss(pred, target, weights, mesh=None):
    """Centre loss: sum(mse * w) / sum(w), 0 when the weights sum to 0."""
    return _weighted_mean((pred - target) ** 2 * weights, weights, mesh)


def weighted_l1_loss(pred, target, weights, mesh=None):
    """Offset loss: sum(|d| * w) / sum(w); w [B, 1, H, W] broadcasts over the
    two offset channels but its normalising sum is counted once."""
    return _weighted_mean((pred - target).abs() * weights, weights, mesh)


def dice_loss(logits, targets, smooth: float = 1e-5, mesh=None):
    """Softmax Dice over the channel axis of [B, C, H, W], sums over H, W per
    (batch, channel), then the mean (monai DiceLoss(softmax=True) defaults);
    under a data-parallel `mesh` the local mean over the world size."""
    p = torch.softmax(logits, dim=1)
    t = targets.float()
    inter = (p * t).sum(dim=(2, 3))
    denom = p.sum(dim=(2, 3)) + t.sum(dim=(2, 3))
    loss = (1.0 - (2.0 * inter + smooth) / (denom + smooth)).mean()
    return loss / mesh.world_size if mesh is not None and mesh.distributed else loss


def assemble_eee_targets(tp, tn, fp, fn, error_type: str):
    """Stack the four error maps [..., H, W] into the error_type channel
    layout -> [..., C, H, W]."""
    if error_type == "e3":
        chans = [tp, tn, fp, fn]
    elif error_type == "e2":
        chans = [tp + tn, fp + fn]
    elif error_type == "e33":
        chans = [tp + tn, fp, fn]
    elif error_type == "e32":
        chans = [fp, fn]
    else:
        raise ValueError(error_type)
    return torch.stack(chans, dim=-3)


def compute_losses(outputs: dict, targets: dict, cfg: MaskRefinerConfig, mesh=None) -> dict:
    """All training losses from the stride-4 head outputs (full_res=False)
    and full-resolution targets: sem_seg [B, H, W], sem_seg_weights [B, H, W]
    (optional), center [B, H, W], center_weights [B, H, W], offset
    [B, 2, H, W], offset_weights [B, H, W], eee_mask / eee_boundary
    [B, C, H, W]. Under a data-parallel `mesh` each loss is this rank's
    share of the global batch's loss: the shares sum to it over the ranks."""
    s = cfg.common_stride
    losses = {}
    fg = upsample_bilinear(outputs["foreground"], scale=s)[:, 0]
    losses["loss_sem_seg"] = foreground_loss(
        fg, targets["sem_seg"], targets.get("sem_seg_weights"),
        cfg.foreground_loss_top_k, mesh) * cfg.foreground_loss_weight
    center = upsample_bilinear(outputs["center"], scale=s)[:, 0]
    losses["loss_center"] = weighted_mse_loss(
        center, targets["center"], targets["center_weights"], mesh) * cfg.center_loss_weight
    offset = upsample_bilinear(outputs["offset"], scale=s) * s
    losses["loss_offset"] = weighted_l1_loss(
        offset, targets["offset"], targets["offset_weights"][:, None],
        mesh) * cfg.offset_loss_weight
    if cfg.eee_mask_on:
        pred = upsample_bilinear(outputs["eee_mask"], scale=s)
        losses["loss_eee_mask"] = (dice_loss(pred, targets["eee_mask"], mesh=mesh)
                                   * cfg.eee_mask_loss_weight)
    if cfg.eee_boundary_on:
        pred = upsample_bilinear(outputs["eee_boundary"], scale=s)
        losses["loss_eee_boundary"] = (dice_loss(pred, targets["eee_boundary"], mesh=mesh)
                                       * cfg.eee_boundary_loss_weight)
    return losses

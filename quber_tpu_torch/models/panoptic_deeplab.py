"""The stock Panoptic-DeepLab meta-architecture, the ablation study's baseline
(torch, NCHW).

Port of quber_tpu/models/panoptic_deeplab.py: the dual-trunk RGB-D backbone
without the offset input, then TWO DeepLabV3+ decoders over its features: a
semantic branch (a 256-channel head, binary foreground, hard-pixel-mining
BCE over the top 20% of the pixels) and an instance branch (32-channel
centre and offset heads). It is a plain segmenter, so it takes no initial
masks; its outputs go through the refiner's grouping.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from quber_tpu_torch.models.heads import DeepLabV3PlusDecoder, SinglePredictionHead
from quber_tpu_torch.models.layers import Conv2d, upsample_bilinear
from quber_tpu_torch.models.mask_refiner import (
    MaskRefinerConfig,
    foreground_loss,
    reset_parameters,
    upsample_outputs,
    weighted_l1_loss,
    weighted_mse_loss,
)
from quber_tpu_torch.models.resnet import RGBDFusionBackbone


@dataclasses.dataclass(frozen=True)
class PanopticDeepLabConfig(MaskRefinerConfig):
    offset_input_on: bool = False
    eee_mask_on: bool = False
    eee_boundary_on: bool = False
    hierarchical_fusion_on: bool = False
    sem_seg_head_channels: int = 256    # SEM_SEG_HEAD.HEAD_CHANNELS
    foreground_loss_top_k: float = 0.2  # SEM_SEG_HEAD.LOSS_TOP_K


class PanopticDeepLab(nn.Module):
    """forward(images [B, 6, H, W]) -> {foreground [B,1,H,W], center
    [B,1,H,W], offset [B,2,H,W] in pixels} at full resolution, or at stride
    `common_stride` with full_res=False."""

    def __init__(self, config: PanopticDeepLabConfig = PanopticDeepLabConfig()):
        super().__init__()
        cfg = config
        self.config = cfg
        self.register_buffer("pixel_mean", torch.tensor(cfg.pixel_mean, dtype=torch.float32)
                             .view(-1, 1, 1), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(cfg.pixel_std, dtype=torch.float32)
                             .view(-1, 1, 1), persistent=False)
        self.backbone = RGBDFusionBackbone(
            fusion_strategy=cfg.fusion_strategy,
            num_fusion_layers=cfg.num_backbone_fusion_layers,
            depth=cfg.resnet_depth, out_features=tuple(cfg.in_features),
            norm=cfg.backbone_norm, offset_input=False)
        decoder_kwargs = dict(
            in_features=tuple(cfg.in_features),
            project_channels=tuple(cfg.project_channels),
            aspp_channels=cfg.aspp_channels,
            aspp_dilations=tuple(cfg.aspp_dilations),
            convs_dim=cfg.convs_dim, norm=cfg.norm,
            use_depthwise_separable_conv=cfg.use_depthwise_separable_conv,
            aspp_dropout=cfg.aspp_dropout)
        dws = cfg.use_depthwise_separable_conv
        self.sem_decoder = DeepLabV3PlusDecoder(self.backbone.out_channels, **decoder_kwargs)
        y_ch = self.sem_decoder.out_channels
        self.sem_head = SinglePredictionHead(y_ch, cfg.sem_seg_head_channels, cfg.norm, dws)
        self.sem_predictor = Conv2d(cfg.sem_seg_head_channels, 1, 1)
        self.ins_decoder = DeepLabV3PlusDecoder(self.backbone.out_channels, **decoder_kwargs)
        self.center_head = SinglePredictionHead(y_ch, cfg.head_channels, cfg.norm, dws)
        self.center_predictor = Conv2d(cfg.head_channels, 1, 1)
        self.offset_head = SinglePredictionHead(y_ch, cfg.head_channels, cfg.norm, dws)
        self.offset_predictor = Conv2d(cfg.head_channels, 2, 1)
        for mod in self.modules():
            if isinstance(mod, Conv2d):
                mod.compute_dtype = cfg.compute_dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random init from `generator`, as MaskRefiner.reset_parameters."""
        reset_parameters(self, generator)

    def forward(self, images, full_res: bool = True):
        x = (images.float() - self.pixel_mean) / self.pixel_std
        features = self.backbone(x.to(self.config.compute_dtype))
        y_sem = self.sem_decoder(features)
        y_ins = self.ins_decoder(features)
        out = {
            "foreground": self.sem_predictor(self.sem_head(y_sem)),
            "center": self.center_predictor(self.center_head(y_ins)),
            "offset": self.offset_predictor(self.offset_head(y_ins)),
        }
        out = {k: v.float() for k, v in out.items()}
        if not full_res:
            return out
        return upsample_outputs(out, self.config.common_stride)


def compute_pd_losses(outputs: dict, targets: dict, cfg: PanopticDeepLabConfig) -> dict:
    """The baseline's losses from its stride-4 outputs (full_res=False) and the
    full-resolution targets of mask_refiner.compute_losses."""
    s = cfg.common_stride
    fg = upsample_bilinear(outputs["foreground"], scale=s)[:, 0]
    center = upsample_bilinear(outputs["center"], scale=s)[:, 0]
    offset = upsample_bilinear(outputs["offset"], scale=s) * s
    return {
        "loss_sem_seg": foreground_loss(
            fg, targets["sem_seg"], targets.get("sem_seg_weights"),
            cfg.foreground_loss_top_k) * cfg.foreground_loss_weight,
        "loss_center": weighted_mse_loss(
            center, targets["center"], targets["center_weights"]) * cfg.center_loss_weight,
        "loss_offset": weighted_l1_loss(
            offset, targets["offset"], targets["offset_weights"][:, None])
        * cfg.offset_loss_weight,
    }

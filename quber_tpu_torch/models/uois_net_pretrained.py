"""The released UOIS-Net-3D's architectures (DSN and RRN), whose state dicts
the reference's checkpoints fill (torch, NCHW).

Port of quber_tpu/models/uois_net_pretrained.py:
  * DSN: a UNet-ESP encoder over the XYZ cloud (Conv-GN-ReLU pairs, ESP
    modules of dilated pyramids), its decoder and two bias-free 1x1 heads:
    3 classes (background, table, object) and 3D centre offsets;
  * RRN: a UNet encoder over RGB + mask, its decoder (one encoder) and a
    bias-free 1x1 foreground head;
  * the wrapper: the object class's pixels clustered by Euclidean mean-shift
    of their votes (bandwidth 0.02, merge 0.05, at least 300 pixels), the
    instances opened then closed (4 iterations of 3x3), and the RRN over a
    224x224 crop of each, padded by a quarter, pasted back by
    ops/zoom.zoom_refine_labels.

Every submodule carries the reference's name (and so the flax port's), so
models/import_zoo fills it from a reference state dict by copying and
models/from_jax from a flax tree by renaming. The GroupNorms have
`feature_dim` groups and eps 1e-5; with dtype bfloat16 the convolutions
compute in bfloat16 and the GroupNorms return bfloat16 (statistics in
float32), as flax's GroupNorm given a dtype does.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from quber_tpu_torch.models.layers import (
    Conv2d, GroupNorm, reset_lecun, set_compute_dtype, upsample_bilinear)


def set_dtype(model: nn.Module, dtype: torch.dtype) -> None:
    """The compute type of every convolution and the output type of every
    GroupNorm of `model` (flax's dtype of both)."""
    set_compute_dtype(model, dtype)
    for mod in model.modules():
        if isinstance(mod, GroupNorm):
            mod.out_dtype = dtype


def _conv(cin, cout, k=3, dilation=1, bias=False):
    return Conv2d(cin, cout, k, padding=dilation * (k - 1) // 2, dilation=dilation, bias=bias)


class ConvGNReLU(nn.Module):
    """Conv2d_GN_ReLU: bias-free conv + GroupNorm + ReLU."""

    def __init__(self, cin: int, cout: int, num_groups: int, ksize: int = 3):
        super().__init__()
        self.conv1 = _conv(cin, cout, ksize)
        self.gn1 = GroupNorm(num_groups, cout, eps=1e-5)

    def forward(self, x):
        return F.relu(self.gn1(self.conv1(x)))


class ConvGNReLUx2(nn.Module):
    def __init__(self, cin: int, cout: int, num_groups: int):
        super().__init__()
        self.layer1 = ConvGNReLU(cin, cout, num_groups)
        self.layer2 = ConvGNReLU(cout, cout, num_groups)

    def forward(self, x):
        return self.layer2(self.layer1(x))


class ESPModule(nn.Module):
    """ESP module (GN / ReLU): a reduction, a dilated pyramid (1, 2, 4, 8,
    16), hierarchical feature fusion and a residual add."""

    def __init__(self, features: int, num_groups: int, ksize: int = 1):
        super().__init__()
        n = features // 5
        n1 = features - 4 * n
        self.conv1 = _conv(features, n, ksize)
        self.dilated1 = _conv(n, n1, 3, 1)
        for rate in (2, 4, 8, 16):
            self.add_module(f"dilated{rate}", _conv(n, n, 3, rate))
        self.gn = GroupNorm(num_groups, features, eps=1e-5)

    def forward(self, x):
        r = self.conv1(x)
        d1 = self.dilated1(r)
        add1 = self.dilated2(r)
        add2 = add1 + self.dilated4(r)
        add3 = add2 + self.dilated8(r)
        add4 = add3 + self.dilated16(r)
        y = x + torch.cat([d1, add1, add2, add3, add4], dim=1)
        return F.relu(self.gn(y))


class UpCatConvGNReLU(nn.Module):
    """Upsample_Concat_Conv2d_GN_ReLU: a channel-halving Conv-GN-ReLU, a 2x
    bilinear upsample, the skip concatenated, a Conv-GN-ReLU."""

    def __init__(self, cin: int, cskip: int, cout: int, num_groups: int):
        super().__init__()
        self.channel_reduction_layer = ConvGNReLU(cin, cin // 2, num_groups)
        self.conv_gn_relu = ConvGNReLU(cin // 2 + cskip, cout, num_groups)

    def forward(self, x, skip):
        y = self.channel_reduction_layer(x)
        d = y.dtype
        y = upsample_bilinear(y.float(), scale=2).to(d)
        return self.conv_gn_relu(torch.cat([y, skip.to(d)], dim=1))


class UNetESPEncoder(nn.Module):
    def __init__(self, cin: int, fd: int):
        super().__init__()
        self.layer1 = ConvGNReLUx2(cin, fd, fd)
        self.layer2 = ConvGNReLUx2(fd, fd * 2, fd)
        self.layer3a = ConvGNReLU(fd * 2, fd * 4, fd)
        self.layer3b = ESPModule(fd * 4, fd, ksize=3)
        self.layer4a = ConvGNReLU(fd * 4, fd * 8, fd)
        self.layer4b = ESPModule(fd * 8, fd, ksize=3)
        self.last_layer = ConvGNReLU(fd * 8, fd * 16, fd)

    def forward(self, x):
        x1 = self.layer1(x)
        x2 = self.layer2(F.max_pool2d(x1, 2))
        x3 = self.layer3b(self.layer3a(F.max_pool2d(x2, 2)))
        x4 = self.layer4b(self.layer4a(F.max_pool2d(x3, 2)))
        x5 = self.last_layer(F.max_pool2d(x4, 2))
        return x5, [x1, x2, x3, x4]


class UNetESPDecoder(nn.Module):
    def __init__(self, fd: int):
        super().__init__()
        self.fuse_layer = ESPModule(fd * 16, fd, ksize=1)
        self.layer1 = UpCatConvGNReLU(fd * 16, fd * 8, fd * 8, fd)
        self.layer2 = UpCatConvGNReLU(fd * 8, fd * 4, fd * 4, fd)
        self.layer3 = UpCatConvGNReLU(fd * 4, fd * 2, fd * 2, fd)
        self.layer4 = UpCatConvGNReLU(fd * 2, fd, fd, fd)
        self.layer5 = ConvGNReLU(fd, fd, fd)
        self.last_conv = _conv(fd, fd, 3, bias=True)

    def forward(self, x, skips):
        y = self.fuse_layer(x)
        for i, layer in enumerate((self.layer1, self.layer2, self.layer3, self.layer4)):
            y = layer(y, skips[3 - i])
        return self.last_conv(self.layer5(y))


class UNetEncoder(nn.Module):
    def __init__(self, cin: int, fd: int):
        super().__init__()
        self.layer1 = ConvGNReLUx2(cin, fd, fd)
        self.layer2 = ConvGNReLUx2(fd, fd * 2, fd)
        self.layer3 = ConvGNReLUx2(fd * 2, fd * 4, fd)
        self.layer4 = ConvGNReLUx2(fd * 4, fd * 8, fd)
        self.last_layer = ConvGNReLU(fd * 8, fd * 16, fd)

    def forward(self, x):
        x1 = self.layer1(x)
        x2 = self.layer2(F.max_pool2d(x1, 2))
        x3 = self.layer3(F.max_pool2d(x2, 2))
        x4 = self.layer4(F.max_pool2d(x3, 2))
        x5 = self.last_layer(F.max_pool2d(x4, 2))
        return x5, [x1, x2, x3, x4]


class UNetDecoder(nn.Module):
    """UNet_Decoder with one encoder: a 1x1 Conv-GN-ReLU fuse and four
    up-concat stages."""

    def __init__(self, fd: int):
        super().__init__()
        self.fuse_layer = ConvGNReLU(fd * 16, fd * 16, fd, ksize=1)
        self.layer1 = UpCatConvGNReLU(fd * 16, fd * 8, fd * 8, fd)
        self.layer2 = UpCatConvGNReLU(fd * 8, fd * 4, fd * 4, fd)
        self.layer3 = UpCatConvGNReLU(fd * 4, fd * 2, fd * 2, fd)
        self.layer4 = UpCatConvGNReLU(fd * 2, fd, fd, fd)
        self.layer5 = ConvGNReLU(fd, fd, fd)
        self.last_conv = _conv(fd, fd, 3, bias=True)

    def forward(self, x, skips):
        y = self.fuse_layer(x)
        for i, layer in enumerate((self.layer1, self.layer2, self.layer3, self.layer4)):
            y = layer(y, skips[3 - i])
        return self.last_conv(self.layer5(y))


class PretrainedDSN(nn.Module):
    """XYZ [B, 3, H, W] -> (class logits [B, 3, H, W] background / table /
    object, centre offsets [B, 3, H, W]), float32."""

    def __init__(self, feature_dim: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        fd = feature_dim
        self.encoder = UNetESPEncoder(3, fd)
        self.decoder = UNetESPDecoder(fd)
        self.fg_module = _conv(fd, 3, 1)
        self.cd_module = _conv(fd, 3, 1)
        set_dtype(self, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_lecun(self, generator)

    def forward(self, xyz):
        x5, skips = self.encoder(xyz.to(self.dtype))
        feats = self.decoder(x5, skips)
        return self.fg_module(feats).float(), self.cd_module(feats).float()


class PretrainedRRN(nn.Module):
    """RGB + mask [B, 4, 224, 224] -> foreground logit [B, 224, 224], float32."""

    def __init__(self, feature_dim: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        fd = feature_dim
        self.encoder = UNetEncoder(4, fd)
        self.decoder = UNetDecoder(fd)
        self.fg_module = _conv(fd, 1, 1)
        set_dtype(self, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_lecun(self, generator)

    def forward(self, x):
        x5, skips = self.encoder(x.to(self.dtype))
        return self.fg_module(self.decoder(x5, skips)).float()[:, 0]


class UOISNet3DPretrainedBaseModel:
    """Evaluation wrapper of the released weights: predict(rgb_path,
    depth_path) -> (masks [N, 480, 640] bool, foreground [480, 640] bool,
    seconds).

    The frame is read as UOISNet3DBaseModel reads it; DSN and RRN run in
    bfloat16, as the reference's wrapper runs them. `dsn_params` /
    `rrn_params` are state dicts or flax-layout trees; without them the
    nets are initialised from `seed` and `seed + 1`. `feature_dim` is read
    off the weights where it is not given (64, the released models', for
    a random init)."""

    MAX_INSTANCES = 24
    ZOOM = 224
    H, W = 480, 640

    def __init__(self, dsn_params=None, rrn_params=None, dataset: str = "OSD", seed: int = 0,
                 feature_dim: int | None = None, device="cuda"):
        from quber_tpu_torch.models.from_jax import as_state_dict

        self.device = torch.device(device)
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False

        def make(cls, params, s):
            sd = None if params is None else as_state_dict(params)
            fd = feature_dim or (64 if sd is None
                                 else int(sd["encoder.layer1.layer1.conv1.weight"].shape[0]))
            model = cls(feature_dim=fd, dtype=torch.bfloat16)
            if sd is None:
                model.reset_parameters(torch.Generator().manual_seed(s))
            else:
                model.load_state_dict(sd, strict=True)
            return model.to(self.device).eval()

        self.dsn = make(PretrainedDSN, dsn_params, seed)
        self.rrn = make(PretrainedRRN, rrn_params, seed + 1)
        self.dataset = dataset

    def _refine_crops(self, rgb, labels, boxes, valid, ids):
        from quber_tpu_torch.ops.boxes import roi_align, roi_align_each

        z = self.ZOOM
        crop_rgb = roi_align(rgb, boxes, out_size=z)
        masks = (labels[None] == ids[:, None, None]).float()
        crop_mask = roi_align_each(masks, boxes, z)[:, None]
        logit = self.rrn(torch.cat([crop_rgb, (crop_mask > 0.5).float()], dim=1))
        return (torch.sigmoid(logit) > 0.5).float()

    @torch.inference_mode()
    def segment(self, rgb: torch.Tensor, xyz: torch.Tensor):
        """Standardised RGB [3, H, W] and XYZ [3, H, W] on the device ->
        (labels [H, W] int32, instance count 0-d int32, foreground [H, W]
        bool)."""
        from quber_tpu_torch.ops.meanshift import cluster_points_euclidean
        from quber_tpu_torch.ops.zoom import zoom_refine_labels

        from quber_tpu_torch.models.uois_net import open_close

        fg_logits, offsets = self.dsn(xyz[None])
        fg = (torch.argmax(fg_logits[0], dim=0) == 2).float()
        votes = (xyz + offsets[0]).permute(1, 2, 0)
        n_inst = self.MAX_INSTANCES
        clustered = cluster_points_euclidean(votes, fg, num_seeds=n_inst, bandwidth=0.02,
                                             merge_distance=0.05, min_pixels=300)
        ids = torch.arange(1, n_inst + 1, device=fg.device)
        closed = open_close((clustered["labels"][None] == ids[:, None, None]).float(), 4)
        labels = torch.where((closed > 0).any(dim=0),
                             torch.argmax(closed, dim=0).to(torch.int32) + 1, 0)
        full = zoom_refine_labels(
            labels, lambda boxes, valid, slot_ids: self._refine_crops(rgb, labels, boxes, valid,
                                                                      slot_ids),
            n_inst, self.ZOOM, pad_ratio=0.25)
        return full, clustered["num_instances"], fg > 0

    def predict(self, rgb_path, depth_path):
        from quber_tpu_torch.models.ucn import read_rgb_xyz

        rgb_in, xyz = read_rgb_xyz(rgb_path, depth_path, (self.H, self.W))
        t0 = time.time()
        rgb_t = torch.from_numpy(np.ascontiguousarray(rgb_in.transpose(2, 0, 1))).to(self.device)
        xyz_t = torch.from_numpy(np.ascontiguousarray(xyz.transpose(2, 0, 1))).to(self.device)
        labels, _, fg = self.segment(rgb_t, xyz_t)
        labels, fg = labels.cpu().numpy(), fg.cpu().numpy()
        elapsed = time.time() - t0
        masks = [labels == i for i in range(1, self.MAX_INSTANCES + 1) if np.any(labels == i)]
        return np.asarray(masks, dtype=bool).reshape(-1, self.H, self.W), fg, elapsed

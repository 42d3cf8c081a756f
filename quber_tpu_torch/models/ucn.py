"""UCN base segmenter: ResNet-34-8s metric embeddings clustered by mean-shift
(torch, NCHW).

Port of quber_tpu/models/ucn.py: a stride-8 ResNet-34 on the RGB frame and
another on its XYZ point cloud, each with a 1x1 embedding conv, their
embeddings added, upsampled x8 (bilinear, half-pixel centres) and
normalised to unit length; ops/meanshift.py clusters them into instances.
With zoom-in a second stage embeds a 224x224 crop around each instance,
clusters its foreground again and keeps the largest component
(ops/zoom.py).

The BatchNorm layers always normalise with their running statistics, and
those statistics are parameters: the reference's training recipe takes its
gradient over the whole variable tree, running mean and variance included,
without a training mode (tools/train_zoo.py). `RunningBatchNorm` writes the
normalisation out, since F.batch_norm does not differentiate its running
statistics.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from quber_tpu_torch.models.layers import max_pool_same, upsample_bilinear
from quber_tpu_torch.ops.meanshift import cluster_embeddings, l2_normalize, label_counts


class RunningBatchNorm(nn.Module):
    """flax nn.BatchNorm(use_running_average=True) with its running mean and
    variance held as trainable parameters: (x - mean) * (rsqrt(var + eps) *
    scale) + bias, in flax's order of operations."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.running_mean = nn.Parameter(torch.zeros(channels))
        self.running_var = nn.Parameter(torch.ones(channels))

    def forward(self, x):
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x - self.running_mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


def _conv(in_ch, out_ch, k, stride=1, dilation=1, bias=False):
    return nn.Conv2d(in_ch, out_ch, k, stride=stride, padding=dilation * (k // 2),
                     dilation=dilation, bias=bias)


class BasicBlock(nn.Module):
    """torchvision's BasicBlock: two 3x3 convs at `dilation`, the first at
    `stride`, and a 1x1 projection shortcut (no dilation) where the width or
    the stride changes."""

    def __init__(self, in_channels: int, features: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        self.conv1 = _conv(in_channels, features, 3, stride, dilation)
        self.bn1 = RunningBatchNorm(features)
        self.conv2 = _conv(features, features, 3, 1, dilation)
        self.bn2 = RunningBatchNorm(features)
        self.downsample = in_channels != features or stride > 1
        if self.downsample:
            self.downsample_conv = _conv(in_channels, features, 1, stride)
            self.downsample_bn = RunningBatchNorm(features)

    def forward(self, x):
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        if self.downsample:
            x = self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + x)


# (features, blocks, stride, first block's dilation, later blocks' dilation):
# layer3 and layer4 keep stride 1 and double the dilation per replaced
# stride, the first block of a dilated layer taking the previous dilation
# (torchvision's _make_layer(dilate=True))
_SPECS = ((64, 3, 1, 1, 1), (128, 4, 2, 1, 1), (256, 6, 1, 1, 2), (512, 3, 1, 2, 4))


class ResNet34Trunk8s(nn.Module):
    """ResNet-34 at output stride 8: [B, 3, H, W] -> [B, 512, H/8, W/8]."""

    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.conv1 = _conv(in_channels, 64, 7, 2)
        self.bn1 = RunningBatchNorm(64)
        self.block_names = []
        ch = 64
        for s, (features, n, stride, dil0, dil) in enumerate(_SPECS):
            for b in range(n):
                name = f"layer{s + 1}_{b}"
                self.add_module(name, BasicBlock(ch, features, stride if b == 0 else 1,
                                                 dil0 if b == 0 else dil))
                self.block_names.append(name)
                ch = features

    def forward(self, x):
        x = max_pool_same(F.relu(self.bn1(self.conv1(x))), 3, 2)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return x


class UCNBranch(nn.Module):
    """One Resnet34_8s branch: the trunk and a 1x1 embedding conv."""

    def __init__(self, embed_dim: int = 64):
        super().__init__()
        self.trunk = ResNet34Trunk8s()
        self.fc = _conv(512, embed_dim, 1, bias=True)

    def forward(self, x):
        return self.fc(self.trunk(x))


class UCNEmbeddingNet(nn.Module):
    """forward(rgb [B, 3, H, W], xyz [B, 3, H, W]) -> unit-norm embeddings
    [B, embed_dim, H, W]: the two branches' stride-8 embeddings added
    ("rgbd_add"), upsampled x8 and normalised. H and W are multiples of 8."""

    def __init__(self, embed_dim: int = 64):
        super().__init__()
        self.rgb_branch = UCNBranch(embed_dim)
        self.depth_branch = UCNBranch(embed_dim)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random init from `generator` after flax's defaults: LeCun-normal
        kernels, zero biases, identity BatchNorm."""
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                std = 1.0 / math.sqrt(mod.weight[0].numel())
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=generator) * std)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, RunningBatchNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)

    def forward(self, rgb, xyz):
        emb = self.rgb_branch(rgb) + self.depth_branch(xyz)
        return l2_normalize(upsample_bilinear(emb.float(), scale=8), dim=1)


def prototype_metric_loss(embeddings, labels, max_instances: int = 32,
                          margin_intra: float = 0.02, margin_inter: float = 0.5):
    """Cosine metric loss: pixels pulled to their instance's prototype,
    prototypes pushed apart. embeddings [B, D, H, W] unit-norm; labels
    [B, H, W] int in 0..max_instances-1 (background, 0, is a cluster of its
    own). Returns (loss, {"loss_intra", "loss_inter"})."""
    b = embeddings.shape[0]
    x = embeddings.flatten(2).transpose(1, 2)  # [B, N, D]
    onehot = F.one_hot(labels.reshape(b, -1).long(), max_instances).to(x.dtype)  # [B, N, K]
    counts = onehot.sum(dim=1)  # [B, K]
    protos = torch.einsum("bnk,bnd->bkd", onehot, x) / counts.clamp_min(1.0)[..., None]
    protos = l2_normalize(protos)
    valid_k = counts > 0

    # intra: 1 - cos(x, its prototype), hinged
    own = (torch.einsum("bnd,bkd->bnk", x, protos) * onehot).sum(dim=-1)
    intra = (1.0 - own - margin_intra).clamp_min(0.0).mean()

    # inter: hinge on the similarity of two prototypes
    psim = torch.einsum("bkd,bjd->bkj", protos, protos)
    eye = torch.eye(max_instances, dtype=torch.bool, device=x.device)[None]
    pair_valid = valid_k[:, :, None] & valid_k[:, None, :] & ~eye
    inter = ((psim - margin_inter).clamp_min(0.0) * pair_valid).sum() \
        / pair_valid.sum().clamp_min(1)
    return intra + inter, {"loss_intra": intra, "loss_inter": inter}


# the OSD intrinsics the wrapper reads every frame with
OSD_CAMERA = {"fx": 550.0, "fy": 550.0, "x_offset": 320.0, "y_offset": 240.0,
              "img_width": 640, "img_height": 480}


def read_rgb_xyz(rgb_path: str, depth_path: str, size=(480, 640)):
    """A frame as the reference's UCN and MSMFormer wrappers read it: the
    colour PNG in BGR order (cv2.imread), bilinear-resized to `size` and
    flipped to RGB before standardisation; depth in millimetres (a .npy in
    metres), nearest-resized, then a point cloud with the OSD intrinsics
    centred on the image. Returns (RGB [H, W, 3], XYZ [H, W, 3]) float32."""
    from quber_tpu_torch.data import png
    from quber_tpu_torch.ops.preprocess import (
        compute_xyz, resize_linear, resize_nearest, standardize_image)

    h, w = size
    rgb = resize_linear(png.imread(rgb_path, bgr=True), size)
    rgb_in = standardize_image(rgb[..., ::-1])
    if depth_path and depth_path.endswith(".npy"):
        depth_m = np.load(depth_path)
    elif depth_path:
        depth_m = png.imread(depth_path).astype(np.float32) / 1000.0
    else:
        depth_m = np.zeros(size, np.float32)
    camera = dict(OSD_CAMERA, x_offset=w / 2.0, y_offset=h / 2.0, img_width=w, img_height=h)
    return rgb_in, compute_xyz(resize_nearest(depth_m, size), camera)


class UCNBaseModel:
    """Evaluation wrapper: predict(rgb_path, depth_path) -> (masks [N, 480,
    640] bool, None, seconds).

    The frame is read as the reference reads it: the colour PNG in BGR
    order (cv2.imread), bilinear-resized to 640x480 and flipped to RGB
    before standardisation; depth in millimetres (a .npy in metres),
    nearest-resized, then a point cloud with the OSD intrinsics, whatever
    the `dataset` (as the reference reads every dataset). `params` is a
    state dict or a flax-layout tree (from_jax); without it the net is
    initialised from `seed`. The seconds count the device work (embedding,
    clustering, zoom-in) and the copy of the labels to the host."""

    ZOOM = 224
    MAX_INST = 16
    NUM_SEEDS = 32
    BANDWIDTH = 0.5
    H, W = 480, 640

    def __init__(self, params=None, dataset: str = "OSD", zoom_in: bool = False, seed: int = 0,
                 device="cuda"):
        from quber_tpu_torch.models.from_jax import as_state_dict

        self.device = torch.device(device)
        if self.device.type == "cuda":
            # float32 products, as the reference's: mean-shift decides by thresholds
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        model = UCNEmbeddingNet()
        if params is None:
            model.reset_parameters(torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(as_state_dict(params), strict=True)
        self.model = model.to(self.device).eval()
        self.zoom_in = zoom_in

    def _refine_crops(self, rgb, xyz, labels, boxes, valid, ids):
        """The zoom-in stage for every slot: [M, ZOOM, ZOOM] float32, each
        slot's largest refined component in its crop (0 for an empty slot)."""
        from quber_tpu_torch.ops.boxes import roi_align

        z = self.ZOOM
        emb = self.model(roi_align(rgb, boxes, out_size=z), roi_align(xyz, boxes, out_size=z))
        crops = []
        for i in range(len(ids)):
            lab = roi_align((labels == ids[i]).float()[None], boxes[i:i + 1], out_size=z)[0, 0]
            ref = cluster_embeddings(emb[i].permute(1, 2, 0), fg_mask=(lab > 0.5).float(),
                                     num_seeds=8, bandwidth=self.BANDWIDTH, min_pixels=64)
            counts = label_counts(ref["labels"].long(), 9)
            counts[0] = 0
            main = torch.argmax(counts)
            crops.append(((ref["labels"] == main) & (main > 0) & valid[i]).float())
        return torch.stack(crops)

    @torch.inference_mode()
    def segment(self, rgb: torch.Tensor, xyz: torch.Tensor):
        """Standardised RGB [3, H, W] and XYZ [3, H, W] on the model's device
        -> (labels [H, W] int32, instance count 0-d int32), on the device."""
        emb = self.model(rgb[None], xyz[None])[0].permute(1, 2, 0)
        out = cluster_embeddings(emb, num_seeds=self.NUM_SEEDS, bandwidth=self.BANDWIDTH)
        if not self.zoom_in:
            return out["labels"], out["num_instances"]
        from quber_tpu_torch.ops.zoom import zoom_refine_labels

        labels = out["labels"]
        full = zoom_refine_labels(
            labels, lambda boxes, valid, ids: self._refine_crops(rgb, xyz, labels, boxes,
                                                                valid, ids),
            self.MAX_INST, self.ZOOM)
        return full, out["num_instances"]

    def read_frame(self, rgb_path: str, depth_path: str):
        """(standardised RGB [H, W, 3] float32, XYZ [H, W, 3] float32)."""
        return read_rgb_xyz(rgb_path, depth_path, (self.H, self.W))

    def predict(self, rgb_path, depth_path):
        rgb_in, xyz = self.read_frame(rgb_path, depth_path)
        t0 = time.time()
        rgb_t = torch.from_numpy(np.ascontiguousarray(rgb_in.transpose(2, 0, 1))).to(self.device)
        xyz_t = torch.from_numpy(np.ascontiguousarray(xyz.transpose(2, 0, 1))).to(self.device)
        labels, n = self.segment(rgb_t, xyz_t)
        labels, n = labels.cpu().numpy(), int(n)
        elapsed = time.time() - t0
        masks = labels[None] == np.arange(1, n + 1)[:, None, None]
        return masks, None, elapsed

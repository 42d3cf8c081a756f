"""UOIS-Net-3D base segmenter: a Depth Seeding Network over the point cloud,
Euclidean mean-shift of its centre votes, and a Region Refinement Network
over each instance (torch, NCHW).

Port of quber_tpu/models/uois_net.py:
  * DSN: a U-Net over the organised XYZ cloud giving 2 foreground logits and
    3D centre-offset votes;
  * the wrapper: the argmax foreground, votes xyz + offsets clustered by
    ops/meanshift.cluster_points_euclidean, each instance opened then closed
    (3x3, one iteration), the RRN over RGB + each closed mask at full frame,
    and a pixel kept where sigmoid > 0.5 inside the closed mask;
  * the training losses of the reference's DSN and RRN trainers, in the
    reference's layouts (channels last: fg logits [H, W, 2], offsets and
    votes [H, W, 3]).

Modules carry the flax scope names, so models/from_jax carries a flax tree
across by renaming. With dtype bfloat16 the convolutions compute in
bfloat16; the GroupNorms, the upsamples and the head's output are float32,
as the reference's. The random draws of the cluster loss are arguments
(`draw_cluster_indices` makes them from a torch.Generator).
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from quber_tpu_torch.models.layers import (
    Conv2d, ConvNorm, reset_lecun, set_compute_dtype, upsample_bilinear)
from quber_tpu_torch.ops import morphology
from quber_tpu_torch.ops.meanshift import cluster_points_euclidean


class UNet(nn.Module):
    """Small encoder-decoder with skip connections: `levels` pairs of 3x3
    ConvNorm (GN) + ReLU with 2x2 max pools, a bottleneck, bilinear
    upsampling with skip concatenation, and a 1x1 head with a bias."""

    def __init__(self, in_channels: int, out_channels: int, base: int = 32, levels: int = 4,
                 norm: str = "GN"):
        super().__init__()
        self.levels = levels
        c = in_channels
        for i in range(levels):
            ch = base * 2 ** i
            self.add_module(f"down_{i}_a", ConvNorm(c, ch, 3, norm=norm, act=F.relu))
            self.add_module(f"down_{i}_b", ConvNorm(ch, ch, 3, norm=norm, act=F.relu))
            c = ch
        self.bottleneck = ConvNorm(c, base * 2 ** levels, 3, norm=norm, act=F.relu)
        c = base * 2 ** levels
        for i in reversed(range(levels)):
            ch = base * 2 ** i
            self.add_module(f"up_{i}", ConvNorm(c + ch, ch, 3, norm=norm, act=F.relu))
            c = ch
        self.head = Conv2d(c, out_channels, 1)

    def forward(self, x):
        d = self.head.compute_dtype
        skips = []
        y = x.to(d)
        for i in range(self.levels):
            y = getattr(self, f"down_{i}_b")(getattr(self, f"down_{i}_a")(y))
            skips.append(y)
            y = F.max_pool2d(y, 2)
        y = self.bottleneck(y)
        for i in reversed(range(self.levels)):
            # the reference rounds the upsample to the compute type, then
            # its concatenation with the float32 skip promotes it back
            y = upsample_bilinear(y.float(), size=skips[i].shape[2:]).to(d)
            y = torch.cat([y.float(), skips[i].float()], dim=1)
            y = getattr(self, f"up_{i}")(y)
        return self.head(y).float()


class DepthSeedingNetwork(nn.Module):
    """XYZ [B, 3, H, W] -> (fg logits [B, 2, H, W], offsets [B, 3, H, W])."""

    def __init__(self, dtype: torch.dtype = torch.float32, norm: str = "GN"):
        super().__init__()
        self.unet = UNet(3, 5, norm=norm)
        set_compute_dtype(self, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_lecun(self, generator)

    def forward(self, xyz):
        out = self.unet(xyz)
        return out[:, :2], out[:, 2:]


class RegionRefinementNetwork(nn.Module):
    """RGB + mask [B, 4, H, W] -> refined mask logit [B, 1, H, W]."""

    def __init__(self, dtype: torch.dtype = torch.float32, norm: str = "GN"):
        super().__init__()
        self.unet = UNet(4, 1, norm=norm)
        set_compute_dtype(self, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_lecun(self, generator)

    def forward(self, x):
        return self.unet(x)


def open_close(onehot: torch.Tensor, iterations: int) -> torch.Tensor:
    """The initial mask processing of each instance slot [M, H, W] float:
    an opening, then a closing, `iterations` 3x3 steps each."""
    opened = morphology.dilate(morphology.erode(onehot, iterations), iterations)
    return morphology.erode(morphology.dilate(opened, iterations), iterations)


class UOISNet3DBaseModel:
    """Evaluation wrapper: predict(rgb_path, depth_path) -> (masks [n, 480,
    640] bool, None, seconds).

    The frame is read as the reference's UOIS-Net-3D wrapper reads it (the
    colour PNG in BGR order, bilinear-resized and flipped to RGB before
    standardisation; depth nearest-resized, a point cloud with the OSD
    intrinsics). DSN and RRN run in bfloat16, as the reference's wrapper
    runs them. The RRN runs only on the slots whose closed mask holds a
    pixel: an empty slot's refined mask is empty whatever its logits. The
    seconds count the device work and the copy of the masks to the host."""

    MAX_INSTANCES = 32
    RRN_CHUNK = 8  # slots refined in one batch
    H, W = 480, 640

    def __init__(self, dsn_params=None, rrn_params=None, dataset: str = "OSD", seed: int = 0,
                 device="cuda"):
        from quber_tpu_torch.models.from_jax import as_state_dict

        self.device = torch.device(device)
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False

        def make(cls, params, s):
            model = cls(dtype=torch.bfloat16)
            if params is None:
                model.reset_parameters(torch.Generator().manual_seed(s))
            else:
                model.load_state_dict(as_state_dict(params), strict=True)
            return model.to(self.device).eval()

        self.dsn = make(DepthSeedingNetwork, dsn_params, seed)
        self.rrn = make(RegionRefinementNetwork, rrn_params, seed + 1)
        self.dataset = dataset

    @torch.inference_mode()
    def segment(self, rgb: torch.Tensor, xyz: torch.Tensor):
        """Standardised RGB [3, H, W] and XYZ [3, H, W] on the device ->
        (refined masks [MAX_INSTANCES, H, W] bool, instance count 0-d int32)."""
        fg_logits, offsets = self.dsn(xyz[None])
        fg = torch.argmax(fg_logits[0], dim=0).float()
        votes = (xyz + offsets[0]).permute(1, 2, 0)
        clustered = cluster_points_euclidean(votes, fg)
        labels = clustered["labels"]
        ids = torch.arange(1, self.MAX_INSTANCES + 1, device=labels.device)
        closed = open_close((labels[None] == ids[:, None, None]).float(), 1)
        refined = torch.zeros(closed.shape, dtype=torch.bool, device=closed.device)
        slots = torch.nonzero(closed.flatten(1).amax(dim=1) > 0).flatten().tolist()
        for start in range(0, len(slots), self.RRN_CHUNK):
            idx = slots[start:start + self.RRN_CHUNK]
            masks = closed[idx]
            inp = torch.cat([rgb[None].expand(len(idx), -1, -1, -1), masks[:, None]], dim=1)
            logits = self.rrn(inp)[:, 0]
            refined[idx] = (torch.sigmoid(logits) > 0.5) & (masks > 0)
        return refined, clustered["num_instances"]

    def predict(self, rgb_path, depth_path):
        from quber_tpu_torch.models.ucn import read_rgb_xyz

        rgb_in, xyz = read_rgb_xyz(rgb_path, depth_path, (self.H, self.W))
        t0 = time.time()
        rgb_t = torch.from_numpy(np.ascontiguousarray(rgb_in.transpose(2, 0, 1))).to(self.device)
        xyz_t = torch.from_numpy(np.ascontiguousarray(xyz.transpose(2, 0, 1))).to(self.device)
        refined, n = self.segment(rgb_t, xyz_t)
        n = int(n)
        refined = refined[:n].cpu().numpy()
        return refined, None, time.time() - t0


# ---------------------------------------------------------------------------
# Training losses (the reference's DSN and RRN trainers), one frame each,
# channels last
# ---------------------------------------------------------------------------


def _one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """jax.nn.one_hot: an out-of-range label gives a row of zeros."""
    return (labels[..., None] == torch.arange(num_classes, device=labels.device)).float()


def dsn_losses(fg_logits, offsets, fg_target, offset_target, fg_weight=1.0,
               offset_weight=1.0):
    """CE on the foreground + smooth-L1 on the offset votes over the
    foreground: {"loss_fg", "loss_offset"}."""
    logp = F.log_softmax(fg_logits, dim=-1)
    fg_loss = -logp.gather(-1, fg_target.long()[..., None])[..., 0].mean()
    diff = offsets - offset_target
    l1 = torch.where(diff.abs() < 1.0, 0.5 * diff ** 2, diff.abs() - 0.5)
    m = (fg_target > 0).float()[..., None]
    off_loss = (l1 * m).sum() / (m.sum() * 3).clamp_min(1.0)
    return {"loss_fg": fg_weight * fg_loss, "loss_offset": offset_weight * off_loss}


def inverse_frequency_weights(labels, num_classes: int, ignore=(), image_axes=(-2, -1)):
    """Per element 1 / (pixels of its class within its image); the classes
    in `ignore` weigh 0. `image_axes` are the per-image axes of `labels`."""
    onehot = _one_hot(labels, num_classes)
    axes = tuple(a - 1 for a in image_axes)  # past the class axis
    counts = onehot.sum(dim=axes, keepdim=True)
    inv = torch.where(counts > 0, 1.0 / counts.clamp_min(1.0), 0.0)
    w = (onehot * inv).sum(dim=-1)
    for c in ignore:
        w = torch.where(labels == c, 0.0, w)
    return w


def _weighted_ce(logits, target, weights):
    logp = F.log_softmax(logits, dim=-1)
    ce = -logp.gather(-1, target.long()[..., None])[..., 0]
    return (ce * weights).sum() / weights.sum().clamp_min(1e-12)


def dsn_foreground_loss(fg_logits, fg_target):
    """Class-balanced CE on the foreground logits [H, W, C]."""
    return _weighted_ce(fg_logits, fg_target, inverse_frequency_weights(fg_target,
                                                                        fg_logits.shape[-1]))


def dsn_offset_loss(offsets, offset_target, instance_labels, num_classes: int):
    """Smooth-L1 on the centre-offset votes, weighted by the inverse pixel
    count of each pixel's instance."""
    diff = offsets - offset_target
    l1 = torch.where(diff.abs() < 1.0, 0.5 * diff ** 2, diff.abs() - 0.5).sum(dim=-1)
    w = inverse_frequency_weights(instance_labels, num_classes)
    return (l1 * w).sum() / w.sum().clamp_min(1e-12)


def dsn_separation_loss(votes, gt_centers, centers_valid, instance_labels, tau: float = 15.0,
                        object_label: int = 2):
    """CE pulling each foreground pixel's vote to its own object centre:
    logits -tau * ||vote - centre_k|| over the K centres (invalid ones at
    -1e9), the target the compact object index."""
    k = gt_centers.shape[0]
    d = torch.linalg.vector_norm(votes[..., None, :] - gt_centers, dim=-1)
    logits = torch.where(centers_valid, -tau * d, -1e9)
    m_gt = (instance_labels - object_label).clamp(0, k - 1)
    w = inverse_frequency_weights(instance_labels, k + object_label,
                                  ignore=tuple(range(object_label)))
    return _weighted_ce(logits, m_gt, w)


def _gaussian_mean_shift_iter(seeds, points, sigma: float):
    """One Gaussian blurring mean-shift step: the seeds move to the kernel-
    weighted mean of the points."""
    d2 = ((seeds[:, None, :] - points[None, :, :]) ** 2).sum(dim=-1)
    w = torch.exp(-d2 / (2.0 * sigma ** 2))
    return (w @ points) / w.sum(dim=1, keepdim=True).clamp_min(1e-12)


def _cluster_pair_loss(x1, y1, w1, x2, y2, w2, delta: float):
    """Same-label pairs pulled together (d^2), other pairs pushed past
    `delta` (hinge^2), each weighted by the product of inverse label
    frequencies."""
    ind = (y1[:, None] == y2[None, :]).float()
    dist = torch.sqrt(((x1[:, None, :] - x2[None, :, :]) ** 2).sum(dim=-1).clamp_min(1e-12))
    pos = ind * dist ** 2
    neg = (1.0 - ind) * (delta - dist).clamp_min(0.0) ** 2
    return (w1[:, None] * w2[None, :] * (pos + neg)).sum()


def draw_cluster_indices(instance_labels, generator: torch.Generator, *, object_label: int = 2,
                         num_samples: int = 256, num_seeds: int = 32):
    """The cluster loss's draws: `num_samples` pixel indices with
    probability proportional to the foreground (uniform when there is
    none), with replacement, and `num_seeds` indices into those samples,
    uniform. Drawn on the generator's device."""
    fg = (instance_labels.reshape(-1) >= object_label).float()
    dev = generator.device
    p = fg if bool(fg.sum() > 0) else torch.ones_like(fg)
    samples = torch.multinomial(p.to(dev), num_samples, replacement=True, generator=generator)
    seeds = torch.randint(0, num_samples, (num_seeds,), generator=generator, device=dev)
    return samples.to(instance_labels.device), seeds.to(instance_labels.device)


def dsn_cluster_loss(votes, instance_labels, sample_idx, seed_idx, *, num_classes: int,
                     object_label: int = 2, sigma: float = 0.02, delta: float = 0.1,
                     iters: int = 5):
    """Mean-shift cluster loss: the votes at `sample_idx` (foreground pixels
    of the flattened frame) and seeds at `seed_idx` (indices into those
    samples) climb the votes' kernel density for `iters` steps; after each
    step the pair loss between seeds and samples. 0 on a frame without
    foreground."""
    flat_votes = votes.reshape(-1, votes.shape[-1])
    flat_labels = instance_labels.reshape(-1)
    total = (flat_labels >= object_label).sum()
    x_fg, y_fg = flat_votes[sample_idx], flat_labels[sample_idx]
    x_i, y_i = x_fg[seed_idx], y_fg[seed_idx]
    w_fg = inverse_frequency_weights(y_fg, num_classes + object_label, image_axes=(-1,))
    w_i = inverse_frequency_weights(y_i, num_classes + object_label, image_axes=(-1,))
    losses = []
    for _ in range(iters):
        x_i = _gaussian_mean_shift_iter(x_i, x_fg, sigma)
        losses.append(_cluster_pair_loss(x_i, y_i, w_i, x_fg, y_fg, w_fg, delta))
    return torch.where(total > 0, torch.stack(losses).sum() / iters, 0.0)


def dsn_train_losses(fg_logits, offsets, xyz, offset_target, instance_labels, gt_centers,
                     centers_valid, sample_idx, seed_idx, *, object_label: int = 2,
                     tau: float = 15.0, sigma: float = 0.02, delta: float = 0.1,
                     gms_iters: int = 5, lambda_fg: float = 3.0, lambda_co: float = 5.0,
                     lambda_sep: float = 1.0, lambda_cl: float = 1.0):
    """The DSN trainer's objective for one frame (channels last): weighted
    foreground CE, weighted offset smooth-L1, separation CE and the
    mean-shift cluster loss on votes xyz + offsets."""
    votes = xyz + offsets
    k = gt_centers.shape[0]
    return {
        "loss_fg": lambda_fg * dsn_foreground_loss(
            fg_logits, instance_labels.clamp(0, fg_logits.shape[-1] - 1)),
        "loss_offset": lambda_co * dsn_offset_loss(offsets, offset_target, instance_labels,
                                                   k + object_label),
        "loss_separation": lambda_sep * dsn_separation_loss(
            votes, gt_centers, centers_valid, instance_labels, tau=tau,
            object_label=object_label),
        "loss_cluster": lambda_cl * dsn_cluster_loss(
            votes, instance_labels, sample_idx, seed_idx, num_classes=k,
            object_label=object_label, sigma=sigma, delta=delta, iters=gms_iters),
    }


def rrn_loss(logits, target):
    """The RRN trainer's objective: BCE with logits, weighted by the inverse
    per-image class frequency."""
    bce = logits.clamp_min(0) - logits * target + torch.log1p(torch.exp(-logits.abs()))
    w = inverse_frequency_weights(target.long(), 2)
    return (bce * w).sum() / w.sum().clamp_min(1e-12)

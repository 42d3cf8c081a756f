"""Device-side training-target generation.

Port of quber_tpu/train/device_targets.py: the host only packs
    [rgb + depth u8 image | bitpacked GT masks | bitpacked perturbed masks |
     validity bits]
(one uint8 buffer per sample) and the device rebuilds every target of a
batch inside the train step: the Gaussian centre heatmap and offsets
(ops.encoding.panoptic_train_targets), the encoding of the perturbed input
masks and the eight TP/TN/FP/FN error maps (ops.morphology). On a CUDA
batch the areas and centroids of both stacks and the input encoding go
through the hand kernels (ops.kernels), one batched launch each. Data
parallel (a parallel.mesh.Mesh): each rank unpacks and builds the targets
of its own slice of the global batch, then takes train.loop's global step;
DevicePool gives every rank its slice of the same shuffled global batch.
"""

from __future__ import annotations

import numpy as np
import torch

from quber_tpu_torch.models.mask_refiner import MaskRefinerConfig, assemble_eee_targets
from quber_tpu_torch.ops import kernels
from quber_tpu_torch.ops.encoding import panoptic_train_targets
from quber_tpu_torch.ops.morphology import quadruple_error_maps
from quber_tpu_torch.parallel.mesh import Mesh, shard_batch
from quber_tpu_torch.train.loop import TrainState, apply_step


def sample_bytes(h: int, w: int, n_slots: int) -> int:
    return h * w * 4 + 2 * n_slots * (h * w // 8) + 2 * ((n_slots + 7) // 8)


def pack_train_sample(rgb, depth, gt_masks, pert_masks, n_slots: int) -> np.ndarray:
    """Host-side packing: rgb [H, W, 3] u8-ish, depth [H, W] or [H, W, 3]
    normalised to 0-255, GT and perturbed mask stacks (any count; truncated
    to n_slots). H * W must divide by 8."""
    h, w = np.asarray(rgb).shape[:2]
    if (h * w) % 8:
        raise ValueError(f"H * W must divide by 8 to bitpack the masks, got {h}x{w}")
    row = h * w // 8
    buf = np.zeros((sample_bytes(h, w, n_slots),), np.uint8)
    img = buf[: h * w * 4].reshape(h, w, 4)
    img[..., :3] = np.clip(np.round(np.asarray(rgb, np.float32)), 0, 255)
    d = np.asarray(depth)
    if d.ndim == 3:
        d = d[..., 0]
    img[..., 3] = np.clip(np.round(d.astype(np.float32)), 0, 255)
    off = h * w * 4
    for stack in (gt_masks, pert_masks):
        count = min(len(stack), n_slots)
        if count:
            used = np.asarray(stack[:count]) > 0
            buf[off: off + count * row] = np.packbits(used.reshape(count, -1), axis=1).reshape(-1)
        off += n_slots * row
    vb = (n_slots + 7) // 8
    for stack in (gt_masks, pert_masks):
        valid = np.zeros((n_slots,), bool)
        valid[: min(len(stack), n_slots)] = True
        buf[off: off + vb] = np.packbits(valid)
        off += vb
    return buf


def _unpack_bits(packed: torch.Tensor, n_bits: int) -> torch.Tensor:
    """uint8 [..., K] -> bool [..., n_bits], most significant bit first (the
    order of np.packbits)."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8)[..., :n_bits] > 0


def unpack_train_sample(bufs: torch.Tensor, h: int, w: int, n_slots: int):
    """Device inverse of pack_train_sample for a batch [B, sample_bytes] u8
    (or one sample) -> (image [B, 6, H, W] f32, gt [B, N, H, W] bool, gv
    [B, N] bool, pert [B, N, H, W] bool, pv [B, N] bool)."""
    if bufs.dim() == 1:
        return tuple(t[0] for t in unpack_train_sample(bufs[None], h, w, n_slots))
    if (h * w) % 8:
        raise ValueError(f"H * W must divide by 8, got {h}x{w}")
    if bufs.shape[1] != sample_bytes(h, w, n_slots):
        raise ValueError(f"expected {sample_bytes(h, w, n_slots)} bytes a sample, "
                         f"got {bufs.shape[1]}")
    b = bufs.shape[0]
    row = h * w // 8
    img4 = bufs[:, : h * w * 4].reshape(b, h, w, 4).permute(0, 3, 1, 2).float()
    image = torch.cat([img4[:, :3], img4[:, 3:4].expand(b, 3, h, w)], dim=1)
    off = h * w * 4
    stacks = []
    for _ in range(2):
        packed = bufs[:, off: off + n_slots * row].reshape(b, n_slots, row)
        stacks.append(_unpack_bits(packed, h * w).reshape(b, n_slots, h, w))
        off += n_slots * row
    vb = (n_slots + 7) // 8
    gv = _unpack_bits(bufs[:, off: off + vb], n_slots)
    pv = _unpack_bits(bufs[:, off + vb:], n_slots)
    return image, stacks[0], gv, stacks[1], pv


@torch.no_grad()
def build_targets(gt, gv, pert, pv, model_cfg: MaskRefinerConfig, train_cfg) -> dict:
    """Targets of a batch, with the fields of compute_losses and channels
    first: gt / pert [B, N, H, W] bool with validity gv / pv [B, N] ->
    offset_enc [B, 3, H, W], sem_seg, sem_seg_weights, center,
    center_weights, offset_weights [B, H, W], offset [B, 2, H, W], eee_mask,
    eee_boundary [B, C, H, W]. On CUDA tensors the statistics of both stacks
    and the input encoding are one launch each of the hand kernels."""
    sigma = train_cfg.gaussian_sigma
    areas, centers = kernels.instance_stats(gt, gv)
    pd = panoptic_train_targets(
        gt, gv, sigma=sigma, small_instance_area=train_cfg.small_instance_area,
        small_instance_weight=train_cfg.small_instance_weight, stats=(areas, centers))
    _, pert_centers, pert_ok = kernels.instance_stats(pert, pv, return_ok=True)
    enc = kernels.encode_initial_masks_batched(pert, pert_ok, pert_centers, sigma,
                                               normalize=True)
    em = quadruple_error_maps(gt, pert, gv, pv)
    et = model_cfg.error_type
    loss_region = pd["sem_seg"]
    return {
        "offset_enc": enc,
        "sem_seg": pd["sem_seg"],
        "sem_seg_weights": pd["sem_seg_weights"],
        "center": pd["center"],
        "center_weights": loss_region,
        "offset": pd["offset"],
        "offset_weights": loss_region,
        "eee_mask": assemble_eee_targets(*em["mask"].unbind(dim=-3), et),
        "eee_boundary": assemble_eee_targets(*em["boundary"].unbind(dim=-3), et),
    }


def make_device_target_step(model_cfg: MaskRefinerConfig, train_cfg, n_slots: int = 32,
                            mesh: Mesh | None = None):
    """train_step(state, bufs, mark=None) -> (state, metrics) over PACKED
    samples: bufs u8 [B, sample_bytes] on the state's device (this rank's
    slice under a data-parallel `mesh`, the state's). The same contract as
    train.loop.make_train_step; every target is rebuilt on the device
    (`mark("targets")` is called once they are)."""
    h, w = model_cfg.height, model_cfg.width

    def train_step(state: TrainState, bufs: torch.Tensor, mark=None):
        image, gt, gv, pert, pv = unpack_train_sample(bufs, h, w, n_slots)
        batch = build_targets(gt, gv, pert, pv, model_cfg, train_cfg)
        batch["image"] = image
        del gt, pert
        if mark is not None:
            mark("targets")
        return state, apply_step(state, batch, model_cfg, mark, mesh)

    return train_step


class DevicePool:
    """Packed samples resident on the device: the samples are deterministic
    per record, so the whole pool is uploaded once and each batch is an
    index gather on the device, in a shuffled order that is redrawn every
    epoch. Under a data-parallel `mesh` `batch_size` is the global batch:
    every rank draws the same shuffled indices (the same RandomState(seed))
    and gathers its own contiguous slice of them, so one rank and W ranks
    train on the same samples."""

    def __init__(self, packed: np.ndarray, batch_size: int, seed: int, device,
                 mesh: Mesh | None = None):
        if mesh is not None and batch_size % mesh.world_size:
            raise ValueError(f"the global batch of {batch_size} does not divide over "
                             f"{mesh.world_size} ranks")
        self.pool = torch.from_numpy(np.ascontiguousarray(packed)).to(device)
        self.batch_size = batch_size
        self.mesh = mesh
        self._rng = np.random.RandomState(seed)
        self._order = np.arange(len(packed))
        self._pos = len(packed)  # forces an initial shuffle

    def next_batch(self) -> torch.Tensor:
        idx = np.empty(self.batch_size, np.int64)
        for i in range(self.batch_size):
            if self._pos >= len(self._order):
                self._rng.shuffle(self._order)
                self._pos = 0
            idx[i] = self._order[self._pos]
            self._pos += 1
        if self.mesh is not None:
            idx = shard_batch(idx, self.mesh)
        return self.pool[torch.from_numpy(idx).to(self.pool.device)]


class PackedMapper:
    """Light host mapper of the device-target path: decode and augment the
    images, bitpack both mask stacks, and leave every target to the device.

    Takes file-backed dataset records (PerturbedPanopticMapper's image
    pipeline at the model's fixed shape: SSD colour augmentation, Perlin
    depth distortion, mm-range depth normalisation, drawn from one
    RandomState in the reference's order) and the in-memory synthetic
    records of train_net_torch.py (no augmentation)."""

    def __init__(self, train_cfg, model_cfg, n_slots: int = 32, is_train=True, seed: int = 0):
        self.tc = train_cfg
        self.mc = model_cfg
        self.n_slots = n_slots
        self.is_train = is_train
        self.rng = np.random.RandomState(seed)

    def __call__(self, record: dict) -> dict:
        from quber_tpu_torch.data import rle
        from quber_tpu_torch.data.mappers import normalize_depth_mm, read_record

        if "rgb" in record:  # a synthetic in-memory record
            rgb = np.asarray(record["rgb"])
            depth_n = normalize_depth_mm(record["depth_mm"], self.tc.depth_range)
            gt_masks = np.asarray(record["gt_masks"])
            pert = np.asarray([rle.decode(r) for r in record["perturbed_segmentation"]])
        else:
            h, w = self.mc.height, self.mc.width
            rgb, depth_n, gt_masks, pert = read_record(record, lambda *_: (h, w), self.tc,
                                                       self.rng, augment=self.is_train)
        return {"packed": pack_train_sample(rgb, depth_n, gt_masks, pert, self.n_slots)}

"""Training input on the host: the perturbed-panoptic sample mapper, the
endless batch iterator, and the resize helpers of training and of the
multi-scale predictor.

Port of quber_tpu/data/mappers.py. `PerturbedPanopticMapper` reads a
dataset record's files (colour in BGR as cv2.imread gives it, 16-bit depth
in mm, the panoptic PNG), applies the SSD colour and Perlin depth
augmentations and copy-paste, resizes (fixed shape, or ResizeShortestEdge
to a padded bucket for multi-scale training), decodes the perturbed masks
and the stored error maps, and builds every target on the host in numpy,
drawing from one RandomState in the reference's order. Its samples are in
the reference's layout (channels last); `to_step_layout` turns a batch of
them into the channels-first tensors of train.loop.make_train_step.
`resize` takes the place of the
reference's `cv2.resize(img.astype(np.float32), (w, h), interpolation)`,
which the port cannot use (OpenCV is not a dependency): "linear" is
bilinear with half-pixel centres (align_corners=False, no antialiasing),
as cv2.INTER_LINEAR is, and "nearest" takes source index floor(dst * in /
out), as cv2.INTER_NEAREST does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from quber_tpu_torch.data import rle
from quber_tpu_torch.data.augmentation import copy_paste, ssd_color_aug
from quber_tpu_torch.data.datasets import EEE_KEYS, get_dataset, read_image, rgb2id
from quber_tpu_torch.data.eee import compute_eee_maps
from quber_tpu_torch.data.perlin import perlin_distortion
from quber_tpu_torch.ops.preprocess import resize_linear, resize_nearest

_MODES = {"linear": "bilinear", "nearest": "nearest"}


def normalize_depth_mm(depth_mm: np.ndarray, depth_range=(2500, 15000)) -> np.ndarray:
    """mm -> 0..255 replicated to 3 channels, under the training depth range."""
    lo, hi = depth_range
    d = np.clip(depth_mm.astype(np.float32), lo, hi)
    d = (d - lo) / (hi - lo) * 255.0
    return np.repeat(d[..., None], 3, axis=-1)


def batch_iterator(dataset_name_or_records, mapper, batch_size: int, shuffle=True, seed=0):
    """Endless iterator of stacked batches of mapper(record) dicts over a
    registered dataset name or a list of records; samples are grouped by the
    shapes of their arrays (a multi-scale mapper's buckets), so each batch
    stacks."""
    records = (get_dataset(dataset_name_or_records)
               if isinstance(dataset_name_or_records, str) else dataset_name_or_records)
    rng = np.random.RandomState(seed)
    order = np.arange(len(records))
    pending: dict = {}
    while True:
        if shuffle:
            rng.shuffle(order)
        for i in order:
            s = mapper(records[i])
            key = tuple((k, np.shape(v)) for k, v in sorted(s.items()))
            batch = pending.setdefault(key, [])
            batch.append(s)
            if len(batch) == batch_size:
                yield {k: np.stack([x[k] for x in batch]) for k in batch[0]}
                pending[key] = []


def numpy_center_offset(masks, h, w, sigma=10, normalize=False):
    """Host-side centre heatmap and offsets of a mask stack (ops.encoding's
    semantics): (center [h, w], offset [2, h, w], centres [(cy, cx) or
    None])."""
    size = 6 * sigma + 3
    x = np.arange(0, size, 1, float)
    y = x[:, None]
    g = np.exp(-((x - (3 * sigma + 1)) ** 2 + (y - (3 * sigma + 1)) ** 2) / (2 * sigma ** 2))
    center = np.zeros((h, w), np.float32)
    offset = np.zeros((2, h, w), np.float32)
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
                         indexing="ij")
    centers = []
    for mask in masks:
        idx = np.where(mask != 0)
        if len(idx[0]) == 0:
            centers.append(None)
            continue
        cy, cx = float(np.mean(idx[0])), float(np.mean(idx[1]))
        centers.append((cy, cx))
        ry, rx = int(round(cy)), int(round(cx))
        ul = rx - 3 * sigma - 1, ry - 3 * sigma - 1
        br = rx + 3 * sigma + 2, ry + 3 * sigma + 2
        gx0, gx1 = max(0, -ul[0]), min(br[0], w) - ul[0]
        gy0, gy1 = max(0, -ul[1]), min(br[1], h) - ul[1]
        cx0, cx1 = max(0, ul[0]), min(br[0], w)
        cy0, cy1 = max(0, ul[1]), min(br[1], h)
        center[cy0:cy1, cx0:cx1] = np.maximum(center[cy0:cy1, cx0:cx1], g[gy0:gy1, gx0:gx1])
        sy, sx = (h, w) if normalize else (1.0, 1.0)
        offset[0][idx] = (cy - yy[idx]) / sy
        offset[1][idx] = (cx - xx[idx]) / sx
    return center, offset, centers


def eee_channels(tp, tn, fp, fn, error_type: str) -> np.ndarray:
    """The four error maps [H, W] stacked into the error_type's channels,
    last: [H, W, C] (models.mask_refiner.assemble_eee_targets' layout on the
    host)."""
    chans = {"e3": [tp, tn, fp, fn], "e2": [tp + tn, fp + fn], "e33": [tp + tn, fp, fn],
             "e32": [fp, fn]}
    if error_type not in chans:
        raise ValueError(error_type)
    return np.stack(chans[error_type], axis=-1)


def read_record(record: dict, size, train_cfg, rng, augment: bool = True):
    """A file-backed record's images and masks at size(h0, w0) = (h, w), the
    colour and depth augmented when `augment` (and the config's switches)
    say so, drawing from `rng` in the reference's order: colour (BGR as
    cv2.imread reads it) resized bilinearly, then SSD colour; depth in mm,
    Perlin-distorted at its own size, then nearest-resized and normalised
    to 0..255 x 3; the GT masks of the panoptic PNG and the perturbed masks
    of the record's RLEs, nearest-resized. Returns (rgb uint8 [h, w, 3],
    depth float32 [h, w, 3], [gt uint8 [h, w]], [perturbed uint8 [h, w]])."""
    rgb = read_image(record["file_name"], bgr=True)
    h, w = size(*rgb.shape[:2])
    rgb = resize_linear(rgb, (h, w))
    if augment and train_cfg.color_aug_ssd:
        rgb = ssd_color_aug(rgb, rng)
    if "depth_file_name" in record:
        depth = np.asarray(read_image(record["depth_file_name"])).astype(np.float32)
        if augment and train_cfg.perlin_distortion:
            depth = perlin_distortion(depth, rng)
        depth = normalize_depth_mm(resize_nearest(depth, (h, w)), train_cfg.depth_range)
    else:
        depth = np.zeros((h, w, 3), np.float32)
    panoptic = rgb2id(read_image(record["pan_seg_file_name"]))
    panoptic = resize_nearest(panoptic.astype(np.float32), (h, w)).astype(np.int64)
    gt_masks = [(panoptic == seg["id"]).astype(np.uint8) for seg in record["segments_info"]]
    pert = [resize_nearest(rle.decode(r), (h, w))
            for r in record.get("perturbed_segmentation", [])]
    return rgb, depth, gt_masks, pert


class PerturbedPanopticMapper:
    """dataset record -> training sample dict (channels last).

    Fixed shape (the model's height x width) by default; with
    `multiscale=True` (or when train_cfg.min_size_train has several entries)
    ResizeShortestEdge to a shorter side drawn per sample, then zero padding
    to a size-divisible bucket whose margin carries zero loss weights."""

    def __init__(self, train_cfg, model_cfg, is_train: bool = True, seed: int = 0,
                 multiscale: bool | None = None):
        self.tc = train_cfg
        self.mc = model_cfg
        self.is_train = is_train
        self.rng = np.random.RandomState(seed)
        sizes = tuple(getattr(train_cfg, "min_size_train", ()) or ())
        if multiscale is None:
            multiscale = is_train and len(sizes) > 1
        self.multiscale = multiscale
        self.min_sizes = sizes or (model_cfg.height,)
        self.max_size = getattr(train_cfg, "max_size_train", model_cfg.width)
        self.divisor = getattr(train_cfg, "size_divisibility", 32)
        self._donor = None  # the previous sample: copy-paste's reservoir

    def _target_shape(self, h0: int, w0: int):
        """(resized h, resized w, padded h, padded w) of this sample."""
        if not self.multiscale:
            h, w = self.mc.height, self.mc.width
            return h, w, h, w
        short = int(self.min_sizes[self.rng.randint(len(self.min_sizes))])
        rh, rw = resize_shortest_edge(h0, w0, short, self.max_size)
        ph, pw = bucket_shape(rh, rw, self.divisor)
        return rh, rw, ph, pw

    def __call__(self, record: dict) -> dict:
        shape = []

        def size(h0, w0):
            shape.extend(self._target_shape(h0, w0))
            return shape[:2]

        rgb, depth, gt_masks, pert = read_record(record, size, self.tc, self.rng,
                                                 augment=self.is_train)
        h, w, ph, pw = shape
        use_stored_eee = all(k in record for k in EEE_KEYS)
        cp_prob = getattr(self.tc, "copy_paste_prob", 0.0)
        if self.is_train and cp_prob > 0:
            donor = self._donor
            if donor is not None and donor[0].shape[:2] == (h, w) and self.rng.rand() < cp_prob:
                rgb, depth, gt_masks, pert = copy_paste(
                    rgb, depth, gt_masks, donor[0], donor[1], donor[2], self.rng,
                    paired_masks=pert, donor_paired=donor[3])
                use_stored_eee = False  # the masks changed: derive the error maps
            self._donor = (rgb.copy(), depth.copy(), np.asarray(list(gt_masks), np.uint8),
                           np.asarray(list(pert), np.uint8))

        sem_seg = ((np.sum(gt_masks, axis=0) > 0).astype(np.float32) if len(gt_masks)
                   else np.zeros((h, w), np.float32))
        center, offset, _ = numpy_center_offset(gt_masks, h, w, self.tc.gaussian_sigma)
        sem_weights = np.ones((h, w), np.float32)
        for m in gt_masks:
            if m.sum() < self.tc.small_instance_area:
                sem_weights[m > 0] = self.tc.small_instance_weight
        p_center, p_offset, _ = numpy_center_offset(pert, h, w, self.tc.gaussian_sigma,
                                                    normalize=True)
        sample = {
            "image": np.concatenate([rgb.astype(np.float32), depth], axis=-1),
            "offset_enc": np.stack([p_center, p_offset[0], p_offset[1]], axis=-1)
            .astype(np.float32),
            "sem_seg": sem_seg,
            "sem_seg_weights": sem_weights,
            "center": center,
            "center_weights": sem_seg,
            "offset": np.stack([offset[0], offset[1]], axis=-1),
            "offset_weights": sem_seg,
        }
        if use_stored_eee:
            maps = {k: resize_nearest(rle.decode(record[k]).astype(np.float32), (h, w))
                    for k in EEE_KEYS}
        else:
            empty = np.zeros((0, h, w), np.uint8)
            maps = compute_eee_maps(np.asarray(gt_masks, np.uint8) if len(gt_masks) else empty,
                                    np.asarray(pert, np.uint8) if len(pert) else empty)
        et = self.mc.error_type
        for kind in ("mask", "boundary"):
            sample[f"eee_{kind}"] = eee_channels(*(maps[f"{n}_{kind}"] for n in
                                                   ("tp", "tn", "fp", "fn")), et)
        if (ph, pw) != (h, w):
            sample = {k: _pad_to(v, ph, pw) for k, v in sample.items()}
        return sample


def _pad_to(arr: np.ndarray, ph: int, pw: int) -> np.ndarray:
    """Zero-pad the two leading (spatial) axes up to (ph, pw): the loss
    weights are zero in the margin, so padded pixels carry no gradient."""
    pads = [(0, ph - arr.shape[0]), (0, pw - arr.shape[1])] + [(0, 0)] * (arr.ndim - 2)
    return np.pad(arr, pads)


# batch fields whose channels are the last axis in a mapper's sample
_CHANNEL_FIELDS = ("image", "offset_enc", "offset", "eee_mask", "eee_boundary")


def to_step_layout(batch: dict, device) -> dict:
    """A stacked batch of PerturbedPanopticMapper samples -> the tensors of
    train.loop.make_train_step on `device`, channels first."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if k in _CHANNEL_FIELDS:
            t = t.permute(0, 3, 1, 2)
        out[k] = t.to(device).contiguous()
    return out


def resize_shortest_edge(h0: int, w0: int, short: int, max_size: int):
    """detectron2 ResizeShortestEdge output size: scale so the shorter side
    hits `short`, capped so the longer side stays <= max_size."""
    scale = short / min(h0, w0)
    if max(h0, w0) * scale > max_size:
        scale = max_size / max(h0, w0)
    return int(h0 * scale + 0.5), int(w0 * scale + 0.5)


def bucket_shape(h: int, w: int, divisor: int = 32):
    """Pad a resized shape up to the next divisor multiple, so a finite set
    of input sizes maps onto a fixed set of padded shapes."""
    pad = lambda v: ((v + divisor - 1) // divisor) * divisor
    return pad(h), pad(w)


def resize(img, size: tuple[int, int], interp: str, device="cpu") -> np.ndarray:
    """img [H, W] or [H, W, C] -> float32 numpy [h, w] or [h, w, C] at
    size = (h, w), computed in float32 on `device`."""
    t = torch.as_tensor(np.asarray(img, np.float32), device=device)
    x = t[None, None] if t.ndim == 2 else t.permute(2, 0, 1)[None]
    mode = _MODES[interp]
    y = F.interpolate(x, size=tuple(size), mode=mode,
                      align_corners=False if mode == "bilinear" else None)
    y = y[0, 0] if t.ndim == 2 else y[0].permute(1, 2, 0)
    return y.cpu().numpy()

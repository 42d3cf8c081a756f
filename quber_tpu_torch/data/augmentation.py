"""Photometric and geometric training augmentations (numpy).

Port of quber_tpu/data/augmentation.py and of the SSD colour augmentation
of quber_tpu/data/mappers.py: each function draws from the caller's
RandomState in the reference's order, and the OpenCV calls are the port's
copies in ops/imgproc.py (cvtColor, GaussianBlur, getRotationMatrix2D +
warpAffine).
"""

from __future__ import annotations

import numpy as np

from quber_tpu_torch.ops.imgproc import (bgr2hls, bgr2hsv, gaussian_blur as _blur,
                                         hls2bgr, hsv2bgr, rotation_matrix, warp_affine)


def ssd_color_aug(rgb: np.ndarray, rng) -> np.ndarray:
    """SSD-style photometric distortion of a uint8 BGR image: brightness,
    contrast, saturation and hue, each with probability 0.5 (detectron2's
    ColorAugSSDTransform semantics)."""
    img = rgb.astype(np.float32)
    if rng.rand() < 0.5:  # brightness
        img += rng.uniform(-32, 32)
    if rng.rand() < 0.5:  # contrast
        img *= rng.uniform(0.5, 1.5)
    img = np.clip(img, 0, 255).astype(np.uint8)
    hsv = bgr2hsv(img).astype(np.float32)
    if rng.rand() < 0.5:  # saturation
        hsv[..., 1] *= rng.uniform(0.5, 1.5)
    if rng.rand() < 0.5:  # hue
        hsv[..., 0] = (hsv[..., 0] + rng.uniform(-18, 18)) % 180
    hsv = np.clip(hsv, 0, 255).astype(np.uint8)
    return hsv2bgr(hsv)


def chromatic_shift(rgb: np.ndarray, rng, d_h=0.1, d_s=0.2, d_l=0.2) -> np.ndarray:
    """Random hue / saturation / lightness shift of a uint8 BGR image."""
    hls = bgr2hls(rgb).astype(np.float32)
    hls[..., 0] = (hls[..., 0] + rng.uniform(-d_h, d_h) * 180) % 180
    hls[..., 1] = np.clip(hls[..., 1] * (1 + rng.uniform(-d_l, d_l)), 0, 255)
    hls[..., 2] = np.clip(hls[..., 2] * (1 + rng.uniform(-d_s, d_s)), 0, 255)
    return hls2bgr(hls.astype(np.uint8))


def gaussian_blur(rgb: np.ndarray, rng, max_sigma=1.8) -> np.ndarray:
    return _blur(rgb, 0, rng.uniform(0.3, max_sigma))


def add_gaussian_noise(rgb: np.ndarray, rng, max_std=12.0) -> np.ndarray:
    noise = rng.randn(*rgb.shape) * rng.uniform(2.0, max_std)
    return np.clip(rgb.astype(np.float32) + noise, 0, 255).astype(np.uint8)


def random_rotation(images: list, rng, max_deg=15.0, nearest: list | None = None):
    """Rotate aligned images by one random angle about the centre; `nearest`
    flags per image select nearest-neighbour sampling (labels, depth)."""
    angle = rng.uniform(-max_deg, max_deg)
    h, w = images[0].shape[:2]
    mat = rotation_matrix((w / 2, h / 2), angle, 1.0)
    return [warp_affine(img, mat, (w, h), nearest=bool(nearest and nearest[i]))
            for i, img in enumerate(images)]


def copy_paste(rgb: np.ndarray, depth: np.ndarray, masks: np.ndarray,
               donor_rgb: np.ndarray, donor_depth: np.ndarray, donor_masks: np.ndarray,
               rng, max_paste: int = 3, paired_masks=None, donor_paired=None):
    """Paste up to `max_paste` donor instances at random offsets; occluded
    pixels of existing masks are cleared. A paired stack (the mapper's
    perturbed masks) is kept aligned: each pasted instance also pastes the
    donor's paired pixels inside its region as a new paired mask, and
    occludes the existing ones. Returns (rgb, depth, masks[, paired])."""
    rgb = rgb.copy()
    depth = depth.copy()
    masks = [m.copy() for m in masks]
    paired = None if paired_masks is None else [p.copy() for p in paired_masks]
    h, w = rgb.shape[:2]
    n = min(max_paste, len(donor_masks))
    order = rng.permutation(len(donor_masks))[:n]
    for i in order:
        m = donor_masks[i].astype(bool)
        if not m.any():
            continue
        ys, xs = np.nonzero(m)
        dy = rng.randint(-ys.min(), h - 1 - ys.max()) if ys.max() < h - 1 else 0
        dx = rng.randint(-xs.min(), w - 1 - xs.max()) if xs.max() < w - 1 else 0
        shifted = np.zeros_like(m)
        shifted[ys + dy, xs + dx] = True
        rgb[shifted] = donor_rgb[m]
        depth[shifted] = donor_depth[m]
        for mm in masks:
            mm[shifted] = 0
        masks.append(shifted.astype(np.uint8))
        if paired is not None:
            for pp in paired:
                pp[shifted] = 0
            newp = np.zeros_like(m)
            for dp in (donor_paired if donor_paired is not None else ()):
                sel = dp.astype(bool) & m
                if sel.any():
                    sy, sx = np.nonzero(sel)
                    newp[sy + dy, sx + dx] = True
            if newp.any():
                paired.append(newp.astype(np.uint8))
    masks = [m for m in masks if m.sum() > 16]
    masks = np.asarray(masks) if masks else np.zeros((0, h, w), np.uint8)
    if paired is None:
        return rgb, depth, masks
    paired = [p for p in paired if p.sum() > 16]
    paired = np.asarray(paired) if paired else np.zeros((0, h, w), np.uint8)
    return rgb, depth, masks, paired

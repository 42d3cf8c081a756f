"""Mask perturbation: controlled error injection for refiner training data
(numpy + scipy.ndimage).

Port of the image-free flow of quber_tpu/data/perturb.py: a false-positive
blob, over- and under-segmentation, deletion, and boundary jitter toward a
target IoU, with the same draws from the same generator. The reference's
helpers call OpenCV; here the filled ellipse is analytic, the bicubic
resize is OpenCV's kernel (a = -0.75, half-pixel centres, replicated
border) written out as two matrix products, and erode / dilate / close are
scipy.ndimage rank filters with OpenCV's default borders (erosion does not
erode from the border of the array it is given, dilation sees background
outside). The flow seeded by Felzenszwalb proposals of the RGB image waits
for the file-backed data slice.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

DEFAULT_RATIOS = {
    "fp": 0.15,        # add a spurious instance
    "over": 0.10,      # over-segment: split one GT instance in two
    "under": 0.10,     # under-segment: merge two instances
    "delete": 0.05,    # drop an instance entirely
    "boundary": 1.0,   # boundary jitter applied to every surviving mask
}


def _cubic_weights(n_out: int, n_in: int) -> np.ndarray:
    """[n_out, n_in] matrix of OpenCV's INTER_CUBIC resize along one axis."""
    a = -0.75
    src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    base = np.floor(src).astype(int)
    t = src - base
    coeffs = np.stack([
        ((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a,
        ((a + 2) * t - (a + 3)) * t * t + 1,
        ((a + 2) * (1 - t) - (a + 3)) * (1 - t) * (1 - t) + 1,
    ], axis=1)
    coeffs = np.concatenate([coeffs, 1.0 - coeffs.sum(axis=1, keepdims=True)], axis=1)
    weights = np.zeros((n_out, n_in))
    rows = np.arange(n_out)
    for k in range(4):
        np.add.at(weights, (rows, np.clip(base - 1 + k, 0, n_in - 1)), coeffs[:, k])
    return weights


def resize_cubic(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bicubic resize of a 2-D array to (h, w), OpenCV's convention."""
    return _cubic_weights(h, img.shape[0]) @ img @ _cubic_weights(w, img.shape[1]).T


def erode3(mask: np.ndarray, iterations: int) -> np.ndarray:
    """`iterations` erosions with a 3x3 all-ones kernel; outside the array
    counts as foreground (OpenCV's default border for erosion)."""
    return ndimage.minimum_filter(mask, size=2 * iterations + 1, mode="constant", cval=1)


def dilate3(mask: np.ndarray, iterations: int) -> np.ndarray:
    """`iterations` dilations with a 3x3 all-ones kernel; outside the array
    counts as background."""
    return ndimage.maximum_filter(mask, size=2 * iterations + 1, mode="constant", cval=0)


def random_blob(rng, h, w, area_scale=0.02):
    """Random deformed-ellipse blob mask (a false-positive proposal)."""
    cy, cx = rng.randint(h // 8, 7 * h // 8), rng.randint(w // 8, 7 * w // 8)
    a = max(8, int(np.sqrt(area_scale * h * w) * rng.uniform(0.5, 1.5)))
    b = max(8, int(a * rng.uniform(0.4, 1.0)))
    theta = np.deg2rad(np.round(rng.uniform(0, 180)))  # OpenCV draws at whole degrees
    ys, xs = np.mgrid[:h, :w]
    dy, dx = ys - cy, xs - cx
    u = np.cos(theta) * dx + np.sin(theta) * dy
    v = -np.sin(theta) * dx + np.cos(theta) * dy
    # half a pixel wider: a polygon fill covers the pixels its outline touches
    mask = (u / (a + 0.5)) ** 2 + (v / (b + 0.5)) ** 2 <= 1.0
    # deform with coarse noise thresholding
    noise = resize_cubic(rng.rand(h // 16 + 1, w // 16 + 1), h, w)
    return (mask & (noise > 0.25)).astype(np.uint8)


def perturb_seg(mask: np.ndarray, rng, iterations=(1, 6)) -> np.ndarray:
    """Random local erode/dilate: pick a few random rectangular regions and
    erode or dilate the mask inside them."""
    out = mask.astype(np.uint8).copy()
    h, w = mask.shape
    for _ in range(rng.randint(1, 4)):
        it = rng.randint(*iterations)
        op = erode3 if rng.rand() < 0.5 else dilate3
        y0, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
        y1, x1 = rng.randint(y0 + h // 4, h), rng.randint(x0 + w // 4, w)
        out[y0:y1, x0:x1] = op(out[y0:y1, x0:x1], it)
    return out


def mask_iou(a: np.ndarray, b: np.ndarray) -> float:
    inter = np.logical_and(a > 0, b > 0).sum()
    union = np.logical_or(a > 0, b > 0).sum()
    return float(inter) / max(union, 1)


def modify_boundary(mask: np.ndarray, rng, target_iou=(0.8, 1.0), max_tries=8) -> np.ndarray:
    """Jitter a mask's boundary until its IoU with the original falls to a
    target drawn from target_iou."""
    lo, hi = target_iou
    target = rng.uniform(lo, hi)
    best = mask.astype(np.uint8)
    for _ in range(max_tries):
        cand = perturb_seg(mask, rng)
        iou = mask_iou(cand, mask)
        if iou <= target and cand.sum() > 0:
            return cand
        if cand.sum() > 0:
            best = cand
    return best


def split_mask(mask: np.ndarray, rng):
    """Split a mask along a random line through its centroid."""
    ys, xs = np.nonzero(mask)
    if len(ys) < 32:
        return [mask]
    cy, cx = ys.mean(), xs.mean()
    theta = rng.uniform(0, np.pi)
    n = np.array([np.cos(theta), np.sin(theta)])
    h, w = mask.shape
    yy, xx = np.mgrid[:h, :w]
    side = ((yy - cy) * n[0] + (xx - cx) * n[1]) > 0
    a = (mask > 0) & side
    b = (mask > 0) & ~side
    out = [m.astype(np.uint8) for m in (a, b) if m.sum() >= 16]
    return out or [mask]


def merge_masks(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Union of two masks, closed with a 15x15 square (dilate, then erode)."""
    u = ((a > 0) | (b > 0)).astype(np.uint8)
    return erode3(dilate3(u, 7), 7)


def perturb_masks(masks: np.ndarray, rng=None, target_iou=(0.8, 1.0),
                  ratios: dict | None = None) -> np.ndarray:
    """Apply the corruption pipeline to a GT mask stack [N, H, W]: FP add ->
    over-/under-segmentation -> delete -> per-mask boundary jitter to the IoU
    target. Returns a (possibly different-length) uint8 stack."""
    rng = rng or np.random.RandomState(0)
    ratios = {**DEFAULT_RATIOS, **(ratios or {})}
    masks = [m.astype(np.uint8) for m in masks]
    if not masks:
        return np.zeros((0, 480, 640), np.uint8)
    h, w = masks[0].shape

    out = list(masks)
    if rng.rand() < ratios["fp"]:
        blob = random_blob(rng, h, w)
        if blob.sum() >= 64:
            out.append(blob)
    if len(out) >= 1 and rng.rand() < ratios["over"]:
        i = rng.randint(len(out))
        pieces = split_mask(out.pop(i), rng)
        out.extend(pieces)
    if len(out) >= 2 and rng.rand() < ratios["under"]:
        i, j = rng.choice(len(out), 2, replace=False)
        merged = merge_masks(out[i], out[j])
        out = [m for k, m in enumerate(out) if k not in (i, j)] + [merged]
    if len(out) >= 2 and rng.rand() < ratios["delete"]:
        out.pop(rng.randint(len(out)))

    if ratios["boundary"] > 0:
        out = [
            modify_boundary(m, rng, target_iou) if rng.rand() < ratios["boundary"] else m
            for m in out
        ]
    out = [m for m in out if m.sum() > 0]
    return np.asarray(out, np.uint8) if out else np.zeros((0, h, w), np.uint8)

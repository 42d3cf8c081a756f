"""Mask perturbation: controlled error injection for refiner training data
(numpy + scipy.ndimage).

Port of the image-free flow of quber_tpu/data/perturb.py: a false-positive
blob, over- and under-segmentation, deletion, and boundary jitter toward a
target IoU, with the same draws from the same generator. The reference's
helpers call OpenCV; here the filled ellipse is `cv2.ellipse`'s own
rasterisation (`fill_ellipse`, pixel for pixel), the bicubic
resize is OpenCV's kernel (a = -0.75, half-pixel centres, replicated
border) written out as two matrix products, and erode / dilate / close are
scipy.ndimage rank filters with OpenCV's default borders (erosion does not
erode from the border of the array it is given, dilation sees background
outside). The flow seeded by Felzenszwalb proposals of the RGB image waits
for the file-backed data slice.
"""

from __future__ import annotations

import math

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


# OpenCV's drawing arithmetic (imgproc/src/drawing.cpp): coordinates in
# fixed point with 16 fractional bits, and its SinTable, the sine of every
# whole degree 0..450 rounded to 7 decimals and stored as float32
_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT
_HALF = _XY_ONE >> 1
_SIN_TABLE = [float(np.float32(round(math.sin(math.radians(i)), 7))) for i in range(451)]


def _cdiv(n: int, d: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(n) // abs(d)
    return q if (n >= 0) == (d >= 0) else -q


def _clip_line(width: int, height: int, x1, y1, x2, y2):
    """OpenCV's clipLine on [0, width - 1] x [0, height - 1] (fixed point):
    (inside, x1, y1, x2, y2)."""
    right, bottom = width - 1, height - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1, c1 = a, (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2, c2 = a, (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line(img: np.ndarray, p1, p2) -> None:
    """OpenCV's Line2: an 8-connected line between fixed-point points, its
    rounded end point first, then one pixel per step of the major axis."""
    h, w = img.shape
    inside, x1, y1, x2, y2 = _clip_line(w << _XY_SHIFT, h << _XY_SHIFT, *p1, *p2)
    if not inside:
        return
    dx, dy = x2 - x1, y2 - y1
    x_major = abs(dx) > abs(dy)
    if x_major:
        if dx < 0:
            dy = -dy
            x1, x2, y1, y2 = x2, x1, y2, y1
        step = _cdiv(dy << _XY_SHIFT, abs(dx) | 1)
        count = (x2 - x1) >> _XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, x2, y1, y2 = x2, x1, y2, y1
        step = _cdiv(dx << _XY_SHIFT, abs(dy) | 1)
        count = (y2 - y1) >> _XY_SHIFT
    pixels = [((x2 + _HALF) >> _XY_SHIFT, (y2 + _HALF) >> _XY_SHIFT)]
    x1 += _HALF
    y1 += _HALF
    if x_major:
        x1 >>= _XY_SHIFT
        pixels += [(x1 + i, (y1 + i * step) >> _XY_SHIFT) for i in range(count + 1)]
    else:
        y1 >>= _XY_SHIFT
        pixels += [((x1 + i * step) >> _XY_SHIFT, y1 + i) for i in range(count + 1)]
    for x, y in pixels:
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = 1


def _fill_convex_poly(img: np.ndarray, pts: list) -> None:
    """OpenCV's FillConvexPoly for 8-connected drawing with XY_SHIFT
    fractional bits: the outline by _line, then each row between two edges
    walked from the topmost vertex, their x stepped by a rounded slope."""
    h, w = img.shape
    n = len(pts)
    prev = pts[-1]
    for p in pts:
        _line(img, prev, p)
        prev = p
    xs = [p[0] for p in pts]
    ys = [p[1] for p in pts]
    imin = ys.index(min(ys))
    xmin, xmax = (min(xs) + _HALF) >> _XY_SHIFT, (max(xs) + _HALF) >> _XY_SHIFT
    ymin, ymax = (min(ys) + _HALF) >> _XY_SHIFT, (max(ys) + _HALF) >> _XY_SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    # the two edges: vertex index, direction, x, slope, row where it ends
    idx, step = [imin, imin], [1, n - 1]
    x, dx, end = [-_XY_ONE, -_XY_ONE], [0, 0], [ymin, ymin]
    edges = n
    y = ymin
    while True:
        for i in range(2):
            if y < end[i]:
                continue
            i0 = idx[i]
            i1 = (i0 + step[i]) % n
            while edges > 0:
                edges -= 1
                ty = (pts[i1][1] + _HALF) >> _XY_SHIFT
                if ty > y:
                    xs0, xe = pts[i0][0], pts[i1][0]
                    end[i], x[i], idx[i] = ty, xs0, i1
                    dx[i] = _cdiv((xe - xs0) * 2 + (ty - y), 2 * (ty - y))
                    break
                i0, i1 = i1, (i1 + step[i]) % n
            else:
                edges -= 1  # the loop's test consumed one more
        if edges < 0:
            return
        if y >= 0:
            left, right = (1, 0) if x[0] > x[1] else (0, 1)
            x1 = (x[left] + _HALF) >> _XY_SHIFT
            x2 = (x[right] + _HALF) >> _XY_SHIFT
            if x2 >= 0 and x1 < w:
                img[y, max(x1, 0):min(x2, w - 1) + 1] = 1
        x[0] += dx[0]
        x[1] += dx[1]
        y += 1
        if y > ymax:
            return


def fill_ellipse(h: int, w: int, center: tuple[int, int], axes: tuple[int, int],
                 angle: float) -> np.ndarray:
    """uint8 [h, w] mask of `cv2.ellipse(mask, center, axes, angle, 0, 360, 1,
    -1)`: the angle rounded to whole degrees, the outline sampled every 5
    to 30 degrees (ellipse2Poly, by the size of the axes) into fixed point,
    then filled as a convex polygon with its outline."""
    img = np.zeros((h, w), np.uint8)
    angle = int(np.rint(angle)) % 360
    cx, cy = center[0] << _XY_SHIFT, center[1] << _XY_SHIFT
    a, b = abs(axes[0]) << _XY_SHIFT, abs(axes[1]) << _XY_SHIFT
    size = (max(a, b) + _HALF) >> _XY_SHIFT
    delta = 90 if size < 3 else 30 if size < 10 else 18 if size < 15 else 5
    cos, sin = _SIN_TABLE[450 - angle], _SIN_TABLE[angle]
    pts = []
    for deg in range(0, 360 + delta, delta):
        deg = min(deg, 360)
        px, py = a * _SIN_TABLE[450 - deg], b * _SIN_TABLE[deg]
        pt = (int(np.rint(cx + px * cos - py * sin)), int(np.rint(cy + px * sin + py * cos)))
        if not pts or pt != pts[-1]:
            pts.append(pt)
    if len(pts) == 1:
        pts = [(cx, cy)] * 2
    _fill_convex_poly(img, pts)
    return img


def random_blob(rng, h, w, area_scale=0.02):
    """Random deformed-ellipse blob mask (a false-positive proposal)."""
    cy, cx = rng.randint(h // 8, 7 * h // 8), rng.randint(w // 8, 7 * w // 8)
    a = max(8, int(np.sqrt(area_scale * h * w) * rng.uniform(0.5, 1.5)))
    b = max(8, int(a * rng.uniform(0.4, 1.0)))
    mask = fill_ellipse(h, w, (cx, cy), (a, b), rng.uniform(0, 180))
    # deform with coarse noise thresholding
    noise = resize_cubic(rng.rand(h // 16 + 1, w // 16 + 1), h, w)
    return ((mask > 0) & (noise > 0.25)).astype(np.uint8)


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

"""Mask perturbation: controlled error injection for refiner training data
(numpy).

Port of the image-free flow of quber_tpu/data/perturb.py: a false-positive
blob, over- and under-segmentation, deletion, and boundary jitter toward a
target IoU, with the same draws from the same generator. The reference's
helpers call OpenCV; here the filled ellipse is `cv2.ellipse`'s own
rasterisation (`fill_ellipse`, pixel for pixel), and the bicubic resize and
erode / dilate / close are the port's OpenCV copies in ops/imgproc
(`resize_cubic`, `erode_rect`, `dilate_rect`). `perturb_masks_reference` is
the reference's flow seeded by Felzenszwalb proposals of the RGB image
(data/felzenszwalb.py), with its per-image ratio sampling.
"""

from __future__ import annotations

import math

import numpy as np

from quber_tpu_torch.ops.imgproc import dilate_rect, erode_rect, resize_cubic

DEFAULT_RATIOS = {
    "fp": 0.15,        # add a spurious instance
    "over": 0.10,      # over-segment: split one GT instance in two
    "under": 0.10,     # under-segment: merge two instances
    "delete": 0.05,    # drop an instance entirely
    "boundary": 1.0,   # boundary jitter applied to every surviving mask
}


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
    noise = resize_cubic(rng.rand(h // 16 + 1, w // 16 + 1), (h, w))
    return ((mask > 0) & (noise > 0.25)).astype(np.uint8)


def perturb_seg(mask: np.ndarray, rng, iterations=(1, 6)) -> np.ndarray:
    """Random local erode/dilate: pick a few random rectangular regions and
    erode or dilate the mask inside them."""
    out = mask.astype(np.uint8).copy()
    h, w = mask.shape
    for _ in range(rng.randint(1, 4)):
        it = rng.randint(*iterations)
        op = erode_rect if rng.rand() < 0.5 else dilate_rect
        y0, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
        y1, x1 = rng.randint(y0 + h // 4, h), rng.randint(x0 + w // 4, w)
        out[y0:y1, x0:x1] = op(out[y0:y1, x0:x1], 3, it)
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
    return erode_rect(dilate_rect(u, 15), 15)


# the reference's per-image ratio ranges
REFERENCE_RATIO_RANGES = {
    "fp": (0.0, 0.2),
    "gs": (0.0, 0.3),
    "merge": (0.0, 0.1),
    "delete": (0.0, 0.1),
    "split": (0.0, 0.1),
}
MIN_MASK_RATIO = 0.01


def _split_by_random_line(mask, rng, min_area, tries=10):
    """Split a mask by a random axis-aligned line into two parts of at least
    min_area each; None if no try succeeds."""
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return None
    y_min, y_max = ys.min(), ys.max()
    x_min, x_max = xs.min(), xs.max()
    for _ in range(tries):
        m1 = mask.copy()
        if rng.rand() < 0.5:
            y1 = rng.randint(y_min, max(y_min + 1, y_max))
            if rng.rand() < 0.5:
                m1[y1:y_max + 1, :] = 0
            else:
                m1[y_min:y1, :] = 0
        else:
            x1 = rng.randint(x_min, max(x_min + 1, x_max))
            if rng.rand() < 0.5:
                m1[:, x1:x_max + 1] = 0
            else:
                m1[:, x_min:x1] = 0
        m2 = np.where(m1 != 0, 0, mask)
        if m1.sum() >= min_area and m2.sum() >= min_area:
            return m1, m2
    return None


def perturb_masks_reference(gt_masks: np.ndarray, rgb: np.ndarray, rng=None,
                            iou_target=(0.8, 1.0),
                            proposals: np.ndarray | None = None) -> np.ndarray:
    """The reference's perturbation flow: false positives and over- /
    under-segmentations from Felzenszwalb proposals of `rgb` (uint8 [H, W,
    3]; ignored when `proposals` is given), GT masks not yet represented,
    merges of adjacent pairs, axis-aligned splits, deletions and boundary
    jitter to the IoU target, each at a ratio drawn per image. gt_masks
    [N, H, W] {0, 1}; returns a uint8 stack."""
    from quber_tpu_torch.data.felzenszwalb import felzenszwalb_proposals

    rng = rng or np.random.RandomState(0)
    gt_masks = np.asarray(gt_masks, np.uint8)
    if gt_masks.size == 0:
        return gt_masks.reshape((0,) + rgb.shape[:2])
    h, w = gt_masks.shape[1:]
    min_area = h * w * MIN_MASK_RATIO
    r = {k: rng.uniform(*v) for k, v in REFERENCE_RATIO_RANGES.items()}
    if proposals is None:
        proposals = felzenszwalb_proposals(rgb, scale=4, sigma=0.2, k=50, min_size=50)

    out = []
    max_gt_area = max(int(m.sum()) for m in gt_masks)
    for gs in proposals:  # false positives: proposals away from every GT mask
        if rng.rand() > r["fp"]:
            continue
        area = gs.sum()
        if area < min_area or area > max_gt_area * 2.0:
            continue
        if max((mask_iou(g, gs) for g in gt_masks), default=0.0) < 0.3:
            out.append(gs.astype(np.uint8))
    for gs in proposals:  # over- / under-segmentation: proposals on a GT mask
        if rng.rand() > r["gs"]:
            continue
        if gs.sum() < min_area:
            continue
        if max((mask_iou(g, gs) for g in gt_masks), default=0.0) > 0.3:
            out.append(gs.astype(np.uint8))
    for g in gt_masks:  # GT masks no proposal stands for yet
        if max((mask_iou(g, p) for p in out), default=0.0) < 0.3:
            out.append(g.copy())

    for i in range(len(out)):  # merge pairs within a 10x10 dilation
        if rng.rand() > r["merge"]:
            continue
        m1 = out[i]
        if m1.sum() == 0:
            continue
        dil = dilate_rect(m1, 10)
        for j in range(len(out)):
            if i == j or out[j].sum() == 0:
                continue
            if int((dil & (out[j] > 0)).sum()) > 0:
                out[i] = ((m1 > 0) | (out[j] > 0)).astype(np.uint8)
                out[j] = np.zeros_like(out[j])
    out = [m for m in out if m.sum() > 0]

    for i in range(len(out)):  # split by a random axis-aligned line
        if rng.rand() > r["split"]:
            continue
        pieces = _split_by_random_line(out[i], rng, min_area)
        if pieces is not None:
            out[i] = pieces[0]
            out.append(pieces[1])

    out = [m for m in out if rng.rand() > r["delete"]]
    out = [modify_boundary(m, rng, iou_target) for m in out]
    out = [m for m in out if m.sum() > 0]
    return np.asarray(out, np.uint8) if out else np.zeros((0, h, w), np.uint8)


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

"""RGB-D preprocessing on the host: depth normalisation, Telea inpainting,
ImageNet standardisation, the point cloud of a depth map and OpenCV's
resizes, in numpy and scipy.

Port of the host functions of quber_tpu/ops/preprocess.py, which call
OpenCV; the port has no OpenCV, so this module carries its own copies:
  * `resize_nearest` is `cv2.resize(..., interpolation=INTER_NEAREST)`: the
    source index of output pixel x is floor(x / (out / in)), clamped;
  * `resize_linear` is `cv2.resize`'s default INTER_LINEAR (half-pixel
    centres, edge clamping, no antialiasing): bit for bit OpenCV's
    fixed-point path for uint8 images (11-bit weights, a horizontal pass
    into integers, a vertical pass with its rounding shifts, and the switch
    to INTER_AREA at an exact 2x downscale), float64 for other types;
    `resize_linear_f32` is its float32 path, on torch tensors (the card's
    or the host's): each pass p + (q - p) * w as one fused multiply-add;
  * `inpaint_telea` is `cv2.inpaint(..., INPAINT_TELEA)`: A. Telea, "An
    Image Inpainting Technique Based on the Fast Marching Method" (2004), as
    OpenCV's photo/src/inpaint.cpp implements it, with its float32
    arithmetic, its order of visits (distance, then insertion order), its
    image-border clamping and its gradient quirks.
"""

from __future__ import annotations

import array
import heapq
import math

import numpy as np
import torch
from scipy import ndimage

from quber_tpu_torch.data import png

_KNOWN, _BAND, _INSIDE, _CHANGE = 0, 1, 2, 3
_F32 = np.float32


def normalize_depth(depth: np.ndarray, min_val: float = 250.0, max_val: float = 1500.0) -> np.ndarray:
    """mm depth [H, W] -> uint8 [H, W, 3] in 0..255."""
    depth = np.asarray(depth, dtype=np.float64).copy()
    depth[depth < min_val] = min_val
    depth[depth > max_val] = max_val
    depth = (depth - min_val) / (max_val - min_val) * 255
    if depth.ndim == 2:
        depth = depth[..., None]
    return np.uint8(np.repeat(depth, 3, -1))


def standardize_image(image: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 3] -> ImageNet-standardised float32 (channel order as given)."""
    mean = np.array([0.485, 0.456, 0.406], dtype=np.float32)
    std = np.array([0.229, 0.224, 0.225], dtype=np.float32)
    return (np.asarray(image, dtype=np.float32) / 255.0 - mean) / std


def compute_xyz(depth_img: np.ndarray, camera_params: dict) -> np.ndarray:
    """Ordered point cloud [H, W, 3] from metric depth [H, W]: x right, y up,
    z forward, with the row index flipped so that y counts from the bottom.
    The focal lengths come from `fx` / `fy`, or else from `fov`, `near` and
    the image size; the centre from `x_offset` / `y_offset`, or else the
    image's middle."""
    if "fx" in camera_params and "fy" in camera_params:
        fx, fy = camera_params["fx"], camera_params["fy"]
    else:
        aspect = camera_params["img_width"] / camera_params["img_height"]
        e = 1 / np.tan(np.radians(camera_params["fov"] / 2.0))
        t = camera_params["near"] / e
        r = t * aspect
        alpha = camera_params["img_width"] / (2 * r)
        fx = fy = camera_params["near"] * alpha

    x_offset = camera_params.get("x_offset", camera_params["img_width"] / 2)
    y_offset = camera_params.get("y_offset", camera_params["img_height"] / 2)

    h, w = depth_img.shape
    ys, xs = np.indices((h, w), dtype=np.float32)
    ys = np.flipud(ys)
    z = depth_img
    x = (xs - x_offset) * z / fx
    y = (ys - y_offset) * z / fy
    return np.stack([x, y, z], axis=-1)


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    scale = 1.0 / (n_out / n_in)  # OpenCV's ifx = 1 / inv_scale
    return np.minimum(np.floor(np.arange(n_out) * scale).astype(np.int64), n_in - 1)


def resize_nearest(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """img [H, W, ...] -> [h, w, ...] at size = (h, w), as cv2.INTER_NEAREST."""
    img = np.asarray(img)
    h, w = size
    if img.shape[:2] == (h, w):
        return img.copy()
    return img[_nearest_index(img.shape[0], h)][:, _nearest_index(img.shape[1], w)]


def _linear_taps(n_in: int, n_out: int):
    """Source indices and weights of cv2.INTER_LINEAR along one axis."""
    scale = n_in / n_out
    fx = (np.arange(n_out) + 0.5) * scale - 0.5
    lo = np.floor(fx).astype(np.int64)
    frac = fx - lo
    frac = np.where(lo < 0, 0.0, frac)
    lo = np.clip(lo, 0, n_in - 1)
    hi = np.minimum(lo + 1, n_in - 1)
    return lo, hi, frac


_COEF_BITS = 11  # OpenCV's INTER_RESIZE_COEF_BITS


def _fixed_taps(n_in: int, n_out: int, clamp: bool):
    """OpenCV's uint8 INTER_LINEAR taps along one axis (imgproc resize.cpp):
    the source position in float32 from scale = 1 / (n_out / n_in), its
    floor, and the two weights as 11-bit integers rounded half to even. The
    horizontal axis clamps the position into the image (`clamp`); the
    vertical one keeps it and clamps the rows it reads."""
    f = ((np.arange(n_out) + 0.5) * (1.0 / (n_out / n_in)) - 0.5).astype(np.float32)
    lo = np.floor(f).astype(np.int64)
    f = f - lo.astype(np.float32)
    if clamp:
        edge = (lo < 0) | (lo >= n_in - 1)
        f = np.where(edge, np.float32(0), f)
        lo = np.clip(lo, 0, n_in - 1)
    one = np.float32(1 << _COEF_BITS)
    w0 = np.rint((np.float32(1) - f) * one).astype(np.int64)
    w1 = np.rint(f * one).astype(np.int64)
    return np.clip(lo, 0, n_in - 1), np.clip(lo + 1, 0, n_in - 1), w0, w1


def _resize_linear_u8(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """cv2.resize(img, (w, h)) for uint8 [H, W] or [H, W, C]."""
    x = img.astype(np.int64)
    if img.shape[0] == 2 * h and img.shape[1] == 2 * w:
        # cv2.resize takes INTER_AREA for an exact 2x downscale: the rounded
        # mean of each 2x2 block
        return ((x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2] + 2) >> 2
                ).astype(np.uint8)
    lo, hi, w0, w1 = _fixed_taps(img.shape[1], w, clamp=True)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    rows = x[:, lo] * w0.reshape(shape) + x[:, hi] * w1.reshape(shape)  # 22-bit sums
    lo, hi, w0, w1 = _fixed_taps(img.shape[0], h, clamp=False)
    shape = (-1,) + (1,) * (x.ndim - 1)
    # the vertical pass of OpenCV's VResizeLinear for uint8: each row >> 4
    # to int16, each product's high 16 bits, the sum rounded off by 2 bits
    out = (((rows[lo] >> 4) * w0.reshape(shape)) >> 16) + \
        (((rows[hi] >> 4) * w1.reshape(shape)) >> 16)
    return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)


def resize_linear(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """img [H, W, ...] -> [h, w, ...] at size = (h, w), bilinear as
    cv2.INTER_LINEAR: uint8 exactly as OpenCV computes it, other integer
    images in float64 rounded and clipped to their type, floats in float64."""
    img = np.asarray(img)
    h, w = size
    if img.shape[:2] == (h, w):
        return img.copy()
    if img.dtype == np.uint8:
        return _resize_linear_u8(img, h, w)
    x = img.astype(np.float64)
    lo, hi, a = _linear_taps(img.shape[0], h)
    a = a.reshape((-1,) + (1,) * (x.ndim - 1))
    x = x[lo] * (1 - a) + x[hi] * a
    lo, hi, a = _linear_taps(img.shape[1], w)
    a = a.reshape((1, -1) + (1,) * (x.ndim - 2))
    x = x[:, lo] * (1 - a) + x[:, hi] * a
    if np.issubdtype(img.dtype, np.integer):
        info = np.iinfo(img.dtype)
        return np.clip(np.floor(x + 0.5), info.min, info.max).astype(img.dtype)
    return x.astype(img.dtype)


def _lerp_taps(n_in: int, n_out: int, device):
    """OpenCV's float INTER_LINEAR taps along one axis, on `device`: the
    source position in double, its floor clamped into the image (a clamped
    tap takes weight 0), and the fraction (kept in double, rounded to
    float32 and back)."""
    f = (torch.arange(n_out, dtype=torch.float64, device=device) + 0.5) * \
        (1.0 / (n_out / n_in)) - 0.5
    lo = torch.floor(f)
    frac = torch.where((lo < 0) | (lo >= n_in - 1), 0.0, f - lo).float().double()
    lo = lo.long().clamp(0, n_in - 1)
    return lo, (lo + 1).clamp(max=n_in - 1), frac


def resize_linear_f32(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """cv2.resize(x, (w, h)) of float32 images x [..., H, W] (channels
    first) at size = (h, w), as OpenCV 5.0 computes it: a horizontal then a
    vertical pass, each p + (q - p) * frac with one rounding (a fused
    multiply-add: the product and sum in float64, exact but for a double
    rounding, then rounded to float32). Equal to cv2 on the sizes the SAM
    wrappers and their recipe resize."""
    h, w = size
    out = x.float()
    for axis, n_out in ((-1, w), (-2, h)):
        lo, hi, frac = _lerp_taps(out.shape[axis], n_out, x.device)
        if axis == -2:
            frac = frac[:, None]
        p, q = out.index_select(axis, lo), out.index_select(axis, hi)
        out = ((q - p).double() * frac + p.double()).float()
    return out


# ---------------------------------------------------------------------------
# Telea inpainting
# ---------------------------------------------------------------------------

def _solve(f, t, a: int, b: int) -> float:
    """OpenCV's FastMarching_solve from the flat neighbours a and b: the
    eikonal update, in double (the caller rounds it to float32)."""
    a11, a22 = t[a], t[b]
    if f[a] != _INSIDE:
        if f[b] != _INSIDE:
            d = a11 - a22
            if abs(d) >= 1.0:
                return 1 + min(a11, a22)
            return (a11 + a22 + math.sqrt(2 - d * d)) * 0.5
        return 1 + a11
    if f[b] != _INSIDE:
        return 1 + a22
    return 1 + min(a11, a22)


def _march(f, t, p: int, w: int, heap: list, seq: int) -> float:
    """Arrival time of flat pixel p from its four neighbours, stored in t (an
    array of float32) and pushed on the heap; returns it."""
    up, down = p - w, p + w
    t[p] = min(_solve(f, t, up, p - 1), _solve(f, t, down, p - 1),
               _solve(f, t, up, p + 1), _solve(f, t, down, p + 1))
    # OpenCV's CvPriorityQueueFloat: smallest time first, ties in the order
    # of insertion
    heapq.heappush(heap, (t[p], seq, p))
    return t[p]


def _offsets(radius: int):
    """Neighbourhood of the weighted sum, in OpenCV's visiting order (rows,
    then columns), with each offset's float32 distance weight 1 / |r|^3."""
    dk, dl = [], []
    for k in range(-radius, radius + 1):
        for l in range(-radius, radius + 1):
            if k * k + l * l <= radius * radius:
                dk.append(k)
                dl.append(l)
    dk, dl = np.array(dk), np.array(dl)
    length = (dk * dk + dl * dl).astype(np.float64)
    with np.errstate(divide="ignore"):
        dst = (1.0 / (length * np.sqrt(length))).astype(_F32)
    return dk, dl, dst


def _telea_crops(holes: np.ndarray, img: np.ndarray, radius: int) -> np.ndarray:
    """Fill `holes` [h, w] in a stack of crops img [G, h, w, C] (uint8),
    all with the same holes, in place. The crops are in the coordinates of
    OpenCV's image padded by one pixel: a crop side is either the padded
    image's border or lies far enough from every hole (radius + 2) that no
    border rule applies to it."""
    h, w = holes.shape
    cross = ndimage.generate_binary_structure(2, 1)
    band = ndimage.binary_dilation(holes, cross) & ~holes
    band[[0, -1], :] = band[:, [0, -1]] = False
    band_px = np.flatnonzero(band).tolist()
    # flags and times as flat buffers for the scalar marching loops, with
    # numpy views of the same memory for the vectorised weights; no popped
    # pixel lies on the crop's border, so p +- 1 and p +- w stay in it
    t = array.array("f", bytes(4 * h * w))
    tv = np.frombuffer(t, _F32).reshape(h, w)
    tv[:] = 1.0e6
    tv[band] = 0

    # distances outside the holes, over a ring `radius` wide, stored negated
    ring = ndimage.binary_dilation(holes, np.ones((2 * radius + 1,) * 2, bool)) & ~holes & ~band
    ring[[0, -1], :] = ring[:, [0, -1]] = False
    fo = bytearray(np.where(ring, _INSIDE, _KNOWN).astype(np.uint8).tobytes())
    heap = [(0.0, n, p) for n, p in enumerate(band_px)]
    seq = len(heap)
    while heap:
        pp = heapq.heappop(heap)[2]
        fo[pp] = _CHANGE
        for p in (pp - w, pp - 1, pp + w, pp + 1):
            if fo[p] == _INSIDE:
                _march(fo, t, p, w, heap, seq)
                fo[p] = _BAND
                seq += 1
    tv[np.frombuffer(fo, np.uint8).reshape(h, w) == _CHANGE] *= -1

    f = bytearray(h * w)
    fv = np.frombuffer(f, np.uint8).reshape(h, w)
    fv[band] = _BAND
    fv[holes] = _INSIDE
    dk, dl, dst = _offsets(radius)
    off, rx_all, ry_all = dk * w + dl, (-dl).astype(_F32), (-dk).astype(_F32)
    fflat, tflat = np.frombuffer(f, np.uint8), np.frombuffer(t, _F32)
    g, c = img.shape[0], img.shape[-1]
    pix = img.astype(_F32).reshape(g, h * w, c)
    heap = [(0.0, n, p) for n, p in enumerate(band_px)]
    seq = len(heap)
    while heap:
        pp = heapq.heappop(heap)[2]
        f[pp] = _KNOWN
        for p in (pp - w, pp - 1, pp + w, pp + 1):
            if f[p] != _INSIDE:
                continue
            tij = _F32(_march(f, t, p, w, heap, seq))
            seq += 1
            # gradient of the arrival time, one-sided where a side is unknown
            right, left = f[p + 1] != _INSIDE, f[p - 1] != _INSIDE
            if right:
                gtx = (_F32(t[p + 1]) - _F32(t[p - 1])) * _F32(0.5) if left \
                    else _F32(t[p + 1]) - tij
            else:
                gtx = tij - _F32(t[p - 1]) if left else _F32(0)
            down, up = f[p + w] != _INSIDE, f[p - w] != _INSIDE
            if down:
                gty = (_F32(t[p + w]) - _F32(t[p - w])) * _F32(0.5) if up \
                    else _F32(t[p + w]) - tij
            else:
                gty = tij - _F32(t[p - w]) if up else _F32(0)

            i, j = divmod(p, w)
            if radius + 1 < i < h - radius - 2 and radius + 1 < j < w - radius - 2:
                # no border rule applies: flat gathers
                q = p + off
                known = fflat[q] != _INSIDE
                q, d, rx, ry = q[known], dst[known], rx_all[known], ry_all[known]
                n = len(q)
                nb = np.concatenate([q + 1, q - 1, q + w, q - w])
                right, left, down, up = (fflat[nb] != _INSIDE).reshape(4, n, 1)
                value, fwd_x, bwd_x, fwd_y, bwd_y = pix[:, np.concatenate([q, nb])].reshape(
                    g, 5, n, c).transpose(1, 0, 2, 3)
                tkl = tflat[q]
                cen_x = cen_y = back_x = back_y = value
            else:
                k, l = i + dk, j + dl
                ok = (k > 0) & (l > 0) & (k < h - 1) & (l < w - 1)
                k, l, d, rx, ry = k[ok], l[ok], dst[ok], rx_all[ok], ry_all[ok]
                known = fflat[k * w + l] != _INSIDE
                k, l, d, rx, ry = k[known], l[known], d[known], rx[known], ry[known]
                # OpenCV's clamped rows and columns at the image border: the
                # weighted sum reads the pixel itself, the gradients these
                km, kp = k + (k == 1), k - (k == h - 2)
                lm, lp = l + (l == 1), l - (l == w - 2)
                value, cen_x = pix[:, k * w + l], pix[:, km * w + lm]
                cen_y, back_x, back_y = cen_x, pix[:, km * w + lp], pix[:, kp * w + lm]
                right = (fflat[k * w + l + 1] != _INSIDE)[:, None]
                left = (fflat[k * w + l - 1] != _INSIDE)[:, None]
                down = (fflat[(k + 1) * w + l] != _INSIDE)[:, None]
                up = (fflat[(k - 1) * w + l] != _INSIDE)[:, None]
                fwd_x, bwd_x = pix[:, km * w + lp + 1], pix[:, km * w + lm - 1]
                fwd_y, bwd_y = pix[:, (kp + 1) * w + lm], pix[:, (km - 1) * w + lm]
                tkl = tflat[k * w + l]
            lev = (1.0 / (1 + np.abs((tkl - tij).astype(np.float64)))).astype(_F32)
            direction = rx * gtx + ry * gty
            direction[np.abs(direction) <= 0.01] = 1e-6
            wt = np.abs(d * lev * direction)
            # image gradient at each neighbour, one-sided where a side is unknown
            gix = np.where(right, np.where(left, (fwd_x - bwd_x) * 2, fwd_x - cen_x),
                           np.where(left, back_x - bwd_x, 0))
            giy = np.where(down, np.where(up, (fwd_y - bwd_y) * 2, fwd_y - cen_y),
                           np.where(up, back_y - bwd_y, 0))
            # float32 sums in OpenCV's order (cumsum adds left to right)
            terms = np.stack([value, -(gix * rx[:, None]), -(giy * ry[:, None])])
            ia, jx, jy = np.cumsum(wt[:, None] * terms, axis=2, dtype=_F32)[:, :, -1]
            s = np.cumsum(np.concatenate([[_F32(1e-20)], wt]), dtype=_F32)[-1]
            sat = ia / s + (jx + jy) / (np.sqrt(jx * jx + jy * jy) + _F32(1e-20)) + _F32(0.5)
            pix[:, p] = np.clip(np.rint(sat), 0, 255)
            f[p] = _BAND
    flat = holes.reshape(-1)
    img.reshape(g, h * w, c)[:, flat] = pix[:, flat].astype(img.dtype)
    return img


def inpaint_telea(img: np.ndarray, mask: np.ndarray, radius: int) -> np.ndarray:
    """`cv2.inpaint(img, mask, radius, cv2.INPAINT_TELEA)` for uint8 [H, W]
    or [H, W, C]: the pixels where `mask` is non-zero are filled.

    Holes whose neighbourhoods (radius + 1) do not touch are filled
    independently, and holes of one shape are filled together: the visiting
    order and the weights depend only on the hole's shape, so a stack of
    crops shares them."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"inpaint_telea takes uint8 images, got {img.dtype}")
    out = img.copy()
    radius = min(max(int(round(radius)), 1), 100)
    holes = np.zeros((img.shape[0] + 2, img.shape[1] + 2), bool)
    holes[1:-1, 1:-1] = np.asarray(mask) != 0
    if not holes.any():
        return out
    padded = np.pad(img.reshape(img.shape[:2] + (-1,)), ((1, 1), (1, 1), (0, 0)), mode="edge")
    reach = ndimage.binary_dilation(holes, np.ones((2 * radius + 3,) * 2, bool))
    labels, _ = ndimage.label(reach, np.ones((3, 3), bool))
    groups: dict = {}
    for comp, (sy, sx) in enumerate(ndimage.find_objects(labels), start=1):
        ys = slice(max(sy.start - 1, 0), min(sy.stop + 1, holes.shape[0]))
        xs = slice(max(sx.start - 1, 0), min(sx.stop + 1, holes.shape[1]))
        local = holes[ys, xs] & (labels[ys, xs] == comp)
        key = (local.shape, local.tobytes())
        groups.setdefault(key, (local, []))[1].append((ys, xs))
    for local, crops in groups.values():
        stack = np.stack([padded[ys, xs] for ys, xs in crops])
        _telea_crops(local, stack, radius)
        for (ys, xs), filled in zip(crops, stack):
            padded[ys, xs][local] = filled[local]
    return padded[1:-1, 1:-1].reshape(img.shape)


def inpaint_depth(depth: np.ndarray, factor: int = 1) -> np.ndarray:
    """Telea-inpaint the zero-depth holes of a normalised uint8 depth [H, W, 3]:
    the zero mask dilated by a 3x3 square, filled with radius 3, pasted back
    only where the depth was zero. Only factor=1 (no resize around the fill)
    is supported."""
    if factor != 1:
        raise NotImplementedError("inpaint_depth supports factor=1 only")
    depth = np.asarray(depth)
    mask = ndimage.binary_dilation(np.all(depth == 0, axis=2), np.ones((3, 3), bool))
    inpainted = inpaint_telea(depth, mask, 3)
    return np.where(depth == 0, inpainted, depth)


def load_rgbd(rgb_path: str, depth_path: str, size: tuple[int, int]):
    """Read a frame at size = (h, w): (BGR uint8 [h, w, 3] as cv2.imread gives
    it, bilinear-resized; normalised depth uint8 [h, w, 3], nearest-resized
    and inpainted; the zero-depth mask at the depth file's own size). An .npy
    depth is in metres, a PNG in millimetres."""
    rgb = resize_linear(png.imread(rgb_path, bgr=True), size)
    if depth_path.endswith(".npy"):
        depth = np.load(depth_path)
        depth_n = normalize_depth(depth, 0.25, 1.5)
    else:
        depth = png.imread(depth_path)
        depth_n = normalize_depth(depth)
    return rgb, inpaint_depth(resize_nearest(depth_n, size)), depth == 0

"""The OpenCV functions that the training augmentations and the offline data
tools call, in numpy and scipy (the port has no OpenCV):

  * `bgr2hsv` / `hsv2bgr` / `bgr2hls` / `hls2bgr`: `cv2.cvtColor` on uint8
    (hue in 0..180). BGR -> HSV is OpenCV's integer path (12-bit division
    tables, rounding half up); the other three go through float32 with
    OpenCV's fused multiply-adds. Its vector loop and the scalar code that
    takes the rest of a row round differently, so the copies follow each
    pixel's column. The lane widths (32 pixels for HSV -> BGR, 8 for
    BGR -> HLS) are those of OpenCV 5.0's color_hsv code built for AVX2,
    its widest dispatch target, which an x86-64 wheel runs on any CPU with
    AVX2 (AVX-512 ones too). Another build or dispatch (ARM NEON, a CPU
    without AVX2, cv2.setUseOptimized(False)) splits rows at other columns,
    and there these copies can differ from cv2 by one level in a row's tail;
  * `remap_nearest`: `cv2.remap(src, map_x, map_y, INTER_NEAREST,
    borderMode=BORDER_REPLICATE)` with float32 maps: each coordinate is
    rounded half to even (cvRound), then clamped into the image;
  * `resize_cubic`: `cv2.resize(src, (w, h), interpolation=INTER_CUBIC)`
    of a float32 or float64 image: OpenCV's float32 coefficients
    (a = -0.75, half-pixel centres), a horizontal then a vertical pass in
    the image's dtype, rows and columns clamped (float64 equal to OpenCV
    5.0; float32 within 2.5e-6, its float32 order not reproduced);
  * `rotation_matrix` / `warp_affine`: `cv2.getRotationMatrix2D` and
    `cv2.warpAffine` (INTER_LINEAR or INTER_NEAREST, BORDER_CONSTANT 0):
    the inverse map in double, source coordinates and bilinear weights in
    float32 (uint8: within one grey level of OpenCV on ~0.02% of pixels);
  * `gaussian_blur`: `cv2.GaussianBlur(src, (k, k), sigma)` with
    BORDER_REFLECT_101. uint8 takes OpenCV's bit-exact path: a kernel of
    8 fractional bits (error-diffused from the double kernel), two integer
    passes and one rounding; float32 with a 3-tap kernel is OpenCV's fused
    symmetric filter, bit for bit; other kernels are separable in float64;
  * `erode_rect` / `dilate_rect`: `cv2.erode` / `cv2.dilate` with an
    all-ones k x k kernel (anchor at k // 2) and OpenCV's default border
    (erosion does not erode from outside the array, dilation sees
    background there).
"""

from __future__ import annotations

import math

import numpy as np
from scipy import ndimage

_F32 = np.float32


# ---------------------------------------------------------------------------
# colour conversions (uint8, hue range 180)
# ---------------------------------------------------------------------------

_HSV_SHIFT = 12


def _hsv_tables():
    i = np.arange(256, dtype=np.float64)
    with np.errstate(divide="ignore"):
        sdiv = np.where(i > 0, np.rint((255 << _HSV_SHIFT) / np.maximum(i, 1)), 0)
        hdiv = np.where(i > 0, np.rint((180 << _HSV_SHIFT) / (6.0 * np.maximum(i, 1))), 0)
    return sdiv.astype(np.int64), hdiv.astype(np.int64)


_SDIV, _HDIV = _hsv_tables()


def bgr2hsv(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_BGR2HSV) of a uint8 [..., 3] image."""
    x = np.asarray(img).astype(np.int64)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    vmin = np.minimum(np.minimum(b, g), r)
    diff = v - vmin
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.clip(np.stack([h, s, v], axis=-1), 0, 255).astype(np.uint8)


# which of (v, p, q, t) -- tab[0..3] -- goes to b, g, r in each sector
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def _to_u8(x: np.ndarray) -> np.ndarray:
    """saturate_cast<uchar>(float): round half to even, then clamp."""
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


def _pick(tab: np.ndarray, sector: np.ndarray) -> np.ndarray:
    idx = _SECTORS[sector]  # [..., 3]
    return np.take_along_axis(tab, idx, axis=-1)


def _fma(a, b, c) -> np.ndarray:
    """a * b + c in float32 with one rounding, as a fused multiply-add."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + c).astype(_F32)


def _vector_columns(img: np.ndarray, lanes: int) -> np.ndarray:
    """Whether each column of a row falls in OpenCV's vector loop, which
    takes `lanes` pixels at a time; the row's last width % lanes pixels go
    through its scalar code, which rounds differently."""
    w = img.shape[1]
    return np.arange(w) < (w // lanes) * lanes


def hsv2bgr(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_HSV2BGR) of a uint8 [H, W, 3] image: float32
    with fused 1 - s * h; the result * 255 is truncated in the vector loop
    (32 pixels at a time) and rounded half to even in the scalar tail."""
    x = np.asarray(img)
    s = x[..., 1].astype(_F32) * _F32(1.0 / 255.0)
    v = x[..., 2].astype(_F32) * _F32(1.0 / 255.0)
    h = (x[..., 0].astype(_F32) * _F32(6.0 / 180.0)).astype(_F32)
    sector = np.floor(h).astype(np.int64)
    h = (h - sector.astype(_F32)).astype(_F32)
    one = _F32(1.0)
    tab = np.stack([v, v * (one - s), v * _fma(-s, h, 1.0), v * _fma(-s, one - h, 1.0)],
                   axis=-1)
    bgr = _pick(tab.astype(_F32), sector % 6)
    bgr = np.where((s == 0)[..., None], v[..., None], bgr)
    bgr = (bgr * _F32(255.0)).astype(_F32)
    out = np.where(_vector_columns(x, 32)[:, None], np.floor(bgr), np.rint(bgr))
    return np.clip(out, 0, 255).astype(np.uint8)


def bgr2hls(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_BGR2HLS) of a uint8 [H, W, 3] image: float32,
    the hue one fused multiply-add (the vector loop, 8 pixels at a time,
    folds a negative red-branch hue's + 360 into it; the scalar tail adds it
    after), the saturation's divisor 2 - (max + min) in the vector loop and
    2 - max - min in the tail."""
    x = np.asarray(img).astype(_F32) * _F32(1.0 / 255.0)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    vec = _vector_columns(np.asarray(img), 8)
    vmax = np.maximum(np.maximum(r, g), b)
    vmin = np.minimum(np.minimum(r, g), b)
    diff = (vmax - vmin).astype(_F32)
    lum = ((vmax + vmin) * _F32(0.5)).astype(_F32)
    chroma = diff > np.finfo(np.float32).eps
    total = (vmax + vmin).astype(_F32)
    with np.errstate(divide="ignore", invalid="ignore"):
        high = np.where(vec, diff / (_F32(2.0) - total), diff / (_F32(2.0) - vmax - vmin))
        s = np.where(lum < _F32(0.5), diff / total, high).astype(_F32)
        k = (_F32(60.0) / diff).astype(_F32)
        wrap = np.where(vec & (g < b), 360.0, 0.0)
        h = np.where(vmax == r, _fma(g - b, k, wrap),
                     np.where(vmax == g, _fma(b - r, k, 120.0), _fma(r - g, k, 240.0)))
    h = np.where(h < 0, h + _F32(360.0), h).astype(_F32)
    h = np.where(chroma, h, _F32(0))
    s = np.where(chroma, s, _F32(0))
    return np.stack([_to_u8(h * _F32(0.5)), _to_u8(lum * _F32(255.0)),
                     _to_u8(s * _F32(255.0))], axis=-1)


def hls2bgr(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_HLS2BGR) of a uint8 [..., 3] image."""
    x = np.asarray(img)
    h = x[..., 0].astype(_F32)
    lum = x[..., 1].astype(_F32) * _F32(1.0 / 255.0)
    s = x[..., 2].astype(_F32) * _F32(1.0 / 255.0)
    one = _F32(1.0)
    p2 = np.where(lum <= _F32(0.5), lum * (one + s), lum + s - lum * s).astype(_F32)
    p1 = (_F32(2.0) * lum - p2).astype(_F32)
    h = (h * _F32(6.0 / 180.0)).astype(_F32)
    h = np.where(h >= 6, h - _F32(6.0), h).astype(_F32)  # h < 6.0 * 255 / 180 < 12
    sector = np.floor(h).astype(np.int64)
    h = (h - sector.astype(_F32)).astype(_F32)
    tab = np.stack([p2, p1, p1 + (p2 - p1) * (one - h), p1 + (p2 - p1) * h], axis=-1)
    bgr = _pick(tab.astype(_F32), np.clip(sector, 0, 5))
    gray = (s == 0)[..., None]
    bgr = np.where(gray, lum[..., None], bgr)
    return _to_u8(bgr.astype(_F32) * _F32(255.0))


# ---------------------------------------------------------------------------
# geometric maps
# ---------------------------------------------------------------------------

def remap_nearest(src: np.ndarray, map_x: np.ndarray, map_y: np.ndarray) -> np.ndarray:
    """cv2.remap(src, map_x, map_y, INTER_NEAREST, borderMode=BORDER_REPLICATE)."""
    src = np.asarray(src)
    h, w = src.shape[:2]
    xs = np.clip(np.rint(np.asarray(map_x, _F32)).astype(np.int64), 0, w - 1)
    ys = np.clip(np.rint(np.asarray(map_y, _F32)).astype(np.int64), 0, h - 1)
    return src[ys, xs]


def _cubic_taps(n_in: int, n_out: int):
    """Source indices [n_out, 4] (clamped) and float32 weights [n_out, 4] of
    OpenCV's INTER_CUBIC along one axis."""
    scale = n_in / n_out
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(_F32)
    base = np.floor(f).astype(np.int64)
    x = (f - base.astype(_F32)).astype(_F32)
    a = _F32(-0.75)
    one = _F32(1.0)
    c0 = ((a * (x + one) - _F32(5.0) * a) * (x + one) + _F32(8.0) * a) * (x + one) - _F32(4.0) * a
    c1 = ((a + _F32(2.0)) * x - (a + _F32(3.0))) * x * x + one
    c2 = ((a + _F32(2.0)) * (one - x) - (a + _F32(3.0))) * (one - x) * (one - x) + one
    c3 = one - c0 - c1 - c2
    idx = np.clip(base[:, None] + np.arange(-1, 3)[None], 0, n_in - 1)
    return idx, np.stack([c0, c1, c2, c3], axis=1).astype(_F32)


def resize_cubic(src: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """cv2.resize(src, (w, h), interpolation=INTER_CUBIC) of a float32 or
    float64 [H, W] image, at size = (h, w), computed in the image's dtype."""
    src = np.asarray(src)
    if src.dtype != np.float64:
        src = src.astype(_F32)
    dt = src.dtype
    h, w = size
    ix, wx = _cubic_taps(src.shape[1], w)
    rows = src[:, ix[:, 0]] * wx[:, 0]
    for k in range(1, 4):
        rows = (rows + src[:, ix[:, k]] * wx[:, k]).astype(dt)
    iy, wy = _cubic_taps(src.shape[0], h)
    out = rows[iy[:, 0]] * wy[:, 0:1]
    for k in range(1, 4):
        out = (out + rows[iy[:, k]] * wy[:, k:k + 1]).astype(dt)
    return out


def rotation_matrix(center: tuple[float, float], angle: float, scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D(center, angle, scale): [2, 3] float64."""
    a = math.radians(angle)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


def _invert_affine(m: np.ndarray) -> list[float]:
    """warpAffine's inverse of a forward [2, 3] map, in double."""
    m = [float(v) for v in np.asarray(m, np.float64).reshape(-1)]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


def warp_affine(src: np.ndarray, m: np.ndarray, size: tuple[int, int],
                nearest: bool = False) -> np.ndarray:
    """cv2.warpAffine(src, m, (w, h), flags=INTER_LINEAR or INTER_NEAREST)
    with a zero constant border, at size = (w, h) as OpenCV takes it: source
    coordinates in float32, nearest rounds them half to even, linear takes
    float32 weights and rounds the result half to even."""
    src = np.asarray(src)
    w, h = size
    im = np.asarray(_invert_affine(m), _F32)
    ys, xs = np.mgrid[:h, :w].astype(_F32)
    sx = (im[0] * xs + im[1] * ys + im[2]).astype(_F32)
    sy = (im[3] * xs + im[4] * ys + im[5]).astype(_F32)
    sh, sw = src.shape[:2]
    extra = (1,) * (src.ndim - 2)

    def tap(yy, xx):
        ok = (xx >= 0) & (xx < sw) & (yy >= 0) & (yy < sh)
        v = src[np.clip(yy, 0, sh - 1), np.clip(xx, 0, sw - 1)]
        return np.where(ok.reshape(ok.shape + extra), v, 0)

    if nearest:
        return tap(np.rint(sy).astype(np.int64), np.rint(sx).astype(np.int64)).astype(src.dtype)
    x0, y0 = np.floor(sx).astype(np.int64), np.floor(sy).astype(np.int64)
    ax = (sx - x0).astype(_F32).reshape(sx.shape + extra)
    ay = (sy - y0).astype(_F32).reshape(sy.shape + extra)
    one = _F32(1.0)
    out = ((tap(y0, x0).astype(_F32) * (one - ax) + tap(y0, x0 + 1).astype(_F32) * ax)
           * (one - ay)
           + (tap(y0 + 1, x0).astype(_F32) * (one - ax) + tap(y0 + 1, x0 + 1).astype(_F32) * ax)
           * ay)
    if np.issubdtype(src.dtype, np.integer):
        info = np.iinfo(src.dtype)
        return np.clip(np.rint(out), info.min, info.max).astype(src.dtype)
    return out.astype(src.dtype)


# ---------------------------------------------------------------------------
# Gaussian blur
# ---------------------------------------------------------------------------

def _gaussian_kernel(n: int, sigma: float) -> np.ndarray:
    """OpenCV's getGaussianKernelBitExact in float64 (sigma > 0)."""
    scale2 = -0.125 / (sigma * sigma)
    half = (n - 1) // 2
    x = np.arange(1 - n, 1 - n + 2 * half, 2, dtype=np.float64)
    t = np.exp(x * x * scale2)
    total = 2.0 * t.sum() + 1.0
    mul = 1.0 / total
    k = np.empty(n)
    k[:half] = t * mul
    k[n - half:] = (t * mul)[::-1]
    k[half] = mul
    return k


def _fixed_kernel(kernel: np.ndarray, bits: int = 8) -> np.ndarray:
    """OpenCV's getGaussianKernelFixedPoint_ED: the outer taps rounded with
    their error carried inward, the centre tap what makes the sum 1."""
    n = len(kernel)
    one = 1 << bits
    out = np.empty(n, np.int64)
    err = 0.0
    acc = 0
    for i in range(n // 2):
        adj = kernel[i] * one + err
        v = int(np.rint(adj))
        err = adj - v
        out[i] = out[n - 1 - i] = v
        acc += v
    out[n // 2] = one - 2 * acc
    return out


def _reflect101(n: int, pad: int) -> np.ndarray:
    idx = np.arange(-pad, n + pad)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    idx = np.mod(idx, period)
    return np.where(idx >= n, period - idx, idx)


def _blur_ksize(sigma: float, dtype) -> int:
    """The kernel size cv2.GaussianBlur takes for ksize (0, 0)."""
    k = 3 if np.dtype(dtype) == np.uint8 else 4
    return int(np.rint(sigma * k * 2 + 1)) | 1


def gaussian_blur(src: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur(src, (ksize, ksize), sigma) of a uint8 or float32
    [H, W] or [H, W, C] image (sigma > 0); ksize 0 takes OpenCV's size for
    sigma."""
    src = np.asarray(src)
    if ksize <= 0:
        ksize = _blur_ksize(sigma, src.dtype)
    kernel = _gaussian_kernel(ksize, sigma)
    pad = ksize // 2
    ry = _reflect101(src.shape[0], pad)
    rx = _reflect101(src.shape[1], pad)
    h, w = src.shape[:2]
    if src.dtype == np.uint8:
        k = _fixed_kernel(kernel)
        x = src.astype(np.int64)[:, rx]
        rows = sum(x[:, i:i + w] * k[i] for i in range(ksize))
        rows = rows[ry]
        acc = sum(rows[i:i + h] * k[i] for i in range(ksize))
        return np.clip((acc + (1 << 15)) >> 16, 0, 255).astype(np.uint8)
    if ksize == 3 and src.dtype == _F32:
        # OpenCV's symmetric 3-tap row and column filters, fused as its
        # vector code fuses them
        k0, k1 = kernel.astype(_F32)[:2]
        x = src[:, rx]
        mid, sides = x[:, 1:w + 1], (x[:, :w] + x[:, 2:]) * k0
        rows = _fma(mid, k1, sides).reshape(len(x), -1)
        if rows.shape[1] % 2:
            # a row of odd length (width x channels) takes its last element
            # through the scalar code, unfused
            rows[:, -1] = (mid * k1 + sides).reshape(len(x), -1)[:, -1]
        rows = rows.reshape(x.shape[:1] + src.shape[1:])[ry]
        return _fma(rows[:h] + rows[2:], k0, rows[1:h + 1] * k1)
    x = src.astype(np.float64)[:, rx]
    rows = sum(x[:, i:i + w] * kernel[i] for i in range(ksize))[ry]
    return sum(rows[i:i + h] * kernel[i] for i in range(ksize)).astype(src.dtype)


# ---------------------------------------------------------------------------
# morphology with a rectangular kernel
# ---------------------------------------------------------------------------

def _origin(k: int) -> int:
    """scipy's origin that puts a k-wide window at OpenCV's anchor k // 2."""
    return (k // 2) - (k - 1) // 2 if k % 2 == 0 else 0


def erode_rect(mask: np.ndarray, k: int, iterations: int = 1) -> np.ndarray:
    """cv2.erode(mask, np.ones((k, k)), iterations=...) with OpenCV's default
    border (outside the array counts as foreground)."""
    size = (k - 1) * iterations + 1
    mask = np.asarray(mask)
    top = True if mask.dtype == bool else np.iinfo(mask.dtype).max
    return ndimage.minimum_filter(mask, size=size, mode="constant", cval=top,
                                  origin=-_origin(size))


def dilate_rect(mask: np.ndarray, k: int, iterations: int = 1) -> np.ndarray:
    """cv2.dilate(mask, np.ones((k, k)), iterations=...) with OpenCV's default
    border (outside the array counts as background)."""
    size = (k - 1) * iterations + 1
    return ndimage.maximum_filter(mask, size=size, mode="constant", cval=0,
                                  origin=-_origin(size))

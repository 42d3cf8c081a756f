"""PNG reader and writer in numpy and zlib, the port's stand-in for
`imageio.imread` / `imageio.imwrite` and `cv2.imread`.

Formats: non-interlaced 8-bit grey, RGB and RGBA, and 16-bit grey (the depth
images of OSD and OCID). Anything else raises ValueError.

Rows filtered with None, Sub or Up are undone with whole-row numpy
operations; Average and Paeth rows (which encoders such as Pillow's choose
row by row) depend on the pixel to their left, so they are undone pixel by
pixel, a slower path. The writer emits unfiltered rows, so files it writes
read back on the fast path.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel, for the formats read and written here
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG file has no IEND chunk")


def _unfilter_slow(kind: int, line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """Average (3) and Paeth (4) rows: each pixel needs the one reconstructed
    to its left, so the loop runs over pixels, vectorised over their bytes."""
    out = np.zeros(len(line), np.int32)
    cur = line.astype(np.int32)
    up = prev.astype(np.int32)
    left = np.zeros(bpp, np.int32)
    upleft = np.zeros(bpp, np.int32)
    for x in range(0, len(line), bpp):
        b = up[x:x + bpp]
        if kind == 3:
            pred = (left + b) >> 1
        else:
            p = left + b - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - b), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, b, upleft))
        left = (cur[x:x + bpp] + pred) & 0xFF
        out[x:x + bpp] = left
        upleft = b
    return out.astype(np.uint8)


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a wrapping running sum, lane by lane
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prev
        elif kind in (3, 4):
            cur = _unfilter_slow(kind, line, prev, bpp)
        else:
            raise ValueError(f"PNG row filter {kind} is not defined")
        out[y] = cur
        prev = out[y]
    return out


def imread(path: str, bgr: bool = False) -> np.ndarray:
    """Decode a PNG file: uint8 [H, W] (grey), [H, W, 3] (RGB) or [H, W, 4]
    (RGBA), or uint16 [H, W] (16-bit grey).

    With `bgr`, return what `cv2.imread(path)` (IMREAD_COLOR) returns: uint8
    [H, W, 3] in BGR order, grey replicated to three channels, alpha dropped
    and 16-bit samples cut to their high byte."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, compression, filt, interlace = header
    if color not in _CHANNELS or compression or filt or interlace:
        raise ValueError(f"{path}: unsupported PNG (colour type {color}, interlace "
                         f"{interlace}); only 8-bit grey, RGB, RGBA and 16-bit grey")
    if depth != 8 and not (depth == 16 and color == 0):
        raise ValueError(f"{path}: unsupported bit depth {depth} for colour type {color}")
    channels = _CHANNELS[color]
    bpp = channels * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * bpp + 1):
        raise ValueError(f"{path}: image data has {raw.size} bytes, expected "
                         f"{h * (w * bpp + 1)}")
    pix = _unfilter(raw, h, w * bpp, bpp)
    if depth == 16:
        img = pix.reshape(h, w, 2).view(">u2")[..., 0].astype(np.uint16)
    else:
        img = pix.reshape(h, w, channels) if channels > 1 else pix.reshape(h, w)
    if not bgr:
        return img
    if depth == 16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    return np.ascontiguousarray(img[..., 2::-1])


def imwrite(path: str, img: np.ndarray) -> None:
    """Encode uint8 [H, W], [H, W, 3] or [H, W, 4], or uint16 [H, W], as a PNG
    with unfiltered rows."""
    img = np.asarray(img)
    if img.dtype == np.uint16 and img.ndim == 2:
        color, depth, body = 0, 16, img.astype(">u2").view(np.uint8).reshape(img.shape[0], -1)
    elif img.dtype == np.uint8 and (img.ndim == 2 or (img.ndim == 3 and img.shape[2] in (3, 4))):
        color = 0 if img.ndim == 2 else {3: 2, 4: 6}[img.shape[2]]
        depth, body = 8, img.reshape(img.shape[0], -1)
    else:
        raise ValueError(f"cannot write {img.dtype} {img.shape} as PNG")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), body], axis=1)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        crc = zlib.crc32(kind + payload) & 0xFFFFFFFF
        return struct.pack(">I", len(payload)) + kind + payload + struct.pack(">I", crc)

    header = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(rows.tobytes())) + chunk(b"IEND", b""))

"""COCO RLE codec (numpy): pycocotools-compatible dicts
{"size": [h, w], "counts": str}, column-major runs starting with the zero
run, counts packed as LEB128-like characters with a delta against the count
two back.

Port of the numpy codec of quber_tpu/data/rle.py (the reference also binds
a C library for speed; the port keeps the one implementation).

    encode(mask) -> rle dict
    decode(rle)  -> uint8 [h, w]
    decode_batch([rle, ...]) -> uint8 [n, h, w]
"""

from __future__ import annotations

import numpy as np


def _counts_from_mask(mask: np.ndarray) -> np.ndarray:
    """Column-major run lengths, starting with the zero run."""
    flat = np.asarray(mask, np.uint8).T.reshape(-1)  # column-major
    change = np.nonzero(np.diff(flat))[0] + 1
    edges = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(edges)
    if flat.size and flat[0] == 1:
        counts = np.concatenate([[0], counts])
    return counts.astype(np.int64)


def _string_from_counts(counts) -> str:
    out = []
    counts = list(counts)
    for i, c in enumerate(counts):
        x = int(c)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            ch = x & 0x1F
            x >>= 5
            more = (x != -1) if (ch & 0x10) else (x != 0)
            if more:
                ch |= 0x20
            out.append(chr(ch + 48))
    return "".join(out)


def _counts_from_string(s: str) -> list[int]:
    counts, p = [], 0
    while p < len(s):
        x, k, more = 0, 0, True
        while more:
            c = ord(s[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def _mask_from_counts(counts, h: int, w: int) -> np.ndarray:
    total = h * w
    flat = np.zeros((total,), np.uint8)
    pos, v = 0, 0
    for c in counts:
        if v:
            flat[pos : pos + c] = 1
        pos += c
        v ^= 1
    return flat.reshape(w, h).T  # column-major


def encode(mask: np.ndarray) -> dict:
    mask = np.asarray(mask, np.uint8)
    h, w = mask.shape
    return {"size": [h, w], "counts": _string_from_counts(_counts_from_mask(mask))}


def decode(rle: dict) -> np.ndarray:
    h, w = rle["size"]
    s = rle["counts"]
    if isinstance(s, bytes):
        s = s.decode("ascii")
    return _mask_from_counts(_counts_from_string(s), h, w)


def decode_batch(rles: list[dict]) -> np.ndarray:
    if not rles:
        return np.zeros((0, 0, 0), np.uint8)
    return np.stack([decode(r) for r in rles])

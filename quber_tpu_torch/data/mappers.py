"""Host-side mapper helpers: depth normalisation, the endless batch
iterator of the trainer, and the test-time resize helpers of the
multi-scale predictor.

`normalize_depth_mm`, `batch_iterator`, `resize_shortest_edge` and
`bucket_shape` are copies of quber_tpu/data/mappers.py (the iterator takes
in-memory records only: named datasets on disk wait for the file-backed
data slice). `resize` takes the place of the
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

_MODES = {"linear": "bilinear", "nearest": "nearest"}


def normalize_depth_mm(depth_mm: np.ndarray, depth_range=(2500, 15000)) -> np.ndarray:
    """mm -> 0..255 replicated to 3 channels, under the training depth range."""
    lo, hi = depth_range
    d = np.clip(depth_mm.astype(np.float32), lo, hi)
    d = (d - lo) / (hi - lo) * 255.0
    return np.repeat(d[..., None], 3, axis=-1)


def batch_iterator(records, mapper, batch_size: int, shuffle=True, seed=0):
    """Endless iterator of stacked batches of mapper(record) dicts; samples
    are grouped by the shapes of their arrays, so each batch stacks."""
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

"""Felzenszwalb-Huttenlocher efficient graph-based image segmentation.

Port of quber_tpu/data/felzenszwalb.py, the proposals that seed the
reference perturbation flow's false positives and over- / under-
segmentations (at quarter resolution, sigma 0.2, k 50, min_size 50).
Felzenszwalb & Huttenlocher (IJCV 2004): Gaussian smoothing (OpenCV's
float32 GaussianBlur, ops/imgproc.gaussian_blur, bit for bit: the smoothed
values order the edges), an 8-connected pixel graph with colour-distance
edge weights, a Kruskal pass with the adaptive threshold
MInt(C1, C2) = min(Int(Ci) + k / |Ci|), then a min-size merge pass. Offline
host-side tooling: a Python union-find is fast enough.
"""

from __future__ import annotations

import numpy as np

from quber_tpu_torch.ops.imgproc import gaussian_blur
from quber_tpu_torch.ops.preprocess import resize_linear, resize_nearest


class _UnionFind:
    __slots__ = ("parent", "size", "internal")

    def __init__(self, n):
        self.parent = np.arange(n, dtype=np.int64)
        self.size = np.ones(n, dtype=np.int64)
        self.internal = np.zeros(n, dtype=np.float64)  # Int(C): max MST edge

    def find(self, x):
        p = self.parent
        root = x
        while p[root] != root:
            root = p[root]
        while p[x] != root:  # path compression
            p[x], x = root, p[x]
        return root

    def union(self, a, b, w):
        if self.size[a] < self.size[b]:
            a, b = b, a
        self.parent[b] = a
        self.size[a] += self.size[b]
        self.internal[a] = w
        return a


def _smooth(img: np.ndarray, sigma: float) -> np.ndarray:
    if sigma <= 0:
        return img.astype(np.float64)
    ksize = max(3, int(4 * sigma + 1) | 1)
    return gaussian_blur(img.astype(np.float32), ksize, sigma).astype(np.float64)


def felzenszwalb(img: np.ndarray, sigma: float = 0.2, k: float = 50.0,
                 min_size: int = 50) -> np.ndarray:
    """Segment an [H, W, C] (or [H, W]) image.

    Returns an int32 label image [H, W] with labels 0..n_components-1.
    """
    img = np.atleast_3d(np.asarray(img))
    h, w, _ = img.shape
    smoothed = _smooth(img, sigma)

    idx = np.arange(h * w).reshape(h, w)

    def edges_for(off_y, off_x):
        a = idx[max(0, -off_y): h - max(0, off_y),
                max(0, -off_x): w - max(0, off_x)]
        b = idx[max(0, off_y): h - max(0, -off_y),
                max(0, off_x): w - max(0, -off_x)]
        pa = smoothed.reshape(-1, smoothed.shape[-1])[a.ravel()]
        pb = smoothed.reshape(-1, smoothed.shape[-1])[b.ravel()]
        wgt = np.sqrt(((pa - pb) ** 2).sum(axis=-1))
        return a.ravel(), b.ravel(), wgt

    srcs, dsts, wgts = [], [], []
    for off in ((0, 1), (1, 0), (1, 1), (1, -1)):  # 8-connectivity
        a, b, wgt = edges_for(*off)
        srcs.append(a)
        dsts.append(b)
        wgts.append(wgt)
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    wgt = np.concatenate(wgts)
    order = np.argsort(wgt, kind="stable")

    uf = _UnionFind(h * w)
    ksplit = float(k)
    find, size, internal = uf.find, uf.size, uf.internal
    for e in order:
        a, b = find(int(src[e]), ), find(int(dst[e]))
        if a == b:
            continue
        we = float(wgt[e])
        if we <= min(internal[a] + ksplit / size[a],
                     internal[b] + ksplit / size[b]):
            uf.union(a, b, we)

    # min-size post-merge: join any component pair below min_size
    for e in order:
        a, b = find(int(src[e])), find(int(dst[e]))
        if a != b and (size[a] < min_size or size[b] < min_size):
            uf.union(a, b, float(wgt[e]))

    roots = np.fromiter((find(i) for i in range(h * w)), np.int64, h * w)
    _, labels = np.unique(roots, return_inverse=True)
    return labels.reshape(h, w).astype(np.int32)


def felzenszwalb_proposals(rgb: np.ndarray, scale: int = 4, sigma: float = 0.2,
                           k: float = 50.0, min_size: int = 50) -> np.ndarray:
    """Proposal masks: segment at 1/scale resolution (bilinear downscale),
    nearest-upsample the labels back, one binary mask per label but the
    first. Returns [N, H, W] uint8."""
    h, w = rgb.shape[:2]
    small = resize_linear(rgb, (h // scale, w // scale))
    labels = felzenszwalb(small, sigma=sigma, k=k, min_size=min_size)
    labels = resize_nearest(labels.astype(np.int32), (h, w))
    uniq = np.unique(labels)
    return np.asarray([(labels == i) for i in uniq[1:]], dtype=np.uint8)

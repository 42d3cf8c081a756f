"""Perlin-style depth distortion (sensor-noise simulation).

Port of quber_tpu/data/perlin.py: smooth noise fields from bicubically
upsampled random lattices (ops/imgproc.resize_cubic for OpenCV's
INTER_CUBIC) warp the depth map as a flow field (ops/imgproc.remap_nearest
for cv2.remap INTER_NEAREST with a replicated border) and add to it. The
draws come from the caller's RandomState in the reference's order.
"""

from __future__ import annotations

import numpy as np

from quber_tpu_torch.ops.imgproc import remap_nearest, resize_cubic


def value_noise(rng, h: int, w: int, res: int = 8) -> np.ndarray:
    """Smooth noise in [-1, 1] from a (res + 1) x (res + 1) lattice."""
    lattice = rng.rand(res + 1, res + 1).astype(np.float32) * 2 - 1
    return resize_cubic(lattice, (h, w))


def perlin_distortion(depth: np.ndarray, rng=None, warp_scale: float = 20.0,
                      noise_scale: float = 10.0, res: int = 8) -> np.ndarray:
    """Warp and additively perturb a depth map [H, W] (mm or normalised);
    zero (invalid) pixels stay zero."""
    rng = rng or np.random.RandomState(0)
    h, w = depth.shape[:2]
    flow_x = value_noise(rng, h, w, res) * warp_scale
    flow_y = value_noise(rng, h, w, res) * warp_scale
    ys, xs = np.mgrid[:h, :w].astype(np.float32)
    warped = remap_nearest(depth.astype(np.float32), xs + flow_x, ys + flow_y)
    noise = value_noise(rng, h, w, res * 2) * noise_scale
    out = warped + noise
    out[depth == 0] = 0
    return out.astype(depth.dtype)

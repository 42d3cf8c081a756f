"""The detector's box operations and multi-scale deformable attention of the
port against the JAX package (quber_tpu/ops/boxes.py, deform_attn.py).

Inputs come from numpy seeds. Tolerances: nms_fixed's keep exactly (score
ties, IoUs a few thousandths from the threshold, with and without max_out);
anchors, box deltas and FPN levels within 1e-6 (levels exactly); ROI-align,
single level with stride and learned offsets and multi-level, within 1e-5
on features of unit scale (XLA rounds the sample positions in their last
bits otherwise); deformable attention within 1e-5 in float32, samples in
and out of range on 3 levels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quber_tpu.ops import boxes as JB
from quber_tpu.ops.deform_attn import ms_deform_attn as jax_ms_deform_attn
from quber_tpu_torch.ops import boxes as TB
from quber_tpu_torch.ops.deform_attn import ms_deform_attn


def _boxes(rng, n, h=480, w=640):
    xy = rng.rand(n, 2) * [w - 40, h - 40]
    wh = rng.rand(n, 2) * 120 + 4
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


def _near_threshold(rng, n, thr):
    """n pairs of boxes whose IoU is within a few thousandths of `thr` on
    either side: a square and a copy shifted along x."""
    out = []
    for _ in range(n):
        x, y, s = rng.rand() * 400, rng.rand() * 300, 20 + rng.rand() * 80
        target = thr + rng.choice([-1, 1]) * (0.002 + 0.003 * rng.rand())
        # IoU of a shift d: (s - d) / (s + d)  ->  d = s (1 - t) / (1 + t)
        d = s * (1 - target) / (1 + target)
        out += [[x, y, x + s, y + s], [x + d, y, x + d + s, y + s]]
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("thr", [0.5, 0.7])
@pytest.mark.parametrize("max_out", [None, 7])
@pytest.mark.parametrize("seed", [0, 1])
def test_nms_fixed_keep_equals_jax(thr, max_out, seed):
    rng = np.random.RandomState(seed)
    boxes = np.concatenate([_boxes(rng, 60), _near_threshold(rng, 20, thr)])
    boxes = np.concatenate([boxes, boxes[:10] + 1.0])  # near-duplicates
    scores = np.round(rng.rand(len(boxes)) * 8) / 8  # many ties
    scores = scores.astype(np.float32)
    iou = np.asarray(JB.box_iou(jnp.asarray(boxes), jnp.asarray(boxes)))
    assert np.sum(np.abs(iou - thr) < 0.01) >= 20  # the pairs sit at the threshold
    want = np.asarray(JB.nms_fixed(jnp.asarray(boxes), jnp.asarray(scores), thr, max_out))
    got = TB.nms_fixed(torch.from_numpy(boxes), torch.from_numpy(scores), thr, max_out)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < len(boxes)


def test_nms_fixed_infinite_scores_and_empty_boxes():
    rng = np.random.RandomState(3)
    boxes = _boxes(rng, 30)
    boxes[5] = boxes[6] = 0.0  # empty boxes overlap nothing
    scores = rng.rand(30).astype(np.float32)
    scores[[2, 9, 11]] = -np.inf
    want = np.asarray(JB.nms_fixed(jnp.asarray(boxes), jnp.asarray(scores), 0.3))
    got = TB.nms_fixed(torch.from_numpy(boxes), torch.from_numpy(scores), 0.3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_box_area_and_iou():
    rng = np.random.RandomState(4)
    a, b = _boxes(rng, 12), _boxes(rng, 9)
    a[0] = [5, 5, 3, 9]  # negative width
    np.testing.assert_allclose(TB.box_area(torch.from_numpy(a)).numpy(),
                               np.asarray(JB.box_area(jnp.asarray(a))), rtol=1e-6)
    np.testing.assert_allclose(TB.box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(JB.box_iou(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("offset", [0.5, 0.0])
@pytest.mark.parametrize("stride,sizes", [(4, (16,)), (16, (32, 64, 128))])
def test_generate_anchors(offset, stride, sizes):
    want = np.asarray(JB.generate_anchors(7, 9, stride, sizes=sizes, offset=offset))
    got = TB.generate_anchors(7, 9, stride, sizes=sizes, offset=offset).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("weights,clamp,clip", [
    (None, 4.0, None), (None, 4.0, (480, 640)), ((10.0, 10.0, 5.0, 5.0), 4.135166556742356,
                                                 (800, 1088))])
def test_apply_deltas(weights, clamp, clip):
    rng = np.random.RandomState(5)
    boxes = _boxes(rng, 50)
    deltas = (rng.randn(50, 4) * 3).astype(np.float32)  # some past the clamp
    want = np.asarray(JB.apply_deltas(jnp.asarray(boxes), jnp.asarray(deltas), clip_hw=clip,
                                      weights=weights, scale_clamp=clamp))
    got = TB.apply_deltas(torch.from_numpy(boxes), torch.from_numpy(deltas), clip_hw=clip,
                          weights=weights, scale_clamp=clamp).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_boxes_to_deltas_and_fpn_levels():
    rng = np.random.RandomState(6)
    anchors, targets = _boxes(rng, 40), _boxes(rng, 40)
    targets[3] = [10, 10, 10, 30]  # zero width
    want = np.asarray(JB.boxes_to_deltas(jnp.asarray(anchors), jnp.asarray(targets)))
    got = TB.boxes_to_deltas(torch.from_numpy(anchors), torch.from_numpy(targets)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    sizes = np.concatenate([_boxes(rng, 40), np.asarray([[0, 0, 900, 900], [0, 0, 2, 2]],
                                                         np.float32)])
    np.testing.assert_array_equal(TB.assign_fpn_levels(torch.from_numpy(sizes)).numpy(),
                                  np.asarray(JB.assign_fpn_levels(jnp.asarray(sizes))))


@pytest.mark.parametrize("stride,with_offsets", [(1, False), (4, True), (8, False)])
def test_roi_align_stride_and_offsets(stride, with_offsets):
    rng = np.random.RandomState(7)
    feat = rng.rand(60, 80, 5).astype(np.float32)  # [H, W, C] at `stride`
    boxes = np.concatenate([_boxes(rng, 6, 60 * stride, 80 * stride),
                            np.asarray([[-20, -10, 40, 30]], np.float32)])  # off the map
    offsets = (rng.randn(len(boxes), 7, 7, 2) * 0.3).astype(np.float32) if with_offsets else None
    want = np.asarray(JB.roi_align(jnp.asarray(feat), jnp.asarray(boxes), out_size=7,
                                   stride=stride,
                                   offsets=None if offsets is None else jnp.asarray(offsets)))
    got = TB.roi_align(torch.from_numpy(feat).permute(2, 0, 1), torch.from_numpy(boxes),
                       out_size=7, stride=stride,
                       offsets=None if offsets is None else torch.from_numpy(offsets))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-5)


def test_roi_align_multilevel():
    rng = np.random.RandomState(8)
    strides = {"p2": 4, "p3": 8, "p4": 16, "p5": 32}
    feats = {k: rng.rand(480 // s, 640 // s, 6).astype(np.float32) for k, s in strides.items()}
    boxes = np.concatenate([_boxes(rng, 20), np.asarray(
        [[0, 0, 600, 470], [3, 3, 9, 8], [40, 30, 240, 230], [100, 50, 400, 350]], np.float32)])
    want = np.asarray(JB.roi_align_multilevel({k: jnp.asarray(v) for k, v in feats.items()},
                                              jnp.asarray(boxes), 14, strides))
    got = TB.roi_align_multilevel({k: torch.from_numpy(v).permute(2, 0, 1)
                                   for k, v in feats.items()}, torch.from_numpy(boxes), 14,
                                  strides)
    levels = TB.assign_fpn_levels(torch.from_numpy(boxes)).numpy()
    assert set(levels.tolist()) == {2, 3, 4, 5}  # several levels are read
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-5)


@pytest.mark.parametrize("spread", [(0.0, 1.0), (-0.3, 1.3)], ids=["in-range", "out-of-range"])
def test_ms_deform_attn(spread):
    rng = np.random.RandomState(9)
    shapes = ((12, 16), (6, 8), (3, 4))
    s = sum(h * w for h, w in shapes)
    b, q, nh, d, nl, np_ = 2, 11, 4, 8, 3, 4
    value = rng.randn(b, s, nh, d).astype(np.float32)
    lo, hi = spread
    locs = (lo + rng.rand(b, q, nh, nl, np_, 2) * (hi - lo)).astype(np.float32)
    att = rng.rand(b, q, nh, nl, np_).astype(np.float32)
    att /= att.sum(axis=(3, 4), keepdims=True)
    want = np.asarray(jax_ms_deform_attn(jnp.asarray(value), shapes, jnp.asarray(locs),
                                         jnp.asarray(att)))
    got = ms_deform_attn(torch.from_numpy(value), shapes, torch.from_numpy(locs),
                         torch.from_numpy(att)).numpy()
    assert got.shape == (b, q, nh * d)
    np.testing.assert_allclose(got, want, atol=1e-5)
    if lo < 0:
        assert ((locs < 0) | (locs > 1)).any()

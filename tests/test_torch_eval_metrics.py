"""The port's OpenCV-free metrics against the JAX package's (cv2.findContours
RETR_EXTERNAL + drawContours, cv2.dilate): boundary maps equal on every
mask, every metric key equal (floats within 1e-12)."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from scipy import ndimage

from quber_tpu.evaluation import metrics as jm
from quber_tpu_torch.data.perturb import perturb_masks
from quber_tpu_torch.data.synthetic import render_scene
from quber_tpu_torch.evaluation import metrics as tm


def _masks(kind, rng, n):
    out = []
    for _ in range(n):
        h, w = rng.randint(1, 48), rng.randint(1, 48)
        ys, xs = np.mgrid[:h, :w]
        if kind == "random":
            m = rng.rand(h, w) < rng.uniform(0.05, 0.95)
        elif kind == "noise":  # speckle on a blob: islands, diagonal touches
            m = ((ys - h / 2) ** 2 + (xs - w / 2) ** 2 < (min(h, w) / 2.5) ** 2)
            m ^= rng.rand(h, w) < 0.15
        elif kind == "holes":  # rings with islands inside their holes
            cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(2, 24)
            d2 = (ys - cy) ** 2 + (xs - cx) ** 2
            m = (d2 < r * r) & ~(d2 < (r / 2) ** 2) | (d2 < (r / 6) ** 2)
            m |= ndimage.binary_opening(rng.rand(h, w) < 0.5) & (d2 > (1.2 * r) ** 2)
        elif kind == "thin":  # 1-pixel objects and 1-pixel-wide lines
            m = np.zeros((h, w), bool)
            m[rng.randint(h), :] = True
            m[:, rng.randint(w)] = True
            m[rng.randint(h), rng.randint(w)] = True
            m[ys == (xs * rng.randint(1, 3)) % max(h, 1)] |= rng.rand() < 0.5
        else:  # touching the image border
            m = np.zeros((h, w), bool)
            m[: rng.randint(1, h + 1), : rng.randint(1, w + 1)] = True
            m[rng.randint(h):, rng.randint(w):] ^= True
        out.append(m)
    return out


@pytest.mark.parametrize("kind", ["random", "noise", "holes", "thin", "border"])
def test_seg2bmap_matches_find_contours(kind):
    rng = np.random.RandomState(len(kind))
    masks = _masks(kind, rng, 120)  # 600 masks over the five kinds
    for i, m in enumerate(masks):
        assert np.array_equal(tm.seg2bmap(m), jm.seg2bmap(m)), (kind, i)


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 30), st.integers(1, 30), st.integers(0, 2**31 - 1),
       st.floats(0.05, 0.95))
def test_seg2bmap_matches_find_contours_hypothesis(h, w, seed, p):
    m = np.random.RandomState(seed).rand(h, w) < p
    assert np.array_equal(tm.seg2bmap(m), jm.seg2bmap(m))


def test_boundary_overlap_matches():
    rng = np.random.RandomState(2)
    for _ in range(20):
        a = ndimage.binary_opening(rng.rand(96, 128) < 0.55)
        b = ndimage.binary_opening(rng.rand(96, 128) < 0.55)
        for th in (0.003, 2):
            assert tm.boundary_overlap(a, b, th) == jm.boundary_overlap(a, b, th)


def _assert_same(got, want):
    assert list(got) == list(want)
    for k, v in want.items():
        if v is None:
            assert got[k] is None, k
        else:
            assert abs(got[k] - v) <= 1e-12, (k, got[k], v)


@pytest.mark.parametrize("seed", range(4))
def test_multilabel_metrics_match_on_rendered_scenes(seed):
    rng = np.random.RandomState(seed)
    _, _, masks = render_scene(rng, 240, 320)
    gt = np.zeros((240, 320), np.int32)
    for i, m in enumerate(masks):
        gt[m > 0] = i + 1
    pred = np.zeros_like(gt)
    for i, m in enumerate(perturb_masks(masks, rng, target_iou=(0.6, 0.9))):
        pred[m > 0] = 3 * i + 2  # label values need not be consecutive
    _assert_same(tm.multilabel_metrics(pred, gt), jm.multilabel_metrics(pred, gt))
    _assert_same(tm.multilabel_metrics(pred, gt, compute_boundary_stuff=False),
                 jm.multilabel_metrics(pred, gt, compute_boundary_stuff=False))


@pytest.mark.parametrize("seed", range(3))
def test_multilabel_metrics_match_on_random_labels(seed):
    rng = np.random.RandomState(10 + seed)
    gt = ndimage.zoom(rng.randint(0, 6, (12, 16)), 8, order=0)
    pred = ndimage.zoom(rng.randint(0, 7, (24, 32)), 4, order=0)
    pred[rng.rand(*pred.shape) < 0.01] = 9  # speckle: tiny instances
    _assert_same(tm.multilabel_metrics(pred, gt), jm.multilabel_metrics(pred, gt))


@pytest.mark.parametrize("case", ["no_pred", "no_gt", "both_empty", "one_each"])
def test_multilabel_metrics_edge_cases(case):
    gt = np.zeros((32, 48), np.int32)
    pred = np.zeros_like(gt)
    if case in ("no_pred", "one_each"):
        gt[4:20, 5:30] = 1
    if case in ("no_gt", "one_each"):
        pred[8:24, 10:40] = 4
    _assert_same(tm.multilabel_metrics(pred, gt), jm.multilabel_metrics(pred, gt))

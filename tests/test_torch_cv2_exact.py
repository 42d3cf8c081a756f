"""The port's copies of two OpenCV drawing and resizing paths, pixel for
pixel against cv2 (the card's machine has no OpenCV):
  * data/perturb.fill_ellipse = cv2.ellipse(mask, center, axes, angle, 0,
    360, 1, -1), over 2000 seeded draws of random_blob's distribution and of
    ellipses that cross the image's border, at any angle;
  * ops/preprocess.resize_linear = cv2.resize(..., INTER_LINEAR) on uint8,
    1 and 3 channels: upscales, 2x (INTER_AREA) and 3x downscales,
    non-integer ratios and odd sizes.
Tolerance 0 everywhere.
"""

import cv2
import numpy as np
import pytest

from quber_tpu_torch.data.perturb import fill_ellipse, random_blob
from quber_tpu_torch.ops.preprocess import resize_linear

SIZES = [(480, 640), (240, 320), (64, 96), (37, 53)]


def _draws(seed, n):
    """random_blob's centres and axes, and every 5th draw an ellipse of any
    size whose centre may lie off the image."""
    rng = np.random.RandomState(seed)
    for i in range(n):
        h, w = SIZES[i % len(SIZES)]
        cy, cx = rng.randint(h // 8, 7 * h // 8), rng.randint(w // 8, 7 * w // 8)
        a = max(8, int(np.sqrt(0.02 * h * w) * rng.uniform(0.5, 1.5)))
        b = max(8, int(a * rng.uniform(0.4, 1.0)))
        if i % 5 == 4:
            a, b = rng.randint(1, 200), rng.randint(1, 200)
            cx, cy = rng.randint(-50, w + 50), rng.randint(-50, h + 50)
        angle = rng.uniform(0, 180) if i % 3 else rng.uniform(-400, 400)
        yield h, w, (int(cx), int(cy)), (int(a), int(b)), angle


@pytest.mark.parametrize("seed", [0, 1])
def test_fill_ellipse_equals_cv2(seed):
    n = 1000
    for h, w, center, axes, angle in _draws(seed, n):
        want = np.zeros((h, w), np.uint8)
        cv2.ellipse(want, center, axes, angle, 0, 360, 1, -1)
        got = fill_ellipse(h, w, center, axes, angle)
        assert np.array_equal(got, want), (h, w, center, axes, angle)


def test_random_blob_equals_the_cv2_version():
    from quber_tpu.data.perturb import random_blob as jax_random_blob

    for seed in range(40):
        h, w = SIZES[seed % 2]
        got = random_blob(np.random.RandomState(seed), h, w)
        want = jax_random_blob(np.random.RandomState(seed), h, w)
        assert got.dtype == want.dtype and np.array_equal(got, want)


RESIZES = [
    ((48, 64), (96, 128)), ((37, 53), (100, 131)), ((7, 9), (480, 640)),    # up
    ((96, 128), (48, 64)), ((122, 94), (61, 47)), ((480, 640), (240, 320)),  # 2x
    ((90, 120), (30, 40)), ((99, 33), (33, 11)),                            # 3x
    ((480, 640), (360, 480)), ((479, 641), (480, 640)), ((101, 77), (64, 50)),
    ((33, 47), (97, 103)), ((5, 300), (17, 4)), ((1, 9), (3, 2)),
]


@pytest.mark.parametrize("src,dst", RESIZES)
@pytest.mark.parametrize("channels", [1, 3])
def test_resize_linear_equals_cv2(src, dst, channels):
    rng = np.random.RandomState(src[0] * 7 + dst[1])
    shape = src if channels == 1 else src + (3,)
    ys, xs = np.mgrid[:src[0], :src[1]]
    smooth = 128 + 100 * np.sin(ys / 3.0) * np.cos(xs / 4.0)
    if channels == 3:
        smooth = smooth[..., None] + np.array([0, 20, -20])
    for img in (rng.randint(0, 256, shape).astype(np.uint8),
                np.clip(smooth, 0, 255).astype(np.uint8)):
        want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
        got = resize_linear(img, dst)
        assert got.dtype == np.uint8 and np.array_equal(got, want)


def test_initial_stage_of_the_16_frame_anchor_equals_jax(tmp_path):
    """The first 16 frames of the synthetic-OSD anchor, perturbed GT scored
    as the initial stage: every mean equals the JAX package's
    (quber_tpu_torch/evaluation/reference_synth_osd16.json), difference 0."""
    import json
    import os

    from quber_tpu_torch.data.make_synthetic_dataset import main as make_dataset
    from quber_tpu_torch.evaluation.harness import run_eval

    with open(os.path.join(os.path.dirname(__file__), "..", "quber_tpu_torch", "evaluation",
                           "reference_synth_osd16.json")) as f:
        reference = json.load(f)
    root = str(tmp_path / "osd")
    make_dataset(["--out", root, "--n", "16", "--seed", "1000", "--depth-range", "250", "1500"])
    got = run_eval(base_model="perturbed-gt", refiner_model="identity", test_dataset="OSD",
                   dataset_path=root, csv_path=str(tmp_path / "x.csv"), device="cpu")
    assert {k: got["initial"][k] for k in reference["initial"]} == reference["initial"]

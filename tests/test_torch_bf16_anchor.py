"""bfloat16 at full size: frames 1 and 6 of the synthetic-OSD anchor through
the JAX package's and the port's predictors, in float32 and in bfloat16,
with the in-repo int8 weights, on the CPU.

bfloat16 moves some anchor frames off float32 where an instance sits on a
knife edge, and each bf16 forward moves its own few: on frame 1 the JAX
package's bf16 splits an object in two (7 instances against 6, each half
scoring ~0; 0.777 of the labels agree with float32) and the port's bf16 on
the CPU does not; on frame 6 all four runs give 5 instances (the card's bf16
moved it in one run). Tolerances: float32 counts equal and >= 99.9% of the
labels; a bf16 count equal to one that JAX gives on that frame (float32 or
bf16), and >= 99.9% of the labels equal to that run's.

The JAX package's own bfloat16 error on these frames (mean |bf16 - float32|
of each output) is recorded in quber_tpu_torch/evaluation/
reference_synth_osd16.json, where chip_smoke.py reads it to hold the card's
bfloat16 forward; the test recomputes it, within 5% (XLA's CPU kernels may
round otherwise in another version), and holds the port's CPU error to the
card's band: 0.5-2 times it on every output.
"""

import json
import os

import numpy as np
import pytest
import torch

from quber_tpu.models.mask_refiner import MaskRefinerConfig as JConfig
from quber_tpu.predictor import MaskRefinerPredictor as JPredictor
from quber_tpu_torch.data.make_synthetic_dataset import main as make_dataset
from quber_tpu_torch.evaluation.base_models import PerturbedGT
from quber_tpu_torch.models.mask_refiner import MaskRefinerConfig as TConfig
from quber_tpu_torch.ops.preprocess import load_rgbd
from quber_tpu_torch.predictor import MaskRefinerPredictor as TPredictor
from quber_tpu_torch.train.checkpoint import load_default_params

torch.set_num_threads(2)

FRAMES = (1, 6)
OUTPUTS = ("sem_seg", "center", "offset", "eee_mask", "eee_boundary")
AGREEMENT = 0.999
ERR_LOW, ERR_HIGH = 0.5, 2.0  # chip_smoke.py's BF16_ERR_LOW / BF16_ERR_HIGH
REFERENCE = os.path.join(os.path.dirname(__file__), "..", "quber_tpu_torch", "evaluation",
                         "reference_synth_osd16.json")


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """predict_raw of the anchor's frames 1 and 6: JAX and port, float32 and
    bfloat16, as numpy arrays."""
    root = str(tmp_path_factory.mktemp("anchor") / "osd")
    make_dataset(["--out", root, "--n", str(max(FRAMES)), "--seed", "1000",
                  "--depth-range", "250", "1500"])
    names = sorted(os.listdir(os.path.join(root, "image_color")))
    params = load_default_params()
    predictors = {}
    for dtype in ("float32", "bfloat16"):
        predictors["jax", dtype] = JPredictor(JConfig(dtype=dtype), params)
        predictors["port", dtype] = TPredictor(TConfig(dtype=dtype), params, device="cpu")
    out = {}
    for frame in FRAMES:
        rgb_path = os.path.join(root, "image_color", names[frame - 1])
        depth_path = os.path.join(root, "disparity", names[frame - 1])
        masks = list(PerturbedGT("OSD").predict(rgb_path, depth_path)[0])
        rgb, depth, _ = load_rgbd(rgb_path, depth_path, (480, 640))
        for key, predictor in predictors.items():
            raw = predictor.predict_raw(rgb, depth, masks)
            out[(frame,) + key] = {k: np.asarray(v) for k, v in raw.items()}
    return out


@pytest.mark.parametrize("frame", FRAMES)
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_anchor_frame_counts_match_jax(outputs, dtype, frame):
    got = outputs[frame, "port", dtype]
    sides = [outputs[frame, "jax", dtype]]
    if dtype == "bfloat16":
        sides.append(outputs[frame, "jax", "float32"])
    matches = [int(got["num_instances"]) == int(s["num_instances"])
               and (got["panoptic_seg"] == s["panoptic_seg"]).mean() >= AGREEMENT
               for s in sides]
    assert any(matches), [(int(s["num_instances"]), (got["panoptic_seg"] == s["panoptic_seg"])
                           .mean()) for s in sides]


def test_frame_1_is_a_knife_edge_and_frame_6_is_not(outputs):
    """What the moved-frame gate of chip_smoke.py rests on: the JAX package's
    bf16 splits frame 1, and no CPU run moves frame 6."""
    count = {k: int(v["num_instances"]) for k, v in outputs.items()}
    assert (count[1, "jax", "float32"], count[1, "jax", "bfloat16"]) == (6, 7)
    assert {count[6, f, d] for f in ("jax", "port") for d in ("float32", "bfloat16")} == {5}


@pytest.mark.parametrize("frame", FRAMES)
def test_bf16_error_on_the_anchor_frame_as_recorded(outputs, frame):
    with open(REFERENCE) as f:
        recorded = json.load(f)["bfloat16_mean_abs_err"][str(frame)]
    ref = outputs[frame, "jax", "float32"]
    for k in OUTPUTS:
        jax_err = float(np.abs(outputs[frame, "jax", "bfloat16"][k] - ref[k]).mean())
        port_err = float(np.abs(outputs[frame, "port", "bfloat16"][k] - ref[k]).mean())
        assert jax_err == pytest.approx(recorded[k], rel=0.05), (k, jax_err)
        assert ERR_LOW * jax_err <= port_err <= ERR_HIGH * jax_err, (k, port_err, jax_err)

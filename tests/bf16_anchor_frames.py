"""Which anchor frames bfloat16 moves off float32, on the CPU.

    JAX_PLATFORMS=cpu python tests/bf16_anchor_frames.py [--frames 16]

Not a test (pytest does not collect it; ~3 min and ~3.5 GB at full size):
the first frames of the synthetic-OSD anchor protocol through the JAX
package's and the port's predictors, float32 and bfloat16, with the in-repo
int8 weights. Prints per frame each run's instance count and the share of
its panoptic labels equal to the JAX float32 run's, and the frames each bf16
run moves (another count, or < 99.9% of the labels), the readings behind
chip_smoke.py's BF16_MOVED_FRAMES.
"""

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

AGREEMENT = 0.999


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--frames", type=int, default=16)
    args = parser.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    from quber_tpu.models.mask_refiner import MaskRefinerConfig as JConfig
    from quber_tpu.predictor import MaskRefinerPredictor as JPredictor
    from quber_tpu_torch.data.make_synthetic_dataset import main as make_dataset
    from quber_tpu_torch.evaluation.base_models import PerturbedGT
    from quber_tpu_torch.models.mask_refiner import MaskRefinerConfig as TConfig
    from quber_tpu_torch.ops.preprocess import load_rgbd
    from quber_tpu_torch.predictor import MaskRefinerPredictor as TPredictor
    from quber_tpu_torch.train.checkpoint import load_default_params

    torch.set_num_threads(4)
    params = load_default_params()
    runs = {}
    for dtype in ("float32", "bfloat16"):
        runs[f"jax {dtype}"] = JPredictor(JConfig(dtype=dtype), params)
        runs[f"port {dtype}"] = TPredictor(TConfig(dtype=dtype), params, device="cpu")
    moved = {name: [] for name in runs}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "osd")
        make_dataset(["--out", root, "--n", str(args.frames), "--seed", "1000",
                      "--depth-range", "250", "1500"])
        names = sorted(os.listdir(os.path.join(root, "image_color")))
        for i, name in enumerate(names, 1):
            rgb_path = os.path.join(root, "image_color", name)
            depth_path = os.path.join(root, "disparity", name)
            masks = list(PerturbedGT("OSD").predict(rgb_path, depth_path)[0])
            rgb, depth, _ = load_rgbd(rgb_path, depth_path, (480, 640))
            out = {k: p.predict_raw(rgb, depth, masks) for k, p in runs.items()}
            ref = out["jax float32"]
            line = []
            for k, o in out.items():
                count = int(o["num_instances"])
                agree = float((np.asarray(o["panoptic_seg"]) == np.asarray(ref["panoptic_seg"]))
                              .mean())
                if count != int(ref["num_instances"]) or agree < AGREEMENT:
                    moved[k].append(i)
                line.append(f"{k} {count} ({agree:.6f})")
            print(f"frame {i}: " + ", ".join(line), flush=True)
    for k, frames in moved.items():
        print(f"{k}: moves frames {frames} ({len(frames)} of {args.frames})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Batch visualisation demo of the PyTorch/CUDA port.

    python3 demo_torch.py --input "imgs/*.png" --output vis/ \
        [--depth-dir depths/] [--base-model gt|empty|...] [--weights ckpt]

Counterpart of demo.py for quber_tpu_torch, with its flags and printed
lines: walks a folder of colour (and depth) images, runs a base segmenter
(evaluation/base_models.build_base_model, OSD layout) and streams the frames
through MaskRefinerPredictor.predict_batch_stream (a producer thread reads
and uploads batches while the card refines the previous one), then writes
each frame beside its refined map. Frames are read and resized as
predict_torch.py reads them. Runs on the GPU unless --device cpu, and exits
with code 2 without one. Needs no OpenCV, imageio or Pillow.
"""

import argparse
import glob
import os
import sys


def colorize(label, seed=1):
    import numpy as np

    rng = np.random.RandomState(seed)
    colors = rng.randint(0, 255, (int(label.max()) + 1, 3), np.uint8)
    colors[0] = 0
    return colors[label]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--input", required=True, help="glob of RGB images")
    parser.add_argument("--output", default="./demo_vis")
    parser.add_argument("--depth-dir", default=None)
    parser.add_argument("--config-file",
                        default="configs/mask_refiner_rgbd_concat_l2_gn_hf_m_b_f_c_o_l3_e2_b8.yaml")
    parser.add_argument("--weights", default=None)
    parser.add_argument("--base-model", default="empty")
    parser.add_argument("--batch-size", type=int, default=4)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cpu is for tests")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("demo_torch: no CUDA device (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return 2

    from quber_tpu_torch.config import load_config
    from quber_tpu_torch.data import png
    from quber_tpu_torch.evaluation.base_models import build_base_model
    from quber_tpu_torch.ops.preprocess import load_rgbd, resize_linear
    from quber_tpu_torch.predictor import MaskRefinerPredictor
    from quber_tpu_torch.train.checkpoint import load_default_params

    model_cfg, _ = load_config(args.config_file)
    predictor = MaskRefinerPredictor(model_cfg, load_default_params(args.weights),
                                     device=args.device)
    base = build_base_model(args.base_model, "OSD")
    os.makedirs(args.output, exist_ok=True)

    paths = sorted(glob.glob(args.input))
    size = (model_cfg.height, model_cfg.width)

    def frames():
        for p in paths:
            depth_path = (os.path.join(args.depth_dir, os.path.basename(p))
                          if args.depth_dir else None)
            if depth_path and os.path.exists(depth_path):
                rgb, depth, _ = load_rgbd(p, depth_path, size)
            else:
                rgb = resize_linear(png.imread(p, bgr=True), size)
                depth = np.zeros(size + (3,), np.uint8)
            masks, _, _ = base.predict(p, depth_path or "")
            yield rgb, depth, list(masks)

    results = predictor.predict_batch_stream(frames(), batch_size=args.batch_size)
    for path, (pan, count, _scores) in zip(paths, results):
        rgb = resize_linear(png.imread(path, bgr=True), size)
        overlay = (0.5 * rgb + 0.5 * colorize(pan)).astype(np.uint8)
        canvas = np.concatenate([rgb, overlay], axis=1)
        out = os.path.join(args.output, os.path.basename(path))
        png.imwrite(out, np.ascontiguousarray(canvas[..., ::-1]))  # BGR -> RGB file
        print(f"{os.path.basename(path)}: {count} instances -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

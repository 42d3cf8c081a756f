"""Single-image refinement entry point of the PyTorch/CUDA port.

    python3 predict_torch.py --rgb img.png --depth depth.png --masks masks.npy \
        [--config-file ...] [--weights weights.npz|ckpt_dir] [--out vis.png]

Counterpart of predict.py for quber_tpu_torch, with its flags and printed
lines. masks.npy: [N, H, W] (bool or uint8) initial instance masks. The
colour frame is read in BGR order and resized bilinearly to the model's
size, the depth (millimetres, 16-bit PNG) normalised, resized to the
nearest pixel and Telea-inpainted, the masks resized to the nearest pixel,
all as OpenCV does it; the refined map is drawn over the frame and written
to --out. Weights: --weights (an int8 .npz or a checkpoint directory of
train_net_torch.py), else $QUBER_WEIGHTS, else the in-repo int8 archive.
Runs on the GPU unless --device cpu, and exits with code 2 without one.
Needs no OpenCV, imageio or Pillow.
"""

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--rgb", required=True)
    parser.add_argument("--depth", default=None)
    parser.add_argument("--masks", required=True)
    parser.add_argument("--config-file",
                        default="configs/mask_refiner_rgbd_concat_l2_gn_hf_m_b_f_c_o_l3_e2_b8.yaml")
    parser.add_argument("--weights", default=None)
    parser.add_argument("--out", default="refined.png")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cpu is for tests")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("predict_torch: no CUDA device (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return 2

    from quber_tpu_torch.config import load_config
    from quber_tpu_torch.data import png
    from quber_tpu_torch.ops.preprocess import load_rgbd, resize_linear, resize_nearest
    from quber_tpu_torch.predictor import MaskRefinerPredictor
    from quber_tpu_torch.train.checkpoint import load_default_params

    model_cfg, _ = load_config(args.config_file)
    predictor = MaskRefinerPredictor(model_cfg, load_default_params(args.weights),
                                     device=args.device)
    size = (model_cfg.height, model_cfg.width)
    if args.depth:
        rgb, depth, _ = load_rgbd(args.rgb, args.depth, size)
    else:
        rgb = resize_linear(png.imread(args.rgb, bgr=True), size)
        depth = np.zeros(size + (3,), np.uint8)
    masks = [resize_nearest(m.astype(np.uint8), size) for m in np.load(args.masks) > 0]

    out = predictor.predict(rgb, depth, masks)[0]
    pan = out["panoptic_seg"][0]
    scores = out["instances"]["scores"] if "instances" in out else np.zeros(0, np.float32)
    count = len(scores)
    print(f"refined {len(masks)} -> {count} instances; scores: {np.round(scores, 3)}")

    rng = np.random.RandomState(1)
    colors = rng.randint(0, 255, (count + 1, 3), np.uint8)
    colors[0] = 0
    overlay = (0.5 * rgb + 0.5 * colors[pan]).astype(np.uint8)
    png.imwrite(args.out, np.ascontiguousarray(overlay[..., ::-1]))  # BGR -> RGB file
    print(f"visualization saved to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Foreground-segmenter training of the PyTorch/CUDA port (CGNet / LMFFNet).

    python3 train_fg_torch.py --model cgnet --dataset-path datasets/synth_osd \
        --max-iter 1500 --output-dir output/fg_cgnet

Counterpart of tools/train_fg.py with the same flags, draws and samples:
per sample the BGR colour resized bilinearly, the depth normalised (mm ->
0..255 x 3), nearest-resized and Telea-inpainted, the annotation
nearest-resized, a horizontal flip drawn from np.random.default_rng(seed)
(after the epoch's permutation from the same generator), ImageNet
standardisation; CGNet takes 4 channels at 320x240 and 2 classes, LMFFNet 6
channels at 640x480 and 3 classes (objects are class 2). Class-balanced
weighted cross-entropy and RAdam (train/fg_train.py). The part of a sample
before the flip depends on its file only, so it is computed once per file
and kept (it changes no sample). Checkpoints are the flax-layout
{"params", "batch_stats"} tree of the net (models/from_jax.state_dict_to_jax)
written by train/checkpoint.save_params under <output-dir>/ckpt, which the
evaluation's foreground filter loads:

    QUBER_CGNET_CKPT=output/fg_cgnet/ckpt python3 run_eval_torch.py --use-cgnet ...

Trains on any OSD-layout dataset (image_color/ disparity/ annotation/), e.g.
the scenes written by python3 -m quber_tpu_torch.data.make_synthetic_dataset.
Runs on the GPU unless --device cpu.
"""

import argparse
import glob
import os
import sys
import time


def list_samples(root):
    out = []
    for r in sorted(glob.glob(os.path.join(root, "image_color", "*.png"))):
        name = os.path.basename(r)
        d = os.path.join(root, "disparity", name)
        a = os.path.join(root, "annotation", name)
        if os.path.exists(d) and os.path.exists(a):
            out.append((r, d, a))
    return out


def model_size(model: str) -> tuple[int, int]:
    """(h, w) of the net's input."""
    return (240, 320) if model == "cgnet" else (480, 640)


def read_sample(paths, model):
    """The deterministic part of a sample: (BGR uint8 [h, w, 3], normalised
    and inpainted depth uint8 [h, w, 3], annotation [h, w]) at the net's size."""
    import numpy as np

    from quber_tpu_torch.data.datasets import read_image
    from quber_tpu_torch.ops.preprocess import (inpaint_depth, normalize_depth, resize_linear,
                                                resize_nearest)

    rgb_path, depth_path, anno_path = paths
    size = model_size(model)
    rgb = resize_linear(read_image(rgb_path, bgr=True), size)
    depth = inpaint_depth(resize_nearest(normalize_depth(np.asarray(read_image(depth_path))),
                                         size))
    anno = resize_nearest(np.asarray(read_image(anno_path)), size)
    return rgb, depth, anno


def assemble(rgb, depth, anno, model, rng):
    """Flip (one draw from rng) and channel assembly -> (x [h, w, C] float32,
    y [h, w] int32)."""
    import numpy as np

    from quber_tpu_torch.ops.preprocess import standardize_image

    if rng.random() < 0.5:
        rgb, depth, anno = rgb[:, ::-1], depth[:, ::-1], anno[:, ::-1]
    if model == "cgnet":
        x = np.concatenate([standardize_image(rgb), depth[:, :, 0:1].astype(np.float32) / 255.0],
                           axis=-1)
        y = (anno > 0).astype(np.int32)
    else:
        x = np.concatenate([standardize_image(rgb), depth.astype(np.float32) / 255.0], axis=-1)
        y = np.where(anno > 0, 2, 0).astype(np.int32)
    return x.astype(np.float32), y


class SampleCache:
    """load_sample of tools/train_fg.py with read_sample kept per file."""

    def __init__(self, model):
        self.model, self._kept = model, {}

    def __call__(self, paths, rng):
        if paths not in self._kept:
            self._kept[paths] = read_sample(paths, self.model)
        return assemble(*self._kept[paths], self.model, rng)


def build_model(model):
    if model == "cgnet":
        from quber_tpu_torch.models.cgnet import CGNet

        return CGNet(classes=2, in_channels=4)
    from quber_tpu_torch.models.lmffnet import LMFFNet

    return LMFFNet(classes=3)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--model", choices=["cgnet", "lmffnet"], default="lmffnet")
    parser.add_argument("--dataset-path", default="datasets/synth_osd")
    parser.add_argument("--max-iter", type=int, default=2000)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--log-period", type=int, default=50)
    parser.add_argument("--checkpoint-period", type=int, default=500)
    parser.add_argument("--output-dir", default=None)
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from quber_tpu_torch.models.from_jax import state_dict_to_jax
    from quber_tpu_torch.train.checkpoint import save_params
    from quber_tpu_torch.train.fg_train import create_fg_train_state, fg_train_step

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("train_fg_torch: no CUDA device (pass --device cpu to train on the CPU)",
                  file=sys.stderr)
            return 2
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    out_dir = args.output_dir or f"output/fg_{args.model}"
    ckpt_dir = os.path.abspath(os.path.join(out_dir, "ckpt"))
    os.makedirs(ckpt_dir, exist_ok=True)
    samples = list_samples(args.dataset_path)
    if not samples:
        print(f"train_fg_torch: no OSD-layout samples under {args.dataset_path}",
              file=sys.stderr)
        return 2
    print(f"{len(samples)} samples; model={args.model}; device {device}")

    state = create_fg_train_state(build_model(args.model), lr=args.lr, seed=args.seed,
                                  device=device)
    load = SampleCache(args.model)
    rng = np.random.default_rng(args.seed)
    order = rng.permutation(len(samples))
    cursor = 0
    t0 = time.time()
    host_s = 0.0
    t_steady = None
    for it in range(1, args.max_iter + 1):
        t_host = time.perf_counter()
        xs, ys = [], []
        for _ in range(args.batch):
            if cursor >= len(order):
                order = rng.permutation(len(samples))
                cursor = 0
            x, y = load(samples[order[cursor]], rng)
            cursor += 1
            xs.append(x)
            ys.append(y)
        images = torch.from_numpy(np.stack(xs)).to(device).permute(0, 3, 1, 2)
        labels = torch.from_numpy(np.stack(ys)).to(device)
        if t_steady is not None:
            host_s += time.perf_counter() - t_host
        metrics = fg_train_step(state, images, labels)
        if it == 1:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t_steady = time.perf_counter()
        if it % args.log_period == 0 or it == args.max_iter:
            loss = float(metrics["loss"])
            rate = it / (time.time() - t0)
            print(f"iter {it}/{args.max_iter} loss={loss:.4f} ({rate:.2f} it/s)", flush=True)
        if it % args.checkpoint_period == 0 or it == args.max_iter:
            save_params(ckpt_dir, state_dict_to_jax(state.model), step=it)
            print(f"checkpoint saved at {it}", flush=True)
    if args.max_iter > 1:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        steps = args.max_iter - 1
        print(f"[timing] steps={steps} s_per_step={(time.perf_counter() - t_steady) / steps:.4f} "
              f"host_s_per_step={host_s / steps:.4f} (after the first step; checkpoints "
              f"included)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

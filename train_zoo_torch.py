#!/usr/bin/env python3
"""Base-segmenter training of the PyTorch/CUDA port on rendered synthetic
scenes (one GPU).

    python3 train_zoo_torch.py --model ucn --max-iter 2000 --output-dir output/ucn_synth
    python3 train_zoo_torch.py --model msmformer --max-iter 2000 --output-dir output/msmformer_synth
    python3 train_zoo_torch.py --model uoaisnet --size 192 --max-iter 3000 --output-dir output/uoaisnet_synth

Counterpart of tools/train_zoo.py for quber_tpu_torch, with its flags,
defaults and recipes. Each renders --size scenes from --seed, takes one
scene a step in the order of numpy's default_rng(seed) permutations and
Adam at --lr over every variable:
  * ucn: standardised RGB, the XYZ point cloud (the OSD intrinsics) and
    compact instance labels, staged on the device once; the prototype
    metric loss over 13 clusters; the BatchNorm statistics are trained too
    (the reference's step takes its gradient over the whole variable tree);
  * msmformer: the same scenes; a bfloat16 MSMFormer (the evaluation
    wrapper's) and the Hungarian set loss against the instance masks taken
    every 4th pixel (the mask logits' stride);
  * uoaisnet: the raw RGB (0-255), the normalised depth x3 and the amodal
    and visible masks of up to 12 objects with their amodal boxes, staged
    on the device once; a float32 UOAIS-Net with FrozenBN, the ground-truth
    boxes spliced into the proposals, the detector's losses. The FrozenBN
    tensors are parameters of the reference's step and Adam moves them too.
Every --checkpoint-period steps the weights go to <output-dir>/ckpt in the
JAX package's variable layout (a save_params directory), and at the end
also to <output-dir>/<model>_int8.npz (the int8 archive the JAX package
reads). The evaluation harness takes either:

    QUBER_UCN_CKPT=output/ucn_synth/ckpt python3 run_eval_torch.py --base-model ucn ...
    QUBER_MSMFORMER_NATIVE_CKPT=output/msmformer_synth/ckpt ... --base-model msmformer
    QUBER_UOAISNET_CKPT=output/uoaisnet_synth/ckpt ... --base-model uoaisnet

Runs on the GPU unless --device cpu. The other models of tools/train_zoo.py
exit with a message naming their item in ROADMAP.md.
"""

import argparse
import os
import sys
import time

SLOTS = 12  # ground-truth instance slots (synthetic scenes have 3-8 objects)


def make_labeled_scenes(n, h, w, seed, depth_range):
    """Scenes for the pixel-labelling trainers: standardised RGB, the XYZ
    point cloud (the OSD intrinsics the evaluation wrappers use, centred),
    compact instance labels {0 = background, 1 + k = object k}, per-object
    XYZ centres and centre-offset targets, stacked over the scenes."""
    import numpy as np

    from quber_tpu_torch.data.synthetic import render_scene
    from quber_tpu_torch.ops.preprocess import compute_xyz, standardize_image

    cam = {"fx": 550.0, "fy": 550.0, "x_offset": w / 2.0, "y_offset": h / 2.0,
           "img_width": w, "img_height": h}
    rng = np.random.RandomState(seed)
    out = {k: [] for k in ("rgb", "xyz", "labels", "centers", "valid", "offsets")}
    for _ in range(n):
        rgb, depth_mm, vis = render_scene(rng, h, w, depth_range=depth_range)
        xyz = compute_xyz(depth_mm.astype(np.float32) / 1000.0, cam)
        labels = np.zeros((h, w), np.int32)
        centers = np.zeros((SLOTS, 3), np.float32)
        valid = np.zeros((SLOTS,), bool)
        offsets = np.zeros((h, w, 3), np.float32)
        for i in range(min(vis.shape[0], SLOTS)):
            m = vis[i] > 0
            if not m.any():
                continue
            labels[m] = 1 + i
            centers[i] = xyz[m].mean(axis=0)
            offsets[m] = centers[i] - xyz[m]
            valid[i] = True
        out["rgb"].append(standardize_image(rgb).astype(np.float32))
        out["xyz"].append(xyz.astype(np.float32))
        out["labels"].append(labels)
        out["centers"].append(centers)
        out["valid"].append(valid)
        out["offsets"].append(offsets)
    return {k: np.stack(v) for k, v in out.items()}


def make_scenes(n, h, w, seed, depth_range):
    """Scenes for the UOAIS-Net trainer, stacked: rgb float32 0-255 (the
    evaluation wrapper feeds the raw BGR; the rendered colours are
    channel-symmetric), depth normalised to the 0-255 x3 encoding, and per
    slot the amodal box, the visible and amodal masks and a validity flag."""
    import numpy as np

    from quber_tpu_torch.data.synthetic import render_scene
    from quber_tpu_torch.ops.preprocess import normalize_depth

    rng = np.random.RandomState(seed)
    out = {k: [] for k in ("rgb", "depth", "boxes", "vis", "amo", "valid")}
    for _ in range(n):
        rgb, depth_mm, vis, amo = render_scene(rng, h, w, depth_range=depth_range,
                                               return_amodal=True)
        boxes = np.zeros((SLOTS, 4), np.float32)
        gvis = np.zeros((SLOTS, h, w), np.float32)
        gamo = np.zeros((SLOTS, h, w), np.float32)
        valid = np.zeros((SLOTS,), bool)
        for i in range(min(vis.shape[0], SLOTS)):
            ys, xs = np.nonzero(amo[i])
            boxes[i] = (xs.min(), ys.min(), xs.max() + 1, ys.max() + 1)
            gvis[i], gamo[i], valid[i] = vis[i], amo[i], True
        out["rgb"].append(rgb.astype(np.float32))
        out["depth"].append(normalize_depth(depth_mm).astype(np.float32))
        out["boxes"].append(boxes)
        out["vis"].append(gvis)
        out["amo"].append(gamo)
        out["valid"].append(valid)
    return {k: np.stack(v) for k, v in out.items()}


# the pools' [n, H, W, 3] images; the mask stacks [n, SLOTS, H, W] stay as they are
IMAGE_KEYS = ("rgb", "xyz", "depth", "offsets")


def stage(pool, device):
    """The scene pool on `device`, once; the [n, H, W, C] images become
    [n, C, H, W]. A step then indexes it there."""
    import torch

    out = {}
    for k, v in pool.items():
        t = torch.from_numpy(v)
        if k in IMAGE_KEYS:
            t = t.permute(0, 3, 1, 2).contiguous()
        out[k] = t.to(device)
    return out


def fit_loop(step, n_scenes, args, save_fn):
    """The reference's driver: scenes in shuffled order (a new permutation
    from default_rng(seed) each pass), a log line every --log-period steps
    and a checkpoint every --checkpoint-period. `step(it, scene)` returns
    (total loss, parts) as tensors."""
    import numpy as np

    rng = np.random.default_rng(args.seed)
    order = rng.permutation(n_scenes)
    cursor = 0
    t0 = time.time()
    for it in range(1, args.max_iter + 1):
        if cursor >= len(order):
            order = rng.permutation(n_scenes)
            cursor = 0
        loss, parts = step(it, int(order[cursor]))
        cursor += 1
        if it % args.log_period == 0 or it == args.max_iter:
            detail = " ".join(f"{k}={float(v):.4f}" for k, v in sorted(parts.items()))
            print(f"iter {it}/{args.max_iter} total={float(loss):.4f} {detail} "
                  f"({it / (time.time() - t0):.2f} it/s)", flush=True)
        if it % args.checkpoint_period == 0 or it == args.max_iter:
            save_fn(it)
            print(f"checkpoint saved at {it}", flush=True)


def make_ucn_step(model, optimizer):
    """step(pool, scene) -> (loss, parts): one Adam update of `model` (a
    UCNEmbeddingNet in eval mode) on scene `scene` of a staged pool; the
    losses are those before the update, detached."""
    from quber_tpu_torch.models.ucn import prototype_metric_loss

    def step(pool, scene):
        emb = model(pool["rgb"][scene][None], pool["xyz"][scene][None])
        loss, parts = prototype_metric_loss(emb, pool["labels"][scene][None],
                                            max_instances=SLOTS + 1)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach(), {k: v.detach() for k, v in parts.items()}

    return step


def make_ucn(seed, lr, device):
    """A UCNEmbeddingNet initialised from `seed` on `device`, in eval mode,
    and Adam over all its parameters."""
    import torch

    from quber_tpu_torch.models.ucn import UCNEmbeddingNet

    model = UCNEmbeddingNet()
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model = model.to(device).eval()
    return model, torch.optim.Adam(model.parameters(), lr=lr)


def make_msmformer(seed, lr, device, dtype=None):
    """An MSMFormer initialised from `seed` on `device`, in bfloat16 (the
    evaluation wrapper's type) unless `dtype` says otherwise, and Adam over
    all its parameters."""
    import torch

    from quber_tpu_torch.models.msmformer import MSMFormer

    model = MSMFormer(dtype=dtype or torch.bfloat16)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model = model.to(device).eval()
    return model, torch.optim.Adam(model.parameters(), lr=lr)


def make_msmformer_step(model, optimizer):
    """step(pool, scene) -> (loss, parts): one Adam update of `model` on
    scene `scene` of a staged labelled pool, against its instance masks at
    the mask logits' stride 4."""
    import torch

    from quber_tpu_torch.models.msmformer import msmformer_set_loss

    def step(pool, scene):
        labels = pool["labels"][scene]
        ids = 1 + torch.arange(SLOTS, device=labels.device)
        gt = (labels[::4, ::4][None] == ids[:, None, None]).float()
        out = model(pool["rgb"][scene][None], pool["xyz"][scene][None])
        parts = msmformer_set_loss(out, gt[None], pool["valid"][scene][None])
        loss = sum(parts.values())
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach(), {k: v.detach() for k, v in parts.items()}

    return step


def make_uoaisnet(seed, lr, device):
    """A float32 UOAIS-Net with FrozenBN initialised from `seed` on
    `device`, its FrozenBN tensors made parameters (the reference's step
    differentiates and updates them), and Adam over all its parameters."""
    import torch
    from torch import nn

    from quber_tpu_torch.models.layers import FrozenBatchNorm
    from quber_tpu_torch.models.uoais_net import UOAISNet

    model = UOAISNet()
    model.reset_parameters(torch.Generator().manual_seed(seed))
    for mod in model.modules():
        if isinstance(mod, FrozenBatchNorm):
            for name in ("weight", "bias", "running_mean", "running_var"):
                t = getattr(mod, name)
                delattr(mod, name)
                mod.register_parameter(name, nn.Parameter(t))
    model = model.to(device).eval()
    return model, torch.optim.Adam(model.parameters(), lr=lr)


def make_uoaisnet_step(model, optimizer):
    """step(pool, scene) -> (loss, parts): one Adam update of `model` on
    scene `scene` of a staged make_scenes pool, the ground-truth boxes
    spliced into the proposals."""
    import torch

    from quber_tpu_torch.models.uoais_net import uoais_losses

    def step(pool, scene):
        boxes, valid = pool["boxes"][scene], pool["valid"][scene]
        out = model(pool["rgb"][scene][None], pool["depth"][scene][None],
                    gt_proposals=torch.where(valid[:, None], boxes, 0.0))
        parts = uoais_losses(out, boxes, pool["vis"][scene], pool["amo"][scene], valid)
        loss = sum(parts.values())
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach(), {k: v.detach() for k, v in parts.items()}

    return step


RECIPES = {
    # model: (scene maker, model maker, step maker)
    "ucn": (make_labeled_scenes, make_ucn, make_ucn_step),
    "msmformer": (make_labeled_scenes, make_msmformer, make_msmformer_step),
    "uoaisnet": (make_scenes, make_uoaisnet, make_uoaisnet_step),
}


def train(args, device):
    """The recipe of --model: render and stage the pool, train, save."""
    import torch

    from quber_tpu_torch.models.from_jax import state_dict_to_jax
    from quber_tpu_torch.train.checkpoint import save_params, save_quantized_params

    make_pool, make_model, make_step = RECIPES[args.model]
    scenes = make_pool(args.size, args.height, args.width, args.seed, tuple(args.depth_range))
    pool = stage(scenes, device)
    del scenes
    pool_mb = sum(t.numel() * t.element_size() for t in pool.values()) / 2**20
    print(f"scene pool on {device}: {pool_mb:.1f} MiB", flush=True)
    model, optimizer = make_model(args.seed, args.lr, device)
    train_step = make_step(model, optimizer)
    ckpt_dir = os.path.abspath(os.path.join(args.output_dir, "ckpt"))
    os.makedirs(ckpt_dir, exist_ok=True)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    timing = {"t0": time.time()}

    def step(it, scene):
        out = train_step(pool, scene)
        if it == 1:  # the first step carries cuDNN's set-up
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            print(f"[timing] first_step_s={time.time() - timing['t0']:.1f}", flush=True)
            timing["t1"] = time.time()
        return out

    fit_loop(step, args.size, args,
             lambda it: save_params(ckpt_dir, state_dict_to_jax(model), step=it))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        print(f"[memory] peak_gib={peak:.3f}", flush=True)
    if args.max_iter > 1:
        per_step = (time.time() - timing["t1"]) / (args.max_iter - 1)
        print(f"[timing] s_per_step={per_step:.4f} over steps 2-{args.max_iter} "
              "(checkpoints included)", flush=True)
    save_quantized_params(os.path.join(args.output_dir, f"{args.model}_int8.npz"),
                          state_dict_to_jax(model))


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--model",
                        choices=["uoaisnet", "uoisnet3d", "ucn", "msmformer",
                                 "rice", "cascadepsp", "samhq", "detic", "gsam"],
                        default="uoaisnet")
    parser.add_argument("--size", type=int, default=192, help="number of rendered scenes")
    parser.add_argument("--height", type=int, default=480)
    parser.add_argument("--width", type=int, default=640)
    parser.add_argument("--depth-range", type=float, nargs=2, default=(250, 1500))
    parser.add_argument("--max-iter", type=int, default=3000)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--log-period", type=int, default=50)
    parser.add_argument("--checkpoint-period", type=int, default=500)
    parser.add_argument("--output-dir", default="")
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--gms-sigma", type=float, default=0.02,
                        help="uoisnet3d: GBMS kernel bandwidth (not ported yet)")
    parser.add_argument("--gms-delta", type=float, default=0.1,
                        help="uoisnet3d: cluster-loss push margin (not ported yet)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cpu is for tests")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.model not in RECIPES:
        print(f"train_zoo_torch: --model {args.model} is not ported yet "
              "(ROADMAP.md Queue 1 item 14)", file=sys.stderr)
        return 2

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("train_zoo_torch: no CUDA device (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return 2
    device = torch.device(args.device)
    if device.type == "cuda":
        # float32 products, as the reference's
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    if not args.output_dir:
        args.output_dir = f"output/{args.model}_synth"
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {device} ({name}); rendering {args.size} scenes ...", flush=True)
    train(args, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

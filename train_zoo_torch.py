#!/usr/bin/env python3
"""Training of the zoo's base segmenters and refiner baselines in the
PyTorch/CUDA port on rendered synthetic scenes (one GPU).

    python3 train_zoo_torch.py --model ucn --max-iter 2000 --output-dir output/ucn_synth
    python3 train_zoo_torch.py --model msmformer --max-iter 2000 --output-dir output/msmformer_synth
    python3 train_zoo_torch.py --model uoaisnet --size 192 --max-iter 3000 --output-dir output/uoaisnet_synth
    python3 train_zoo_torch.py --model uoisnet3d --max-iter 2000 --output-dir output/uoisnet3d_synth
    python3 train_zoo_torch.py --model cascadepsp --size 256 --max-iter 2000 --output-dir output/cascadepsp_synth
    python3 train_zoo_torch.py --model rice --max-iter 1000 --output-dir output/rice_synth
    python3 train_zoo_torch.py --model samhq --max-iter 2000 --output-dir output/samhq_synth
    python3 train_zoo_torch.py --model detic --max-iter 2000 --output-dir output/detic_synth
    python3 train_zoo_torch.py --model gsam --max-iter 2000 --output-dir output/gsam_synth

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
    tensors are parameters of the reference's step and Adam moves them too;
  * uoisnet3d: the labelled scenes; a float32 DSN and RRN trained jointly,
    the DSN on the reference's full objective over the XYZ cloud (weighted
    foreground CE, offset smooth-L1, separation and mean-shift cluster
    losses, --gms-sigma / --gms-delta), the RRN on the weighted BCE of one
    random valid instance a step, its input mask left as it is, dilated 2
    or eroded 2 at random; the draws (the cluster loss's samples, the
    instance, the jitter) come from a torch.Generator seeded with --seed;
  * cascadepsp: a pool of --size 224x224 crops, a whole-frame and an ROI
    crop of up to three objects a scene with a boundary-perturbed input
    mask; batches of 4 (3 crops drawn by default_rng(seed + 1), then the
    step's own); a float32 PSPNetUOAIS with its BatchNorms in eval mode,
    their running statistics trained with the rest (the reference's step
    differentiates its whole variable tree); the cascade's side-output
    BCE and the final L1 / L2 / gradient losses;
  * rice: per scene the BGR + normalised-depth image and stacks of 16
    plausible (ground truth, boundary-jittered) and 16 implausible
    (fragments, merges, blobs, heavy corruption) masks; the NodeScorer on
    the crops hypothesis_node_crops makes for the search, ranked by
    node_scorer_loss;
  * samhq: SAM-normalised 256x256 frames and up to 4 objects a scene, each
    a boundary-perturbed mask prompt (* 20 - 10) and its target at stride
    4; a float32 SAMHQ at SAMHQ_SYNTH_ARCH from scratch, one encode and the
    4 mask-prompt decodes a step, focal + dice on the HQ mask, averaged
    over the valid slots; arch.json beside the checkpoint;
  * detic: the raw BGR frames (0-255, what the wrapper feeds) and up to 12
    objects a scene with their boxes, masks and colour classes (the hue
    bucket of the mean albedo, COLOR_VOCAB: the renderer has no semantic
    categories); the hash text tower over COLOR_VOCAB and a bfloat16
    DeticDetector trained jointly by one Adam, the ground-truth boxes
    spliced into the proposals, detic_losses. The FrozenBN tensors are
    parameters of the reference's step and Adam moves them too; vocab.json
    beside the checkpoint;
  * gsam: the detic pool plus, per scene, SAM's 256x256 normalised frame,
    the boxes scaled into it and the masks at 64x64 (OpenCV's float32
    bilinear); the grounder (the detic recipe with the one phrase "A rigid
    object.") and, interleaved, one step of a float32 SAMHQ at
    SAMHQ_SYNTH_ARCH a step on a scene drawn by numpy's
    default_rng(seed + 7): one encode, the valid boxes' decodes, focal +
    dice on the HQ masks. One tree {text, grounder, sam}, vocab.json and
    arch.json.
Every --checkpoint-period steps the weights go to <output-dir>/ckpt (uoisnet3d:
ckpt_dsn and ckpt_rrn) in the JAX package's variable layout (a save_params
directory), and at the end also to <output-dir>/<model>[_dsn|_rrn]_int8.npz
(the int8 archive the JAX package reads). The evaluation harness takes
either:

    QUBER_UCN_CKPT=output/ucn_synth/ckpt python3 run_eval_torch.py --base-model ucn ...
    QUBER_MSMFORMER_NATIVE_CKPT=output/msmformer_synth/ckpt ... --base-model msmformer
    QUBER_UOAISNET_CKPT=output/uoaisnet_synth/ckpt ... --base-model uoaisnet
    QUBER_UOIS3D_DSN_CKPT=output/uoisnet3d_synth/ckpt_dsn \
        QUBER_UOIS3D_RRN_CKPT=output/uoisnet3d_synth/ckpt_rrn ... --base-model uoisnet3d
    QUBER_CASCADEPSP_CKPT=output/cascadepsp_synth/ckpt ... --refiner-model cascadepsp
    QUBER_RICE_CKPT=output/rice_synth/ckpt ... --refiner-model rice
    QUBER_SAMHQ_CKPT=output/samhq_synth/ckpt ... --refiner-model hq-sam
    QUBER_DETIC_CKPT=output/detic_synth/ckpt ... --base-model detic
    QUBER_GSAM_CKPT=output/gsam_synth/ckpt ... --base-model grounded-sam

Runs on the GPU unless --device cpu.
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


def make_rice_scenes(n, h, w, seed, depth_range, slots=16):
    """The NodeScorer's scenes, stacked: image6 (BGR / 255 and the
    normalised depth / 255, as RICERefiner.predict encodes a frame), and
    `slots` plausible masks (the ground truth, then boundary-jittered copies
    that still denote their object) and `slots` implausible ones (halves of
    every object, merges of two, random blobs, then the corruption family's
    masks that match no object at IoU 0.5), each with a validity flag.
    Implausible masks matching an object at IoU 0.75 are left out."""
    import numpy as np

    from quber_tpu_torch.data.perturb import (
        mask_iou, modify_boundary, perturb_masks, random_blob, split_mask)
    from quber_tpu_torch.data.synthetic import render_scene
    from quber_tpu_torch.ops.preprocess import normalize_depth

    rng = np.random.RandomState(seed)
    out = {k: [] for k in ("image6", "good", "gvalid", "bad", "bvalid")}
    for _ in range(n):
        rgb, depth_mm, vis = render_scene(rng, h, w, depth_range=depth_range)
        image6 = np.concatenate([
            rgb[..., ::-1].astype(np.float32) / 255.0,
            normalize_depth(depth_mm.astype(np.float32), depth_range[0], depth_range[1]) / 255.0,
        ], axis=-1)
        gt = [m.astype(np.uint8) for m in vis if m.any()]
        good = np.zeros((slots, h, w), np.float32)
        gvalid = np.zeros((slots,), bool)
        i = 0
        for m in gt[:slots]:
            good[i], gvalid[i] = m, True
            i += 1
        for m in gt:
            if i >= slots:
                break
            jit = modify_boundary(m, rng, (0.55, 0.9))
            if jit.any() and mask_iou(jit, m) > 0.4:
                good[i], gvalid[i] = jit, True
                i += 1
        bad = np.zeros((slots, h, w), np.float32)
        bvalid = np.zeros((slots,), bool)
        j = 0

        def push_bad(m):
            nonlocal j
            if j < slots and m.any() and max((mask_iou(m, g) for g in gt), default=0.0) < 0.75:
                bad[j], bvalid[j] = m, True
                j += 1

        for m in gt:  # fragments
            for piece in split_mask(m, rng):
                push_bad(piece)
        if len(gt) >= 2:  # merges
            for _ in range(2):
                a, b = rng.choice(len(gt), 2, replace=False)
                push_bad(np.maximum(gt[a], gt[b]))
        for _ in range(2):  # hallucinated regions
            push_bad(random_blob(rng, h, w))
        for m in perturb_masks(np.asarray(gt), rng, target_iou=(0.3, 0.9)):
            if max((mask_iou(m, g) for g in gt), default=0.0) < 0.5:
                push_bad(m)
        out["image6"].append(image6.astype(np.float32))
        out["good"].append(good)
        out["gvalid"].append(gvalid)
        out["bad"].append(bad)
        out["bvalid"].append(bvalid)
    return {k: np.stack(v) for k, v in out.items()}


def make_refine_crops(n, h, w, seed, depth_range, crop=224, per_scene=3):
    """CascadePSP's crop pool: for up to `per_scene` objects of each scene
    (those of 64 pixels or more, shuffled), a whole-frame and an ROI crop
    (the box of the object and its boundary-perturbed mask, grown by a
    random 15-60% margin) resized to crop x crop: "rgbd" (ImageNet-normalised
    BGR and the normalised depth / 255), "seg" (the perturbed mask) and
    "tgt" (the object), until `n` crops."""
    import numpy as np

    from quber_tpu_torch.data.perturb import mask_iou, modify_boundary
    from quber_tpu_torch.data.synthetic import render_scene
    from quber_tpu_torch.models.cascadepsp import IMAGENET_MEAN, IMAGENET_STD
    from quber_tpu_torch.ops.preprocess import normalize_depth, resize_linear

    rng = np.random.RandomState(seed)
    out = {k: [] for k in ("rgbd", "seg", "tgt")}
    while len(out["rgbd"]) < n:
        rgb, depth_mm, vis = render_scene(rng, h, w, depth_range=depth_range)
        rgbn = (rgb[..., ::-1].astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
        depth = normalize_depth(depth_mm.astype(np.float32), depth_range[0],
                                depth_range[1])[..., :1] / 255.0
        rgbd = np.concatenate([rgbn, depth], axis=-1)
        objs = [m.astype(np.uint8) for m in vis if m.sum() >= 64]
        rng.shuffle(objs)
        for m in objs[:per_scene]:
            pert = modify_boundary(m, rng, (0.6, 0.95))
            if not pert.any() or mask_iou(pert, m) < 0.3:
                pert = m
            ys, xs = np.where(m + pert)
            y0, y1 = ys.min(), ys.max() + 1
            x0, x1 = xs.min(), xs.max() + 1
            mg = rng.uniform(0.15, 0.6)
            y0 = max(0, int(y0 - mg * (y1 - y0)))
            y1 = min(h, int(y1 + mg * (y1 - y0)))
            x0 = max(0, int(x0 - mg * (x1 - x0)))
            x1 = min(w, int(x1 + mg * (x1 - x0)))
            for view in ("global", "roi"):
                if len(out["rgbd"]) >= n:
                    break
                sl = (slice(None), slice(None)) if view == "global" else (
                    slice(y0, y1), slice(x0, x1))
                out["rgbd"].append(resize_linear(rgbd[sl], (crop, crop)))
                out["seg"].append(resize_linear(pert[sl].astype(np.float32), (crop, crop)))
                out["tgt"].append(resize_linear(m[sl].astype(np.float32), (crop, crop)))
    return {k: np.stack(v).astype(np.float32) for k, v in out.items()}


# the SAM-HQ recipe's architecture (a ViT from scratch: the reference
# fine-tunes a released ViT-H, which is not in the repository)
SAMHQ_SYNTH_ARCH = dict(img_size=256, embed_dim=256, depth=6, num_heads=8,
                        global_blocks=(2, 5), window_size=8)
SAMHQ_SLOTS = 4


def make_samhq_scenes(n, h, w, seed, depth_range, img_size=SAMHQ_SYNTH_ARCH["img_size"],
                      slots=SAMHQ_SLOTS):
    """The SAM-HQ pool, stacked: "img" the SAM-normalised RGB at img_size x
    img_size (float32, channel-last as SAMHQ takes it); per slot (up to
    `slots` objects of 64 pixels or more, shuffled) "prompt" the
    boundary-perturbed mask (the object itself if that leaves IoU < 0.3)
    resized to a quarter of img_size, * 20 - 10 (the wrapper's prompt
    encoding), "tgt" the object at that size and "valid". Resizes are
    OpenCV's float32 bilinear (resize_linear_f32)."""
    import numpy as np
    import torch

    from quber_tpu_torch.data.perturb import mask_iou, modify_boundary
    from quber_tpu_torch.data.synthetic import render_scene
    from quber_tpu_torch.models.sam_hq import SAM_PIXEL_MEAN, SAM_PIXEL_STD
    from quber_tpu_torch.ops.preprocess import resize_linear_f32

    def resize(x, size):
        return resize_linear_f32(torch.from_numpy(np.ascontiguousarray(x, np.float32)),
                                 (size, size)).numpy()

    s, q = img_size, img_size // 4
    rng = np.random.RandomState(seed)
    out = {k: [] for k in ("img", "prompt", "tgt", "valid")}
    for _ in range(n):
        rgb, _depth, vis = render_scene(rng, h, w, depth_range=depth_range)
        img = resize(rgb[..., ::-1].transpose(2, 0, 1), s).transpose(1, 2, 0)
        out["img"].append((img - SAM_PIXEL_MEAN) / SAM_PIXEL_STD)
        prompts = np.zeros((slots, q, q), np.float32)
        tgts = np.zeros((slots, q, q), np.float32)
        valid = np.zeros((slots,), bool)
        objs = [m.astype(np.uint8) for m in vis if m.sum() >= 64]
        rng.shuffle(objs)
        for i, m in enumerate(objs[:slots]):
            pert = modify_boundary(m, rng, (0.6, 0.95))
            if not pert.any() or mask_iou(pert, m) < 0.3:
                pert = m
            prompts[i] = resize(pert, q) * 20.0 - 10.0
            tgts[i] = resize(m, q)
            valid[i] = True
        out["prompt"].append(prompts)
        out["tgt"].append(tgts)
        out["valid"].append(valid)
    return {k: np.stack(v).astype(np.float32) if k != "valid" else np.stack(v)
            for k, v in out.items()}


# 60-degree hue buckets in spectral order (+30 offset centres red at 0)
COLOR_VOCAB = ["red object", "yellow object", "green object", "cyan object",
               "blue object", "magenta object", "gray object"]


def _color_class(rgb_mean):
    """The COLOR_VOCAB class of a mean RGB albedo: gray below saturation
    0.12, else its 60-degree hue bucket. The renderer has no semantic
    categories; colour is the one text-describable attribute every object
    carries."""
    import colorsys

    r, g, b = (float(x) / 255.0 for x in rgb_mean)
    h, s, _ = colorsys.rgb_to_hsv(r, g, b)
    if s < 0.12:
        return 6
    return int(((h * 360 + 30) % 360) // 60)


def make_detic_scenes(n, h, w, seed, depth_range, slots=SLOTS):
    """The open-vocabulary pool, stacked: "bgr" the raw BGR frame (float32
    0-255, what the wrapper feeds), and per slot (the objects of 64 pixels
    or more, in render order) "boxes", "classes" (_color_class), "masks"
    and "valid"."""
    import numpy as np

    from quber_tpu_torch.data.synthetic import render_scene

    rng = np.random.RandomState(seed)
    out = {k: [] for k in ("bgr", "boxes", "classes", "masks", "valid")}
    for _ in range(n):
        rgb, _depth, vis = render_scene(rng, h, w, depth_range=depth_range)
        boxes = np.zeros((slots, 4), np.float32)
        classes = np.zeros((slots,), np.int32)
        masks = np.zeros((slots, h, w), np.float32)
        valid = np.zeros((slots,), bool)
        for i, m in enumerate(vis[:slots]):
            m = m > 0
            if m.sum() < 64:
                continue
            ys, xs = np.where(m)
            boxes[i] = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
            classes[i] = _color_class(rgb[m].mean(axis=0))
            masks[i] = m
            valid[i] = True
        out["bgr"].append(rgb[..., ::-1].astype(np.float32))
        out["boxes"].append(boxes)
        out["classes"].append(classes)
        out["masks"].append(masks)
        out["valid"].append(valid)
    return {k: np.stack(v) for k, v in out.items()}


def make_gsam_scenes(n, h, w, seed, depth_range, img_size=SAMHQ_SYNTH_ARCH["img_size"]):
    """make_detic_scenes' pool and SAM's: "sam_img" the RGB resized to
    img_size x img_size (OpenCV's float32 bilinear) and SAM-normalised,
    channel-last; "sam_boxes" the boxes in that frame; "sam_tgt" the masks
    at a quarter of img_size (the same resize)."""
    import numpy as np
    import torch

    from quber_tpu_torch.models.sam_hq import SAM_PIXEL_MEAN, SAM_PIXEL_STD
    from quber_tpu_torch.ops.preprocess import resize_linear_f32

    def resize(x, size):
        return resize_linear_f32(torch.from_numpy(np.ascontiguousarray(x, np.float32)),
                                 (size, size)).numpy()

    pool = make_detic_scenes(n, h, w, seed, depth_range)
    s, q = img_size, img_size // 4
    scale = np.asarray([s / w, s / h, s / w, s / h], np.float32)
    img = [resize(bgr[..., ::-1].transpose(2, 0, 1), s).transpose(1, 2, 0) for bgr in pool["bgr"]]
    pool["sam_img"] = ((np.stack(img) - SAM_PIXEL_MEAN) / SAM_PIXEL_STD).astype(np.float32)
    pool["sam_boxes"] = pool["boxes"] * scale
    pool["sam_tgt"] = np.stack([resize(m, q) for m in pool["masks"]])
    return pool


# the pools' [n, H, W, C] images; the mask stacks [n, SLOTS, H, W] and SAM's
# channel-last frames stay as they are
IMAGE_KEYS = ("rgb", "xyz", "depth", "offsets", "image6", "rgbd", "bgr")


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


def train_frozen_bn(model):
    """Make every FrozenBN tensor of `model` a parameter: the reference's
    step differentiates its whole variable tree, FrozenBN's frozen_* leaves
    among the params, and Adam updates them."""
    from torch import nn

    from quber_tpu_torch.models.layers import FrozenBatchNorm

    for mod in model.modules():
        if isinstance(mod, FrozenBatchNorm):
            for name in ("weight", "bias", "running_mean", "running_var"):
                t = getattr(mod, name)
                delattr(mod, name)
                mod.register_parameter(name, nn.Parameter(t))
    return model


def make_uoaisnet(seed, lr, device):
    """A float32 UOAIS-Net with FrozenBN initialised from `seed` on
    `device`, its FrozenBN tensors made parameters, and Adam over all its
    parameters."""
    import torch

    from quber_tpu_torch.models.uoais_net import UOAISNet

    model = UOAISNet()
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model = train_frozen_bn(model).to(device).eval()
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


def make_uoisnet3d(seed, lr, device):
    """UOIS-Net-3D's float32 DSN and RRN (initialised from `seed` and
    `seed + 1`) in one module with attributes `dsn` and `rrn`, in eval mode,
    and one Adam over both."""
    import torch
    from torch import nn

    from quber_tpu_torch.models.uois_net import DepthSeedingNetwork, RegionRefinementNetwork

    model = nn.Module()
    model.dsn, model.rrn = DepthSeedingNetwork(), RegionRefinementNetwork()
    model.dsn.reset_parameters(torch.Generator().manual_seed(seed))
    model.rrn.reset_parameters(torch.Generator().manual_seed(seed + 1))
    model = model.to(device).eval()
    return model, torch.optim.Adam(model.parameters(), lr=lr)


def draw_uoisnet3d(labels, valid, generator):
    """One uoisnet3d step's draws from `generator`: the cluster loss's
    "samples" and "seeds" (models/uois_net.draw_cluster_indices, object
    label 1), the RRN's "inst" (a slot, uniform over the valid ones) and its
    "jitter" (0 none, 1 dilate 2, 2 erode 2, uniform)."""
    import torch

    from quber_tpu_torch.models.uois_net import draw_cluster_indices

    samples, seeds = draw_cluster_indices(labels, generator, object_label=1)
    dev = generator.device
    inst = int(torch.multinomial(valid.float().to(dev), 1, generator=generator))
    jitter = int(torch.randint(0, 3, (), generator=generator, device=dev))
    return {"samples": samples, "seeds": seeds, "inst": inst, "jitter": jitter}


def make_uoisnet3d_step(model, optimizer, sigma=0.02, delta=0.1, generator=None):
    """step(pool, scene, draws=None) -> (loss, parts): one Adam update of
    the DSN and the RRN on scene `scene` of a staged labelled pool, with the
    draws of draw_uoisnet3d (from `generator`, a torch.Generator on the
    model's device seeded 0 by default, unless the caller hands them
    over)."""
    import torch

    from quber_tpu_torch.models.uois_net import dsn_train_losses, rrn_loss
    from quber_tpu_torch.ops import morphology

    dev = next(model.parameters()).device
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)

    def step(pool, scene, draws=None):
        labels, valid = pool["labels"][scene], pool["valid"][scene]
        if draws is None:
            draws = draw_uoisnet3d(labels, valid, generator)
        gt_mask = (labels == 1 + draws["inst"]).float()
        perturbed = (gt_mask, morphology.dilate(gt_mask[None], 2)[0],
                     morphology.erode(gt_mask[None], 2)[0])[draws["jitter"]]
        xyz = pool["xyz"][scene]
        fg_logits, offsets = model.dsn(xyz[None])
        parts = dsn_train_losses(
            fg_logits[0].permute(1, 2, 0), offsets[0].permute(1, 2, 0), xyz.permute(1, 2, 0),
            pool["offsets"][scene].permute(1, 2, 0), labels, pool["centers"][scene], valid,
            draws["samples"], draws["seeds"], object_label=1, sigma=sigma, delta=delta)
        rin = torch.cat([pool["rgb"][scene], perturbed[None]])[None]
        parts["loss_rrn"] = rrn_loss(model.rrn(rin)[0, 0], gt_mask)
        loss = sum(parts.values())
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach(), {k: v.detach() for k, v in parts.items()}

    return step


def make_cascadepsp(seed, lr, device):
    """A float32 PSPNetUOAIS initialised from `seed` on `device`, its
    BatchNorms in eval mode with their running statistics made parameters
    (the reference's step differentiates and updates them), and Adam over
    all its parameters."""
    import torch
    from torch import nn

    from quber_tpu_torch.models.cascadepsp import PSPNetUOAIS
    from quber_tpu_torch.models.layers import BatchNorm

    model = PSPNetUOAIS()
    model.reset_parameters(torch.Generator().manual_seed(seed))
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            for name in ("running_mean", "running_var"):
                t = getattr(mod, name)
                delattr(mod, name)
                mod.register_parameter(name, nn.Parameter(t))
    model = model.to(device).eval()
    return model, torch.optim.Adam(model.parameters(), lr=lr)


CASCADEPSP_BATCH = 4


def make_cascadepsp_step(model, optimizer, size=None, seed=7):
    """step(pool, index, batch=None) -> (loss, parts): one Adam update of
    `model` on crops `batch` of a staged crop pool, by default 3 crops drawn
    from numpy's default_rng(seed + 1) over `size` crops, then `index`."""
    import numpy as np
    import torch

    from quber_tpu_torch.models.cascadepsp import cascadepsp_refine_loss

    rng = np.random.default_rng(seed + 1)

    def step(pool, index, batch=None):
        if batch is None:
            n = size or pool["seg"].shape[0]
            batch = rng.integers(0, n, CASCADEPSP_BATCH - 1).tolist() + [index]
        idx = torch.tensor(batch, device=pool["seg"].device)
        rgbd = pool["rgbd"][idx]
        seg = (pool["seg"][idx][:, None] - 0.5) / 0.5
        parts = cascadepsp_refine_loss(model(rgbd[:, :3], rgbd[:, 3:4], seg), pool["tgt"][idx])
        loss = sum(parts.values())
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach(), {k: v.detach() for k, v in parts.items()}

    return step


def make_rice(seed, lr, device):
    """RICE's NodeScorer initialised from `seed` on `device` and Adam over
    its parameters."""
    import torch

    from quber_tpu_torch.models.rice import NodeScorer

    model = NodeScorer()
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model = model.to(device).eval()
    return model, torch.optim.Adam(model.parameters(), lr=lr)


def make_rice_step(model, optimizer):
    """step(pool, scene) -> (loss, parts): one Adam update of the scorer on
    the plausible and implausible masks of scene `scene` of a staged
    make_rice_scenes pool, through the search's own crops."""
    import torch

    from quber_tpu_torch.models.rice import RICERefiner, hypothesis_node_crops, node_scorer_loss

    def step(pool, scene):
        image6 = pool["image6"][scene]
        with torch.no_grad():
            gc, g_ok = hypothesis_node_crops(image6, pool["good"][scene], pool["gvalid"][scene],
                                             crop=RICERefiner.CROP)
            bc, b_ok = hypothesis_node_crops(image6, pool["bad"][scene], pool["bvalid"][scene],
                                             crop=RICERefiner.CROP)
        parts = node_scorer_loss(model(gc), g_ok, model(bc), b_ok)
        loss = sum(parts.values())
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach(), {k: v.detach() for k, v in parts.items()}

    return step


def make_samhq(seed, lr, device):
    """A float32 SAMHQ at SAMHQ_SYNTH_ARCH initialised from `seed` on
    `device`, and Adam over all its parameters."""
    import torch

    from quber_tpu_torch.models.sam_hq import SAMHQ

    model = SAMHQ(**SAMHQ_SYNTH_ARCH)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model = model.to(device).eval()
    return model, torch.optim.Adam(model.parameters(), lr=lr)


def make_samhq_step(model, optimizer):
    """step(pool, scene) -> (loss, parts): one Adam update of the SAMHQ on
    scene `scene` of a staged make_samhq_scenes pool: one encode, the slots'
    mask-prompt decodes as one batch, each slot's focal + dice on its HQ
    mask, their mean over the valid slots."""
    import torch

    from quber_tpu_torch.models.sam_hq import sam_hq_mask_loss

    def step(pool, scene):
        embed, interm = model.encode(pool["img"][scene][None])
        masks, _, _ = model.decode(embed, interm, pool["prompt"][scene][..., None], False, True)
        tgt, ok = pool["tgt"][scene], pool["valid"][scene].float()
        per = torch.stack([sam_hq_mask_loss(masks[i], tgt[i][None]) for i in range(len(ok))])
        loss = (per * ok).sum() / ok.sum().clamp_min(1)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach(), {"focal_dice": loss.detach()}

    return step


def _open_vocab_model(seed, vocabulary, detector_key):
    """A ModuleDict {"text": the hash tower over `vocabulary`, `detector_key`:
    a DeticDetector in bfloat16, its FrozenBN
    tensors made parameters}, both initialised from one generator seeded
    `seed`, the vocabulary's token ids and mask as buffers (`text_ids`,
    `text_mask`, not saved)."""
    import torch
    from torch import nn

    from quber_tpu_torch.models.open_vocab import DeticDetector, TextEncoder, hash_tokenize

    generator = torch.Generator().manual_seed(seed)
    model = nn.ModuleDict({"text": TextEncoder(),
                           detector_key: DeticDetector(dtype=torch.bfloat16)})
    model["text"].reset_parameters(generator)
    model[detector_key].reset_parameters(generator)
    train_frozen_bn(model[detector_key])
    ids, mask = hash_tokenize(vocabulary)
    model.register_buffer("text_ids", torch.from_numpy(ids), persistent=False)
    model.register_buffer("text_mask", torch.from_numpy(mask), persistent=False)
    return model


def make_detic(seed, lr, device):
    """The detic recipe's model (_open_vocab_model over COLOR_VOCAB, the
    detector under "detector") on `device` in eval mode, and one Adam over
    every parameter."""
    import torch

    model = _open_vocab_model(seed, COLOR_VOCAB, "detector").to(device).eval()
    return model, torch.optim.Adam(model.parameters(), lr=lr)


def _detector_loss(model, pool, scene):
    """(total, parts) of detic_losses on scene `scene`, the text tower's
    embeddings and the detector's forward with the ground-truth boxes
    spliced into the proposals."""
    import torch

    from quber_tpu_torch.models.open_vocab import detic_losses

    detector = model["detector"] if "detector" in model else model["grounder"]
    embeds = model["text"](model.text_ids, model.text_mask)
    boxes, valid = pool["boxes"][scene], pool["valid"][scene]
    out = detector(pool["bgr"][scene][None], embeds,
                   gt_proposals=torch.where(valid[:, None], boxes, 0.0))
    parts = detic_losses(out, boxes, pool["classes"][scene], pool["masks"][scene], valid)
    return sum(parts.values()), parts


def make_detic_step(model, optimizer):
    """step(pool, scene) -> (loss, parts): one Adam update of the text tower
    and the detector on scene `scene` of a staged make_detic_scenes pool."""
    def step(pool, scene):
        loss, parts = _detector_loss(model, pool, scene)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach(), {k: v.detach() for k, v in parts.items()}

    return step


def make_gsam(seed, lr, device):
    """GroundedSAM's recipe model: _open_vocab_model over the reference's one
    phrase (GROUNDING_PROMPT), the detector under "grounder", plus "sam", a
    float32 SAMHQ at SAMHQ_SYNTH_ARCH initialised from `seed` +
    3, on `device` in eval mode; one Adam over every parameter (the
    reference's two Adams over disjoint parameters, each stepped once an
    iteration, update alike)."""
    import torch

    from quber_tpu_torch.models.open_vocab import GROUNDING_PROMPT
    from quber_tpu_torch.models.sam_hq import SAMHQ

    model = _open_vocab_model(seed, [GROUNDING_PROMPT], "grounder")
    model["sam"] = SAMHQ(**SAMHQ_SYNTH_ARCH)
    model["sam"].reset_parameters(torch.Generator().manual_seed(seed + 3))
    model = model.to(device).eval()
    return model, torch.optim.Adam(model.parameters(), lr=lr)


def make_gsam_step(model, optimizer, size=None, seed=7):
    """step(pool, scene, sam_scene=None) -> (loss, parts): the grounder's
    step on scene `scene` (its loss and parts) and SAM's on `sam_scene`,
    drawn from numpy's default_rng(seed + 7) over `size` scenes unless
    given (its loss as "sam_total"), then one Adam update of both."""
    import numpy as np
    import torch

    from quber_tpu_torch.models.sam_hq import sam_hq_mask_loss

    rng = np.random.default_rng(seed + 7)
    sam = model["sam"]

    def step(pool, scene, sam_scene=None):
        if sam_scene is None:
            sam_scene = int(rng.integers(0, size or pool["sam_img"].shape[0]))
        loss, parts = _detector_loss(model, pool, scene)
        embed, interm = sam.encode(pool["sam_img"][sam_scene][None])
        masks = sam.decode_box(embed, interm, pool["sam_boxes"][sam_scene], False, True)[0]
        tgt, ok = pool["sam_tgt"][sam_scene], pool["valid"][sam_scene].float()
        per = torch.stack([sam_hq_mask_loss(masks[i], tgt[i][None]) for i in range(len(ok))])
        sam_loss = (per * ok).sum() / ok.sum().clamp_min(1)
        optimizer.zero_grad(set_to_none=True)
        (loss + sam_loss).backward()
        optimizer.step()
        parts = dict(parts, sam_total=sam_loss)
        return loss.detach(), {k: v.detach() for k, v in parts.items()}

    return step


RECIPES = {
    # model: (scene maker, model maker, step maker)
    "ucn": (make_labeled_scenes, make_ucn, make_ucn_step),
    "msmformer": (make_labeled_scenes, make_msmformer, make_msmformer_step),
    "uoaisnet": (make_scenes, make_uoaisnet, make_uoaisnet_step),
    "uoisnet3d": (make_labeled_scenes, make_uoisnet3d, make_uoisnet3d_step),
    "cascadepsp": (make_refine_crops, make_cascadepsp, make_cascadepsp_step),
    "rice": (make_rice_scenes, make_rice, make_rice_step),
    "samhq": (make_samhq_scenes, make_samhq, make_samhq_step),
    "detic": (make_detic_scenes, make_detic, make_detic_step),
    "gsam": (make_gsam_scenes, make_gsam, make_gsam_step),
}


def step_options(args, device) -> dict:
    """The step maker's options that come from the command line."""
    import torch

    if args.model == "uoisnet3d":
        return {"sigma": args.gms_sigma, "delta": args.gms_delta,
                "generator": torch.Generator(device).manual_seed(args.seed)}
    if args.model in ("cascadepsp", "gsam"):
        return {"size": args.size, "seed": args.seed}
    return {}


def saved_modules(args, model) -> dict:
    """{checkpoint directory name: the module saved there}."""
    if args.model == "uoisnet3d":
        return {"ckpt_dsn": model.dsn, "ckpt_rrn": model.rrn}
    return {"ckpt": model}


def write_sidecars(args):
    """What the evaluation wrappers read beside the checkpoint directory:
    arch.json (samhq, gsam: the SAM architecture) and vocab.json (detic,
    gsam: the text tower's vocabulary)."""
    import json

    from quber_tpu_torch.models.open_vocab import GROUNDING_PROMPT

    files = {"samhq": {"arch.json": SAMHQ_SYNTH_ARCH},
             "detic": {"vocab.json": COLOR_VOCAB},
             "gsam": {"arch.json": SAMHQ_SYNTH_ARCH, "vocab.json": [GROUNDING_PROMPT]}}
    for name, content in files.get(args.model, {}).items():
        with open(os.path.join(args.output_dir, name), "w") as f:
            json.dump(content, f)


def jax_tree(module) -> dict:
    """The module's weights as train() saves them, in the JAX package's
    layout: its flax variable tree, or for a recipe of several parts (a
    ModuleDict: {text, detector}, {text, grounder, sam}) a tree of the
    parts' trees."""
    from torch import nn

    from quber_tpu_torch.models.from_jax import state_dict_to_jax

    if isinstance(module, nn.ModuleDict):
        return {k: state_dict_to_jax(m) for k, m in module.items()}
    return state_dict_to_jax(module)


def train(args, device):
    """The recipe of --model: render and stage the pool, train, save."""
    import torch

    from quber_tpu_torch.train.checkpoint import save_params, save_quantized_params

    make_pool, make_model, make_step = RECIPES[args.model]
    scenes = make_pool(args.size, args.height, args.width, args.seed, tuple(args.depth_range))
    pool = stage(scenes, device)
    del scenes
    pool_mb = sum(t.numel() * t.element_size() for t in pool.values()) / 2**20
    print(f"scene pool on {device}: {pool_mb:.1f} MiB", flush=True)
    model, optimizer = make_model(args.seed, args.lr, device)
    train_step = make_step(model, optimizer, **step_options(args, device))
    saved = {os.path.abspath(os.path.join(args.output_dir, name)): module
             for name, module in saved_modules(args, model).items()}
    for ckpt_dir in saved:
        os.makedirs(ckpt_dir, exist_ok=True)
    write_sidecars(args)
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

    def save(it):
        for ckpt_dir, module in saved.items():
            save_params(ckpt_dir, jax_tree(module), step=it)

    fit_loop(step, args.size, args, save)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        print(f"[memory] peak_gib={peak:.3f}", flush=True)
    if args.max_iter > 1:
        per_step = (time.time() - timing["t1"]) / (args.max_iter - 1)
        print(f"[timing] s_per_step={per_step:.4f} over steps 2-{args.max_iter} "
              "(checkpoints included)", flush=True)
    for ckpt_dir, module in saved.items():
        part = os.path.basename(ckpt_dir).removeprefix("ckpt")
        save_quantized_params(os.path.join(args.output_dir, f"{args.model}{part}_int8.npz"),
                              jax_tree(module))


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
                        help="uoisnet3d: GBMS kernel bandwidth (uois config)")
    parser.add_argument("--gms-delta", type=float, default=0.1,
                        help="uoisnet3d: cluster-loss push margin")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cpu is for tests")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

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

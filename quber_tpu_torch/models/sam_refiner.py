"""SAM / HQ-SAM for the evaluation harness: the mask-prompted refiner and
the automatic base segmenter.

Port of quber_tpu/models/sam_refiner.py. Both read a frame at 640x480
(BGR, as cv2.imread gives it; `sam-depth` the normalised, Telea-inpainted
depth of ops/preprocess.load_rgbd), resize it to the model's square input
with OpenCV's uint8 bilinear (`resize_linear`), normalise it with SAM's
pixel statistics, encode it once and decode a batch of prompts in one
call. The logits come back to 640x480 through OpenCV's float32 bilinear
(`resize_linear_f32`, on the card) and are thresholded at 0.

  * SAMHQRefiner: each initial mask (up to 16) becomes a mask prompt at a
    quarter of the input's side (nearest resize, * 20 - 10); the HQ mask
    (`hq`) or SAM's token-0 mask; empty masks are dropped. The reference
    decodes all 16 slots; the empty slots' masks are discarded, so only
    the valid prompts are decoded (the same output).
  * SAMAutomaticBaseModel: an 8x8 grid of positive points, one multimask
    decode each (the mask of the best of SAM's three tokens plus the HQ
    mask); then, on the host, a stable sort by predicted IoU, the IoU
    threshold, areas of 256 pixels or more and mask NMS at IoU 0.7 (the
    pairwise counts computed on the card).

The models compute in bfloat16, as the reference's wrappers do
(`layers.set_compute_dtype`); they run on `device`, "cuda" unless the
caller asks for the CPU. `seconds` of predict covers the wrapper's own
work: the input's upload, encode, decodes, resize and the masks' copy back.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from quber_tpu_torch.data import png
from quber_tpu_torch.models.from_jax import as_state_dict
from quber_tpu_torch.models.layers import set_compute_dtype
from quber_tpu_torch.models.sam_hq import SAM_PIXEL_MEAN, SAM_PIXEL_STD, SAMHQ
from quber_tpu_torch.ops.preprocess import load_rgbd, resize_linear, resize_linear_f32, resize_nearest

EVAL_H, EVAL_W = 480, 640


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _build(model: SAMHQ, params, seed: int, device) -> SAMHQ:
    """`model` with `params` (a state dict or a flax-layout tree), or a
    seeded init, in bfloat16 on `device`, in eval mode."""
    if params is None:
        model.reset_parameters(torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(as_state_dict(params), strict=True)
    set_compute_dtype(model, torch.bfloat16)
    return model.to(device).eval()


def sam_input(bgr: np.ndarray, size: int) -> np.ndarray:
    """640x480 BGR uint8 -> SAM's normalised RGB float32 [S, S, 3]."""
    img = resize_linear(np.ascontiguousarray(bgr[..., ::-1]), (size, size)).astype(np.float32)
    return (img - SAM_PIXEL_MEAN) / SAM_PIXEL_STD


def read_bgr(rgb_path: str) -> np.ndarray:
    """The frame at 640x480, BGR, as cv2.imread and cv2.resize give it."""
    return resize_linear(png.imread(rgb_path, bgr=True), (EVAL_H, EVAL_W))


class SAMHQRefiner:
    MAX_INSTANCES = 16

    def __init__(self, params=None, dataset="OSD", img_size=1024, seed=0, preset=None,
                 embed_dim=768, depth=12, num_heads=12, global_blocks=(2, 5, 8, 11),
                 window_size=14, hq=True, device="cuda"):
        if preset is not None:
            # "vit_h": the reference's fine-tuned HQ-SAM baseline is a ViT-H
            model = SAMHQ.preset(preset, img_size=img_size)
        else:
            model = SAMHQ(img_size=img_size, embed_dim=embed_dim, depth=depth,
                          num_heads=num_heads, global_blocks=global_blocks,
                          window_size=window_size)
        self.device = torch.device(device)
        self.model = _build(model, params, seed, self.device)
        self.img_size = img_size
        self.hq = hq
        self.dataset = dataset

    @torch.no_grad()
    def refine(self, image: torch.Tensor, prompts: torch.Tensor):
        """image [S, S, 3] normalised, prompts [n, S / 4, S / 4] on the
        model's device -> (logits [n, S / 4, S / 4], predicted IoU [n]): one
        encode, the n mask-prompt decodes as one batch."""
        embed, interm = self.model.encode(image[None])
        masks, iou, all_masks = self.model.decode(embed, interm, prompts[..., None], False,
                                                  self.hq)
        return (masks[:, 0] if self.hq else all_masks[:, 0]), iou[:, 0]

    def predict(self, rgb_path, depth_path, initial_masks, fg_mask):
        s, q = self.img_size, self.img_size // 4
        img = sam_input(read_bgr(rgb_path), s)
        count = min(len(initial_masks), self.MAX_INSTANCES)
        prompts = np.zeros((count, q, q), np.float32)
        for i in range(count):
            m = resize_nearest(np.asarray(initial_masks[i]).astype(np.uint8), (q, q))
            prompts[i] = m * 20.0 - 10.0

        t0 = time.perf_counter()
        refined = np.zeros((0, EVAL_H, EVAL_W), bool)
        if count:
            logits, _ = self.refine(torch.from_numpy(img).to(self.device),
                                    torch.from_numpy(prompts).to(self.device))
            masks = resize_linear_f32(logits, (EVAL_H, EVAL_W)) > 0
            masks = masks[masks.flatten(1).any(dim=1)].cpu().numpy()
            refined = masks if len(masks) else refined
        _sync(self.device)
        return refined, None, time.perf_counter() - t0, fg_mask


class SAMAutomaticBaseModel:
    """SAM's automatic mask generation as a base segmenter (the reference's
    SamAutomaticMaskGenerator wrapper)."""

    def __init__(self, params=None, dataset="OSD", img_size=512, grid=8, seed=0,
                 embed_dim=256, depth=4, num_heads=4, iou_threshold=0.5, dedup_iou=0.7,
                 depth_input=False, device="cuda"):
        self.device = torch.device(device)
        self.model = _build(SAMHQ(img_size=img_size, embed_dim=embed_dim, depth=depth,
                                  num_heads=num_heads), params, seed, self.device)
        self.img_size = img_size
        self.grid = grid
        self.dataset = dataset
        self.iou_threshold = iou_threshold
        self.dedup_iou = dedup_iou
        self.depth_input = depth_input
        # cell centres of a grid x grid lattice, (x, y), x fastest
        coords = (np.stack(np.meshgrid(np.arange(grid), np.arange(grid)), -1)
                  .reshape(-1, 2).astype(np.float32) + 0.5) / grid
        self.points = torch.from_numpy(coords).to(self.device)

    @torch.no_grad()
    def generate(self, image: torch.Tensor):
        """image [S, S, 3] normalised -> (logits [g*g, S / 4, S / 4], IoU
        [g*g]): one encode, one multimask point decode per grid point."""
        embed, interm = self.model.encode(image[None])
        n = self.points.shape[0]
        masks, iou, _ = self.model.decode_points(
            embed, interm, self.points[:, None, :] * self.img_size,
            torch.ones(n, 1, dtype=torch.int32, device=self.device), True)
        return masks[:, 0], iou[:, 0]

    def predict(self, rgb_path, depth_path):
        if self.depth_input:
            # "sam-depth": the normalised, inpainted depth in place of RGB
            frame = load_rgbd(rgb_path, depth_path, (EVAL_H, EVAL_W))[1]
        else:
            frame = read_bgr(rgb_path)
        img = sam_input(frame, self.img_size)

        t0 = time.perf_counter()
        logits, ious = self.generate(torch.from_numpy(img).to(self.device))
        ious_host = ious.cpu().numpy()
        order = [i for i in np.argsort(-ious_host, kind="stable")
                 if not ious_host[i] < self.iou_threshold]
        masks = np.zeros((0, EVAL_H, EVAL_W), bool)
        if order:
            cand = resize_linear_f32(logits[order], (EVAL_H, EVAL_W)) > 0
            flat = cand.flatten(1).float()
            inter = (flat @ flat.T).cpu().numpy().astype(np.int64)  # exact below 2^24
            area = np.diag(inter)
            kept: list[int] = []
            for i in range(len(order)):
                if area[i] < 256:
                    continue
                union = area[i] + area[kept] - inter[i, kept]
                if not np.any(inter[i, kept] / np.maximum(union, 1) > self.dedup_iou):
                    kept.append(i)
            if kept:
                masks = cand[kept].cpu().numpy()
        _sync(self.device)
        return masks, None, time.perf_counter() - t0

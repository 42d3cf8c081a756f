"""Refiner wrappers for the evaluation harness.

Port of quber_tpu/evaluation/refiner_models.py, with the interface

    predict(rgb_path, depth_path, initial_masks, fg_mask)
        -> (refined_masks [N, H, W] bool, raw_output | None, seconds, fg_mask)

QuBERRefiner reads the frame at 640x480 (colour in BGR order, as cv2.imread
gives it), normalises and Telea-inpaints the depth, refines it with the
port's MaskRefinerPredictor (one frame through `predict_raw`, whose
statistics, encode and group kernels run on the card; or batches through
`predict_batch_stream` and the batched kernels), keeps the instances that
overlap the foreground net's mask by more than 0.3 and, on OCID, zeroes the
pixels of zero depth. It runs on `device`, "cuda" unless the caller asks
for the CPU. Each QuBERRefiner adds its host and device seconds to
`seconds` ("read": read, normalise and inpaint; "refine"; "fg": the
foreground net, which reuses the frame read at 640x480 (LMFFNet) or reads
its own at 320x240 (CGNet)).

The zoo refiners: `cascadepsp` / `cascadepsp-rgbd` (models/cascadepsp,
weights from `params` or $QUBER_CASCADEPSP_CKPT, a random init without
either) and `rice` (models/rice, the NodeScorer from `params` or
$QUBER_RICE_CKPT, a random init without a checkpoint there; the search
$QUBER_RICE_SEARCH, greedy by default, or cem), and SAM (models/sam_refiner):
`sam` (SAM's token-0 mask) and `hq-sam` (the HQ mask) at ViT-B width and
1024x1024, `hq-sam-pretrained` the reference's ViT-H; a seeded random init
unless `params` are given. `hq-sam` with $QUBER_SAMHQ_CKPT (a checkpoint
directory of train_zoo_torch.py --model samhq) rebuilds the trained
architecture from the arch.json beside it.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict, deque

import numpy as np

from quber_tpu_torch.data import png
from quber_tpu_torch.evaluation.datasets import EVAL_H, EVAL_W
from quber_tpu_torch.ops.preprocess import load_rgbd, resize_linear, resize_nearest


class LoadNpyRefinerModel:
    """Replay pre-recorded refined masks (<npy_folder>/<frame>.npy)."""

    def __init__(self, npy_folder: str = "", dataset: str = "OSD"):
        self.npy_folder = npy_folder
        self.dataset = dataset

    def predict(self, rgb_path, depth_path, initial_masks, fg_mask):
        npy_path = os.path.join(
            self.npy_folder, os.path.basename(rgb_path).replace(".png", ".npy")
        )
        refined = np.load(npy_path) > 0
        if self.dataset == "OCID":
            refined &= (png.imread(depth_path) != 0)[None]
        return refined, None, 0.0, None


class IdentityRefiner:
    """Pass-through (refined == initial)."""

    def predict(self, rgb_path, depth_path, initial_masks, fg_mask):
        return np.asarray(initial_masks) > 0, None, 0.0, fg_mask


class QuBERRefiner:
    """The QuBER mask refiner + the LMFFNet (or CGNet) foreground filter."""

    def __init__(self, config=None, params=None, fg_params=None, dataset="OSD",
                 max_instances: int = 64, use_fg_filter: bool = True,
                 fg_model: str = "lmffnet", device="cuda"):
        from quber_tpu_torch.predictor import MaskRefinerPredictor

        self.predictor = MaskRefinerPredictor(config, params, max_instances, device=device)
        self.dataset = dataset
        self.seconds: dict = defaultdict(float)
        self.fg_predictor = None
        if use_fg_filter:
            if fg_model == "cgnet":
                from quber_tpu_torch.models.fg_predictor import CGNetPredictor as Fg
            else:
                from quber_tpu_torch.models.fg_predictor import LMFFNetPredictor as Fg
            self.fg_predictor = Fg(params=fg_params, device=device)

    def _load(self, rgb_path, depth_path):
        t0 = time.perf_counter()
        out = load_rgbd(rgb_path, depth_path, (EVAL_H, EVAL_W))
        self.seconds["read"] += time.perf_counter() - t0
        return out

    def _to_model_frame(self, rgb, depth_n, initial_masks):
        """Adapt a 640x480 frame to the model's configured size (a small test
        config refines at its own size; _pan_to_eval maps the panoptic map
        back)."""
        size = (self.predictor.config.height, self.predictor.config.width)
        if size == (EVAL_H, EVAL_W):
            return rgb, depth_n, initial_masks
        masks = [resize_nearest(np.asarray(m).astype(np.uint8), size) for m in initial_masks]
        return resize_linear(rgb, size), resize_nearest(depth_n, size), masks

    def _pan_to_eval(self, pan):
        if pan.shape == (EVAL_H, EVAL_W):
            return pan
        return resize_nearest(np.asarray(pan).astype(np.int32), (EVAL_H, EVAL_W))

    def predict(self, rgb_path, depth_path, initial_masks, fg_mask):
        rgb, depth_n, zero_depth = self._load(rgb_path, depth_path)
        rgb_m, depth_m, masks_m = self._to_model_frame(rgb, depth_n, initial_masks)

        start = time.perf_counter()
        raw = self.predictor.predict_raw(rgb_m, depth_m, masks_m)
        pan = self._pan_to_eval(raw["panoptic_seg"].cpu().numpy())
        count = int(raw["num_instances"])
        scores = raw["instance_scores"].cpu().numpy()
        self.seconds["refine"] += time.perf_counter() - start
        refined, fg = self._postprocess(pan, count, rgb_path, depth_path, zero_depth,
                                        (rgb, depth_n))
        elapsed = time.perf_counter() - start
        return refined, {"panoptic": pan, "scores": scores}, elapsed, fg

    def _postprocess(self, pan, count, rgb_path, depth_path, zero_depth, frame):
        """Masks from the panoptic map, the foreground-overlap filter and the
        OCID zero-depth zeroing. `frame` is the (BGR, depth) pair read at
        640x480: LMFFNet takes it as it is, CGNet reads its own 320x240."""
        refined = (
            pan[None] == np.arange(1, count + 1)[:, None, None]
            if count
            else np.zeros((0, EVAL_H, EVAL_W), bool)
        )
        fg = None
        if self.fg_predictor is not None:
            t0 = time.perf_counter()
            at_eval = self.fg_predictor.size == (EVAL_H, EVAL_W)
            fg = self.fg_predictor.predict(rgb_path, depth_path, frame if at_eval else None)
            self.seconds["fg"] += time.perf_counter() - t0
            keep = [
                m for m in refined
                if m.sum() and np.logical_and(m, fg).sum() / m.sum() > 0.3
            ]
            refined = (
                np.asarray(keep) if keep else np.zeros((0, EVAL_H, EVAL_W), bool)
            )
        if self.dataset == "OCID" and len(refined):
            zd = resize_nearest(zero_depth.astype(np.uint8), (EVAL_H, EVAL_W)).astype(bool)
            refined = refined & ~zd[None]
        return refined, fg

    def predict_stream(self, items, batch_size: int = 16):
        """Refine an iterable of (rgb_path, depth_path, initial_masks, fg_mask)
        items in batches through the predictor's streamed pipeline (a
        producer thread reads and uploads the frames; one launch of each
        batched kernel per batch); yields (refined_masks, output, fg) per
        item, in order. The foreground filter still runs frame by frame."""
        metas: deque = deque()  # filled by the stream's producer thread

        def frames():
            for rgb_path, depth_path, initial_masks, _fg in items:
                rgb, depth_n, zero_depth = self._load(rgb_path, depth_path)
                metas.append((rgb_path, depth_path, zero_depth, (rgb, depth_n)))
                yield self._to_model_frame(rgb, depth_n, initial_masks)

        for pan, count, scores in self.predictor.predict_batch_stream(
            frames(), batch_size=batch_size
        ):
            rgb_path, depth_path, zero_depth, frame = metas.popleft()
            pan = self._pan_to_eval(pan)
            refined, fg = self._postprocess(pan, count, rgb_path, depth_path, zero_depth, frame)
            yield refined, {"panoptic": pan, "scores": scores}, fg


def load_fg_params(path: str):
    """A foreground net's flax variable tree from an .npz (flattened
    "collection/scope/.../leaf" keys, int8-quantised or not) or a directory
    written by train.checkpoint.save_params."""
    from quber_tpu_torch.train.checkpoint import (load_quantized_params, restore_params)

    if path.endswith(".npz"):
        return load_quantized_params(path)
    try:
        return restore_params(path)
    except FileNotFoundError:
        raise NotImplementedError(
            f"{path}: the port reads foreground weights as .npz or as its own checkpoint "
            "directory; orbax checkpoints are not read (ROADMAP.md, Queue 1)") from None


def build_refiner_model(name: str, dataset: str, config=None, params=None,
                        npy_folder: str = "", device="cuda"):
    if name == "maskrefiner":
        fg_model = "lmffnet"
        fg_ckpt = os.environ.get("QUBER_LMFFNET_CKPT", "")
        if not fg_ckpt and os.environ.get("QUBER_CGNET_CKPT", ""):
            fg_model, fg_ckpt = "cgnet", os.environ["QUBER_CGNET_CKPT"]
        fg_params = load_fg_params(fg_ckpt) if fg_ckpt else None
        return QuBERRefiner(config, params, fg_params=fg_params, dataset=dataset,
                            fg_model=fg_model, device=device)
    if name == "maskrefiner-nofilter":
        return QuBERRefiner(config, params, dataset=dataset, use_fg_filter=False, device=device)
    if name == "identity":
        return IdentityRefiner()
    if name == "npy":
        return LoadNpyRefinerModel(npy_folder, dataset)
    if name in ("cascadepsp", "cascadepsp-rgbd"):
        from quber_tpu_torch.models.cascadepsp import CascadePSPRefiner
        from quber_tpu_torch.train.checkpoint import load_eval_params

        ckpt = os.environ.get("QUBER_CASCADEPSP_CKPT", "")
        if params is None and ckpt:
            params = load_eval_params(ckpt)
        return CascadePSPRefiner(params=params, dataset=dataset, device=device)
    if name == "rice":
        from quber_tpu_torch.evaluation.base_models import _restore_or_none
        from quber_tpu_torch.models.rice import RICERefiner

        if params is None:
            params = _restore_or_none(os.environ.get("QUBER_RICE_CKPT", ""))
        # greedy by default: it takes each operation on its own margin-gated
        # gain, where CEM takes whole trajectories (a clear repair can carry
        # a damaging operation along)
        return RICERefiner(params=params, dataset=dataset, device=device,
                           search=os.environ.get("QUBER_RICE_SEARCH", "greedy"))
    if name in ("sam", "hq-sam", "hq-sam-pretrained"):
        from quber_tpu_torch.models.sam_refiner import SAMHQRefiner

        ckpt = os.environ.get("QUBER_SAMHQ_CKPT", "")
        if name == "hq-sam" and params is None and ckpt:
            import json

            from quber_tpu_torch.train.checkpoint import load_eval_params

            with open(os.path.join(os.path.dirname(os.path.abspath(ckpt)), "arch.json")) as f:
                arch = json.load(f)
            arch["global_blocks"] = tuple(arch["global_blocks"])
            return SAMHQRefiner(params=load_eval_params(ckpt), dataset=dataset, hq=True,
                                device=device, **arch)
        return SAMHQRefiner(params=params, dataset=dataset, hq=name != "sam", device=device,
                            preset="vit_h" if name == "hq-sam-pretrained" else None)
    if name is None or name in ("none", "save"):
        return None
    raise NotImplementedError(
        f"refiner model {name}; available: maskrefiner, maskrefiner-nofilter, "
        "identity, npy, cascadepsp, cascadepsp-rgbd, rice, sam, hq-sam, hq-sam-pretrained")

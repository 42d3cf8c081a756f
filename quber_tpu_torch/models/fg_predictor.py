"""Foreground-segmenter predictors: CGNet at 320x240, LMFFNet at 640x480.

Port of quber_tpu/models/fg_predictor.py. The host reads the frame (colour
in BGR order, as cv2.imread gives it, through data/png.py), normalises and
Telea-inpaints the depth and standardises the colour (ops/preprocess.py);
the network runs on `device` ("cuda" unless the caller asks for the CPU).
Without params the net is initialised at random from a torch.Generator
seeded with `seed`; params are a flax variable tree (numpy arrays),
carried across by models/from_jax.py.
"""

from __future__ import annotations

import numpy as np
import torch

from quber_tpu_torch.models.cgnet import CGNet
from quber_tpu_torch.models.from_jax import state_dict_from_jax
from quber_tpu_torch.models.lmffnet import LMFFNet
from quber_tpu_torch.ops.preprocess import load_rgbd, resize_nearest, standardize_image


class _FgPredictor:
    size: tuple[int, int]

    def __init__(self, model: torch.nn.Module, params, seed: int, device):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        if params is None:
            model.reset_parameters(torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(state_dict_from_jax(params), strict=True)
        self.model = model.to(self.device).eval()

    def inputs(self, rgb: np.ndarray, depth: np.ndarray) -> np.ndarray:
        """BGR uint8 [h, w, 3] and normalised depth uint8 [h, w, 3] at
        `size` -> the network input [h, w, C] float32."""
        raise NotImplementedError

    def foreground(self, labels: np.ndarray) -> np.ndarray:
        """Argmax class at `size` -> foreground bool [480, 640]."""
        raise NotImplementedError

    @torch.inference_mode()
    def logits(self, x: np.ndarray) -> torch.Tensor:
        """Network input [h, w, C] float32 -> logits [classes, h, w] on the device."""
        return self.model(torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
                          .permute(2, 0, 1)[None])[0]

    def labels(self, rgb: np.ndarray, depth: np.ndarray) -> np.ndarray:
        """Argmax class [h, w] uint8 of the frame (first class on ties)."""
        out = self.logits(self.inputs(rgb, depth))
        return out.argmax(dim=0).to(torch.uint8).cpu().numpy()

    def predict(self, rgb_path, depth_path, frame=None) -> np.ndarray:
        """Foreground bool [480, 640] of the frame. `frame` is the (BGR,
        normalised depth) pair the caller has already read at `size`
        (ops/preprocess.load_rgbd); without it the predictor reads the files."""
        rgb, depth = frame if frame is not None else load_rgbd(rgb_path, depth_path, self.size)[:2]
        return self.foreground(self.labels(rgb, depth))


class CGNetPredictor(_FgPredictor):
    """4 channels (standardised colour + depth / 255) at 320x240; argmax over
    2 classes; nearest upsample to 640x480."""

    size = (240, 320)

    def __init__(self, params=None, seed: int = 0, device="cuda"):
        super().__init__(CGNet(classes=2, in_channels=4), params, seed, device)

    def inputs(self, rgb, depth) -> np.ndarray:
        return np.concatenate(
            [standardize_image(rgb), depth[:, :, 0:1].astype(np.float32) / 255.0], axis=-1)

    def foreground(self, labels: np.ndarray) -> np.ndarray:
        return resize_nearest(labels, (480, 640)) > 0


class LMFFNetPredictor(_FgPredictor):
    """6 channels (standardised colour + 3 x depth / 255) at 640x480; class 2
    is the object foreground."""

    size = (480, 640)

    def __init__(self, params=None, seed: int = 0, device="cuda"):
        super().__init__(LMFFNet(classes=3), params, seed, device)

    def inputs(self, rgb, depth) -> np.ndarray:
        return np.concatenate([standardize_image(rgb), depth.astype(np.float32) / 255.0],
                              axis=-1)

    def foreground(self, labels: np.ndarray) -> np.ndarray:
        return labels == 2

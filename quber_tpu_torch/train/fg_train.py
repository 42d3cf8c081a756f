"""Training of the foreground segmenters (CGNet / LMFFNet).

Port of quber_tpu/train/fg_train.py: class-balanced weighted
cross-entropy (per-image weights = inverse class pixel fraction), RAdam as
optax computes it (train/optim.RAdam), and a step with BatchNorm in
training mode (models/layers.BatchNorm: the batch's statistics, running
statistics moved by 0.1 towards them with flax's biased variance). Logits
and inputs are channels first.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from quber_tpu_torch.train.optim import RAdam


def class_balanced_weights(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Per-pixel weights w_c = pixels / (num_classes * count_c) of each
    image, 0 for classes absent from it. labels [B, H, W] int -> [B, H, W]
    float32."""
    b, h, w = labels.shape
    counts = F.one_hot(labels.long(), num_classes).sum(dim=(1, 2)).float()  # [B, C]
    w_c = float(h * w) / (num_classes * counts.clamp(min=1.0))
    w_c = torch.where(counts > 0, w_c, torch.zeros_like(w_c))
    return torch.gather(w_c, 1, labels.long().reshape(b, -1)).reshape(b, h, w)


def weighted_ce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean over pixels of the cross-entropy times the class weight; logits
    [B, C, H, W], labels [B, H, W]."""
    weights = class_balanced_weights(labels, logits.shape[1])
    ce = F.cross_entropy(logits.float(), labels.long(), reduction="none")
    return (ce * weights).mean()


@dataclasses.dataclass
class FgTrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer


def create_fg_train_state(model: nn.Module, lr: float = 1e-3, seed: int = 7,
                          device="cuda", init: bool = True) -> FgTrainState:
    """The net (initialised from a generator seeded with `seed` unless
    `init` is False: the caller has loaded weights) on `device`, with RAdam
    over its parameters."""
    if init:
        model.reset_parameters(torch.Generator().manual_seed(seed))
    model.to(device)
    return FgTrainState(0, model, RAdam(model.parameters(), lr=lr))


def fg_train_step(state: FgTrainState, images: torch.Tensor, labels: torch.Tensor) -> dict:
    """One update from images [B, C, H, W] and labels [B, H, W] on the
    state's device; returns {"loss": detached tensor}."""
    state.model.train()
    loss = weighted_ce_loss(state.model(images), labels)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return {"loss": loss.detach()}

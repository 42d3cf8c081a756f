"""Training step and state.

Port of quber_tpu/train/loop.py for one device: the state holds the module
(parameters, FrozenBN tensors and the head's BatchNorm statistics), the
optimizer with its moments, the learning-rate schedule, the generator that
the dropout masks come from, and the step count. A step updates the state
in place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from quber_tpu_torch.models.mask_refiner import MaskRefiner, MaskRefinerConfig, compute_losses
from quber_tpu_torch.train.optim import build_optimizer, freeze_backbone_stages


@dataclasses.dataclass
class TrainState:
    step: int
    model: MaskRefiner
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    generator: torch.Generator


def create_train_state(model_cfg: MaskRefinerConfig, train_cfg, device="cuda",
                       extra_freeze: Callable | None = None) -> TrainState:
    """A seeded initialisation (train_cfg.seed: the reference's initialisers,
    not its values), the optimizer over the trainable parameters, and the
    dropout generator, all on `device`."""
    device = torch.device(device)
    if extra_freeze is None:
        extra_freeze = freeze_backbone_stages(train_cfg.freeze_backbone_stages)
    model = MaskRefiner(model_cfg)
    model.reset_parameters(torch.Generator().manual_seed(train_cfg.seed))
    model.to(device)
    optimizer, schedule = build_optimizer(train_cfg, model, extra_freeze)
    generator = torch.Generator(device=device).manual_seed(train_cfg.seed)
    model.set_dropout_generator(generator)
    return TrainState(0, model, optimizer, schedule, generator)


def apply_step(state: TrainState, batch: dict, model_cfg: MaskRefinerConfig,
               mark: Callable[[str], None] | None = None) -> dict:
    """One update of `state` from a batch of images and targets; returns the
    losses and their sum as detached tensors on the device. `mark(phase)` is
    called after the forward (with the losses), the backward and the
    optimizer, for callers that time the phases."""
    model = state.model
    model.train()
    outputs = model(batch["image"], batch.get("offset_enc"), full_res=False)
    losses = compute_losses(outputs, batch, model_cfg)
    total = sum(losses.values())
    if mark is not None:
        mark("forward")
    state.optimizer.zero_grad(set_to_none=True)
    total.backward()
    if mark is not None:
        mark("backward")
    lr = state.schedule(state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    state.step += 1
    if mark is not None:
        mark("optimizer")
    metrics = {k: v.detach() for k, v in losses.items()}
    metrics["total_loss"] = total.detach()
    return metrics


def make_train_step(model_cfg: MaskRefinerConfig):
    """train_step(state, batch, mark=None) -> (state, metrics). The batch is a
    dict of tensors on the state's device, batch-major and channels first:
    image [B, 6, H, W], offset_enc [B, 3, H, W], and the target fields of
    models.mask_refiner.compute_losses."""

    def train_step(state: TrainState, batch: dict, mark=None):
        return state, apply_step(state, batch, model_cfg, mark)

    return train_step


def make_eval_step(model_cfg: MaskRefinerConfig):
    """eval_step(state, batch) -> full-resolution outputs of the model in eval
    mode (running BatchNorm statistics, no dropout), without gradients."""

    def eval_step(state: TrainState, batch: dict) -> dict:
        state.model.eval()
        with torch.no_grad():
            return state.model(batch["image"], batch.get("offset_enc"))

    return eval_step

"""Optimizers, the WarmupPolyLR schedule and layer freezing.

Port of quber_tpu/train/optim.py: Adam (or SGD with momentum 0.9) with L2
weight decay added to the gradient, the learning rate of detectron2's
WarmupPolyLR (lr = base * (1 - t/T)^0.9 after a linear warm-up from factor
1e-3), and a freeze mask. A frozen leaf gets no update at all: it is taken
out of the optimizer and needs no gradient. FrozenBN tensors are buffers of
the port's modules and so are frozen by construction.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from quber_tpu_torch.models.layers import FrozenBatchNorm


def warmup_poly_schedule(base_lr: float, max_iter: int, power: float = 0.9,
                         warmup_iters: int = 1000, warmup_factor: float = 1e-3,
                         constant_ending: float = 0.0) -> Callable[[int], float]:
    """step -> learning rate; step 0 (the first update) gives
    base_lr * warmup_factor."""

    def schedule(step: int) -> float:
        t = float(step)
        warm = 1.0
        if t < warmup_iters:
            warm = warmup_factor + (1.0 - warmup_factor) * (t / max(warmup_iters, 1))
        poly = max(0.0, 1.0 - t / max_iter) ** power
        return base_lr * warm * max(poly, constant_ending)

    return schedule


def is_frozen_path(model: nn.Module, name: str) -> bool:
    """Whether the state-dict entry `name` of `model` is a FrozenBN tensor
    (weight, bias, mean or variance): those never receive updates."""
    parent = name.rpartition(".")[0]
    return isinstance(model.get_submodule(parent), FrozenBatchNorm)


def freeze_backbone_stages(n: int) -> Callable | None:
    """detectron2 BACKBONE.FREEZE_AT: a predicate over the keys of a leaf's
    path that is true in the stem and the stages res2..res<n> of BOTH trunks;
    None for n <= 0."""
    if n <= 0:
        return None
    frozen = {"stem"} | {f"res{s}" for s in range(2, n + 1)}

    def predicate(path) -> bool:
        return len(path) >= 3 and path[0] == "backbone" and path[2].split("_")[0] in frozen

    return predicate


def make_freeze_mask(model: nn.Module, extra_predicate: Callable | None = None) -> dict:
    """{name: trainable} over the model's parameters and FrozenBN tensors
    (the leaves of the flax `params` tree). extra_predicate(path) -> bool
    marks further frozen leaves by the tuple of keys of their dotted name."""
    mask = {}
    for name, _ in model.named_parameters():
        mask[name] = not (extra_predicate is not None and extra_predicate(tuple(name.split("."))))
    for name, _ in model.named_buffers():
        if is_frozen_path(model, name):
            mask[name] = False
    return mask


def build_optimizer(train_cfg, model: nn.Module, extra_freeze: Callable | None = None):
    """(optimizer, schedule) from a TrainConfig. The optimizer holds the
    trainable parameters only; the others are switched off for autograd. The
    caller sets the groups' `lr` to schedule(step) before each update."""
    schedule = warmup_poly_schedule(
        train_cfg.base_lr, train_cfg.max_iter, power=train_cfg.poly_power,
        warmup_iters=train_cfg.warmup_iters, warmup_factor=train_cfg.warmup_factor)
    mask = make_freeze_mask(model, extra_freeze)
    trainable = []
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            trainable.append(p)
    kind = train_cfg.optimizer.lower()
    if kind == "adam":
        optimizer = torch.optim.Adam(trainable, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=train_cfg.weight_decay)
    elif kind == "sgd":
        optimizer = torch.optim.SGD(trainable, lr=schedule(0), momentum=0.9,
                                    weight_decay=train_cfg.weight_decay)
    else:
        raise ValueError(train_cfg.optimizer)
    return optimizer, schedule

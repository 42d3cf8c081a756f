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


def _pow_f32(base: float, n: int):
    """base ** n in float32 by square-and-multiply."""
    import numpy as np

    out, b = np.float32(1.0), np.float32(base)
    while n:
        if n & 1:
            out = np.float32(out * b)
        b = np.float32(b * b)
        n >>= 1
    return out


class RAdam(torch.optim.Optimizer):
    """Rectified Adam as optax.radam computes it (Liu et al., 2020).

    torch.optim.RAdam differs: it adds eps to sqrt(nu) before the second
    moment's bias correction, optax after. Here, per leaf and step t:
    mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, the bias-corrected
    mu_hat and nu_hat, rho_t = rho_inf - 2 t b2^t / (1 - b2^t), and the
    update -lr * r_t mu_hat / (sqrt(nu_hat) + eps) once rho_t >= threshold
    (from step 6 for b2 = 0.999: rho_5 ~ 4.996, rho_6 ~ 5.99), else -lr *
    mu_hat. The step's scalars are float32, as JAX computes them (b^t by
    square-and-multiply, as XLA raises a float to an integer power)."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 threshold: float = 5.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, threshold=threshold))

    @torch.no_grad()
    def step(self, closure=None):
        import numpy as np

        f32 = np.float32
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            for p in params:
                if not self.state[p]:
                    self.state[p].update(step=0, mu=torch.zeros_like(p), nu=torch.zeros_like(p))
                self.state[p]["step"] += 1
            grads = [p.grad for p in params]
            mus = [self.state[p]["mu"] for p in params]
            nus = [self.state[p]["nu"] for p in params]
            # each moment as (1 - b) * g (g^2) + b * m, rounded as optax rounds it
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, torch._foreach_mul(grads, 1 - b1))
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
            t = self.state[params[0]]["step"]
            rho_inf = f32(2.0 / (1.0 - b2) - 1.0)
            b2t = _pow_f32(b2, t)
            rho = f32(rho_inf - f32(2 * t) * b2t / (f32(1) - b2t))
            update = torch._foreach_div(mus, float(f32(1) - _pow_f32(b1, t)))
            if rho >= group["threshold"]:
                r = np.sqrt(f32((rho - 4) * (rho - 2) * rho_inf
                                / ((rho_inf - 4) * (rho_inf - 2) * rho)))
                denom = torch._foreach_sqrt(torch._foreach_div(nus, float(f32(1) - b2t)))
                torch._foreach_add_(denom, group["eps"])
                torch._foreach_mul_(update, float(r))
                torch._foreach_div_(update, denom)
            torch._foreach_add_(params, torch._foreach_mul(update, -group["lr"]))
        return None

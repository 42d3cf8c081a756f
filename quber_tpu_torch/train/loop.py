"""Training step and state.

Port of quber_tpu/train/loop.py: the state holds the module (parameters,
FrozenBN tensors and the head's BatchNorm statistics), the optimizer with
its moments, the learning-rate schedule, the generator that the dropout
masks come from, the step count and the data-parallel mesh (None on one
device). A step updates the state in place.

Data parallel (a parallel.mesh.Mesh of world size W > 1, one process a
rank): the JAX package's step is jit over the GLOBAL batch, and so is this
one. Each rank runs its slice of the batch; the head's BatchNorm takes the
global moments (models/layers.BatchNorm), each loss is the rank's share of
the global loss (models/mask_refiner.compute_losses), so the gradient of a
rank's summed shares, summed over the ranks, is the gradient of the global
loss: after backward one coalesced all-reduce sums the gradients
(parallel.mesh.all_reduce_grads; not DDP, whose buckets average). Adam, the
schedule and the frozen stages are those of one device, and every rank's
parameters, moments and BatchNorm statistics stay bit-equal.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from quber_tpu_torch.models.layers import sync_batch_norm
from quber_tpu_torch.models.mask_refiner import MaskRefiner, MaskRefinerConfig, compute_losses
from quber_tpu_torch.parallel.mesh import (Mesh, all_reduce_grads, all_reduce_sum, rank_seed,
                                           replicate)
from quber_tpu_torch.train.optim import build_optimizer, freeze_backbone_stages


@dataclasses.dataclass
class TrainState:
    step: int
    model: MaskRefiner
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    generator: torch.Generator
    mesh: Mesh | None = None


def create_train_state(model_cfg: MaskRefinerConfig, train_cfg, device=None,
                       extra_freeze: Callable | None = None,
                       mesh: Mesh | None = None) -> TrainState:
    """A seeded initialisation (train_cfg.seed: the reference's initialisers,
    not its values), the optimizer over the trainable parameters, and the
    dropout generator, all on `device` ("cuda" by default; the mesh's device
    under a mesh). Under a data-parallel `mesh` the module carries rank 0's
    initialisation, its BatchNorms the mesh, and the dropout generator is
    seeded by (seed, rank): the ranks draw different masks, as the JAX
    package's one mask over the global batch differs between its shards."""
    if device is None:
        device = "cuda" if mesh is None else mesh.device
    device = torch.device(device)
    if mesh is not None and device != mesh.device:
        raise ValueError(f"the state's device {device} is not the mesh's {mesh.device}")
    if extra_freeze is None:
        extra_freeze = freeze_backbone_stages(train_cfg.freeze_backbone_stages)
    model = MaskRefiner(model_cfg)
    model.reset_parameters(torch.Generator().manual_seed(train_cfg.seed))
    model.to(device)
    if mesh is not None:
        replicate(sync_batch_norm(model, mesh), mesh)
    optimizer, schedule = build_optimizer(train_cfg, model, extra_freeze)
    generator = torch.Generator(device=device).manual_seed(rank_seed(train_cfg.seed, mesh))
    model.set_dropout_generator(generator)
    return TrainState(0, model, optimizer, schedule, generator, mesh)


def apply_step(state: TrainState, batch: dict, model_cfg: MaskRefinerConfig,
               mark: Callable[[str], None] | None = None, mesh: Mesh | None = None) -> dict:
    """One update of `state` from a batch of images and targets (this rank's
    slice under a `mesh`, which must be the state's); returns the losses and
    their sum as detached tensors on the device, those of the global batch
    under a mesh. `mark(phase)` is called after the forward (with the
    losses), the backward and the optimizer, for callers that time the
    phases."""
    if mesh is not state.mesh:
        raise ValueError("the step's mesh is not the one the state was created with "
                         "(create_train_state(..., mesh=))")
    model = state.model
    model.train()
    outputs = model(batch["image"], batch.get("offset_enc"), full_res=False)
    losses = compute_losses(outputs, batch, model_cfg, mesh)
    total = sum(losses.values())
    if mark is not None:
        mark("forward")
    state.optimizer.zero_grad(set_to_none=True)
    total.backward()
    if mesh is not None and mesh.distributed:
        all_reduce_grads([p for g in state.optimizer.param_groups for p in g["params"]], mesh)
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
    if mesh is not None and mesh.distributed:
        summed = all_reduce_sum(torch.stack(list(metrics.values())), mesh)
        metrics = dict(zip(metrics, summed.unbind()))
    return metrics


def make_train_step(model_cfg: MaskRefinerConfig, mesh: Mesh | None = None):
    """train_step(state, batch, mark=None) -> (state, metrics). The batch is a
    dict of tensors on the state's device, batch-major and channels first:
    image [B, 6, H, W], offset_enc [B, 3, H, W], and the target fields of
    models.mask_refiner.compute_losses. Under a data-parallel `mesh` (the
    state's) the batch is this rank's slice (parallel.mesh.put_batch) and
    the step is the global batch's."""

    def train_step(state: TrainState, batch: dict, mark=None):
        return state, apply_step(state, batch, model_cfg, mark, mesh)

    return train_step


def make_eval_step(model_cfg: MaskRefinerConfig):
    """eval_step(state, batch) -> full-resolution outputs of the model in eval
    mode (running BatchNorm statistics, no dropout), without gradients."""

    def eval_step(state: TrainState, batch: dict) -> dict:
        state.model.eval()
        with torch.no_grad():
            return state.model(batch["image"], batch.get("offset_enc"))

    return eval_step

"""Training of the explicit-error-estimation study's late-fusion model.

Port of quber_tpu/train/eee_train.py: Adam (AdamW, decoupled, with a
weight decay), the selected loss (focal, dice or dice-CE) on the mask and
boundary heads against their tp / fp / fn error-map targets, summed. Data
parallel (a parallel.mesh.Mesh, as the reference's jit over a sharded
batch): the late-fusion model is GroupNorm only and its losses are means
over equal shards, so the global batch's step is each rank's loss on its
slice with the gradients averaged over the ranks.
"""

from __future__ import annotations

from typing import Callable, Iterator

import torch

from quber_tpu_torch.models.late_fusion import LateFusionEncoderDecoder, dice_ce_loss, focal_loss
from quber_tpu_torch.models.mask_refiner import dice_loss
from quber_tpu_torch.parallel.mesh import Mesh, all_reduce_grads, put_batch, replicate


def make_loss(name: str) -> Callable:
    if name == "focal":
        return focal_loss
    if name == "dicece":
        return dice_ce_loss
    if name == "dice":
        return dice_loss
    raise ValueError(f"unknown EEE loss {name!r}; use focal | dice | dicece")


def create_eee_state(model: LateFusionEncoderDecoder, lr: float = 1e-4,
                     weight_decay: float = 0.0, seed: int | None = 7,
                     device="cuda", mesh: Mesh | None = None) -> torch.optim.Optimizer:
    """Initialise `model` from `seed` (flax's initialisers; the reference's
    values come from its own PRNG; None leaves its weights), move it to
    `device` (the mesh's under a `mesh`, with rank 0's weights on every
    rank) and return its optimizer: optax.adam(lr)
    as torch's Adam, or with a weight decay optax.adamw's decoupled decay
    (p -= lr * (update + decay * p), every parameter) as torch's AdamW;
    both take optax's defaults (betas 0.9 / 0.999, eps 1e-8)."""
    if seed is not None:
        model.reset_parameters(torch.Generator().manual_seed(seed))
    model.to(mesh.device if mesh is not None else device)
    if mesh is not None:
        replicate(model, mesh)
    if weight_decay:
        return torch.optim.AdamW(model.parameters(), lr=lr, weight_decay=weight_decay)
    return torch.optim.Adam(model.parameters(), lr=lr)


def make_eee_train_step(model: LateFusionEncoderDecoder, optimizer: torch.optim.Optimizer,
                        loss_name: str = "focal", mesh: Mesh | None = None):
    """step(batch) -> metrics: one update of `model`. `batch` holds the
    modality inputs (model.modalities' names, [B, C, H, W]) and
    "mask_target" / "boundary_target" [B, num_classes, H, W]; the metrics
    (loss_mask, loss_boundary, total_loss) are those before the update.
    Under a data-parallel `mesh` the batch is this rank's slice, the
    gradients and the metrics are averaged over the ranks (those of the
    global batch)."""
    loss_fn = make_loss(loss_name)
    distributed = mesh is not None and mesh.distributed

    def step(batch):
        out = model({k: batch[k] for k, _ in model.modalities})
        l_mask = loss_fn(out["mask"], batch["mask_target"])
        l_boundary = loss_fn(out["boundary"], batch["boundary_target"])
        total = l_mask + l_boundary
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        metrics = torch.stack([l_mask, l_boundary, total]).detach()
        if distributed:
            import torch.distributed as dist

            all_reduce_grads(list(model.parameters()), mesh, average=True)
            dist.all_reduce(metrics, group=mesh.group)
            metrics /= mesh.world_size
        optimizer.step()
        return dict(zip(("loss_mask", "loss_boundary", "total_loss"), metrics.unbind()))

    return step


def train_eee(model: LateFusionEncoderDecoder, batches: Iterator[dict], steps: int,
              lr: float = 1e-4, weight_decay: float = 0.0, loss_name: str = "focal",
              mesh: Mesh | None = None, log_every: int = 50, seed: int | None = 7,
              device="cuda"):
    """The reference recipe's training loop: `model` initialised from `seed`
    (None: its weights as they are) on `device`, `steps` updates on the
    batches in turn (each tensor moved to `device`), a log line every
    `log_every`. Under a data-parallel `mesh` the model lives on the mesh's
    device and each batch is the global batch, of which every rank takes
    its slice (parallel.mesh.put_batch).
    Returns (model, the last metrics)."""
    optimizer = create_eee_state(model, lr, weight_decay, seed, device, mesh)
    step = make_eee_train_step(model, optimizer, loss_name, mesh)
    metrics = {}
    for it in range(steps):
        batch = next(batches)
        batch = put_batch(batch, mesh) if mesh is not None else \
            {k: v.to(device) for k, v in batch.items()}
        metrics = step(batch)
        if log_every and ((it + 1) % log_every == 0 or it + 1 == steps):
            print(f"eee iter {it + 1}/{steps} "
                  + " ".join(f"{k}={float(v):.4f}" for k, v in sorted(metrics.items())),
                  flush=True)
    return model, metrics

"""Training of the explicit-error-estimation study's late-fusion model.

Port of quber_tpu/train/eee_train.py: Adam (AdamW, decoupled, with a
weight decay), the selected loss (focal, dice or dice-CE) on the mask and
boundary heads against their tp / fp / fn error-map targets, summed. One
device: the reference's data-parallel mesh has no counterpart yet (ROADMAP
Queue 1 item 12), so `mesh` must be None.
"""

from __future__ import annotations

from typing import Callable, Iterator

import torch

from quber_tpu_torch.models.late_fusion import LateFusionEncoderDecoder, dice_ce_loss, focal_loss
from quber_tpu_torch.models.mask_refiner import dice_loss


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
                     device="cuda") -> torch.optim.Optimizer:
    """Initialise `model` from `seed` (flax's initialisers; the reference's
    values come from its own PRNG; None leaves its weights), move it to
    `device` and return its optimizer: optax.adam(lr)
    as torch's Adam, or with a weight decay optax.adamw's decoupled decay
    (p -= lr * (update + decay * p), every parameter) as torch's AdamW;
    both take optax's defaults (betas 0.9 / 0.999, eps 1e-8)."""
    if seed is not None:
        model.reset_parameters(torch.Generator().manual_seed(seed))
    model.to(device)
    if weight_decay:
        return torch.optim.AdamW(model.parameters(), lr=lr, weight_decay=weight_decay)
    return torch.optim.Adam(model.parameters(), lr=lr)


def _check_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("a data-parallel mesh is not ported yet (ROADMAP Queue 1 "
                                  "item 12); pass mesh=None")


def make_eee_train_step(model: LateFusionEncoderDecoder, optimizer: torch.optim.Optimizer,
                        loss_name: str = "focal", mesh=None):
    """step(batch) -> metrics: one update of `model`. `batch` holds the
    modality inputs (model.modalities' names, [B, C, H, W]) and
    "mask_target" / "boundary_target" [B, num_classes, H, W]; the metrics
    (loss_mask, loss_boundary, total_loss) are those before the update.
    `mesh` is accepted only as None (one device)."""
    _check_mesh(mesh)
    loss_fn = make_loss(loss_name)

    def step(batch):
        out = model({k: batch[k] for k, _ in model.modalities})
        l_mask = loss_fn(out["mask"], batch["mask_target"])
        l_boundary = loss_fn(out["boundary"], batch["boundary_target"])
        total = l_mask + l_boundary
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        optimizer.step()
        return {"loss_mask": l_mask.detach(), "loss_boundary": l_boundary.detach(),
                "total_loss": total.detach()}

    return step


def train_eee(model: LateFusionEncoderDecoder, batches: Iterator[dict], steps: int,
              lr: float = 1e-4, weight_decay: float = 0.0, loss_name: str = "focal",
              mesh=None, log_every: int = 50, seed: int | None = 7, device="cuda"):
    """The reference recipe's training loop: `model` initialised from `seed`
    (None: its weights as they are) on `device`, `steps` updates on the
    batches in turn (each tensor moved to `device`), a log line every
    `log_every`.
    Returns (model, the last metrics). `mesh` is accepted only as None."""
    _check_mesh(mesh)
    optimizer = create_eee_state(model, lr, weight_decay, seed, device)
    step = make_eee_train_step(model, optimizer, loss_name)
    metrics = {}
    for it in range(steps):
        metrics = step({k: v.to(device) for k, v in next(batches).items()})
        if log_every and ((it + 1) % log_every == 0 or it + 1 == steps):
            print(f"eee iter {it + 1}/{steps} "
                  + " ".join(f"{k}={float(v):.4f}" for k, v in sorted(metrics.items())),
                  flush=True)
    return model, metrics

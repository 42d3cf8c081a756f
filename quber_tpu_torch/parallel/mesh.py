"""Data parallelism over torch.distributed.

Port of quber_tpu/parallel/mesh.py. The JAX package trains data-parallel by
jitting one step over a batch sharded on a 1-D mesh ("data"): every
operation keeps its one-device meaning over the GLOBAL batch and XLA inserts
the collectives. Here each process drives one device and the collectives are
explicit, so that the step still computes the global batch's step: the
BatchNorm moments (models/layers.BatchNorm), the loss normalisers
(models/mask_refiner.compute_losses) and the gradient (train/loop) are
reduced over the ranks.

A `Mesh` takes one of two forms:
  * a process group is up (torchrun, or initialize_multihost): one device a
    process, the rank and world size of the group;
  * no process group: devices of this one process (by default every visible
    CUDA device), each serving a model replica
    (predictor.predict_batch_stream(mesh=)); its world size is 1.

The collectives are built from all_reduce and broadcast only: gloo takes
CUDA tensors for those but not for all_gather, and NCCL refuses two ranks
on one device, so two ranks sharing one card run under gloo and the same
code runs under NCCL.

Height partitioning (the JAX package's second mesh axis, "space") is not
ported: XLA's partitioner inserts each convolution's halo exchange itself,
which torch leaves to every layer (ROADMAP item 12b).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """The devices this process drives, its rank and the world size over
    the 1-D "data" axis, and the process group (None in one process)."""

    devices: tuple
    group: object = None
    rank: int = 0
    world_size: int = 1
    axis_name: str = "data"

    @property
    def device(self) -> torch.device:
        """This process's (first) device."""
        return self.devices[0]

    @property
    def distributed(self) -> bool:
        """Whether a step must reduce over other processes."""
        return self.group is not None and self.world_size > 1

    def __copy__(self):
        return self

    def __deepcopy__(self, memo):
        # a module holding the mesh (layers.BatchNorm) is copied with it; the
        # process group is not a value to copy
        return self


def _default_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: name the devices (e.g. devices=['cpu'])")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def make_mesh(devices=None, axis_name: str = "data") -> Mesh:
    """1-D data-parallel mesh. With a process group up: this process's one
    device (`devices`: a device or a list of one; default cuda:LOCAL_RANK).
    Otherwise: the given in-process devices (default every visible CUDA
    device); a device may appear twice, as two replicas sharing it."""
    if devices is not None and not isinstance(devices, (list, tuple)):
        devices = [devices]
    if dist.is_available() and dist.is_initialized():
        devices = [_default_device()] if devices is None else devices
        if len(devices) != 1:
            raise ValueError(f"a process of a process group drives one device, got {devices}")
        return Mesh((torch.device(devices[0]),), dist.group.WORLD, dist.get_rank(),
                    dist.get_world_size(), axis_name)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: name the devices (e.g. devices=['cpu'])")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(torch.device(d) for d in devices), axis_name=axis_name)


def make_mesh_2d(devices=None, space: int = 1, axis_names=("data", "space")) -> Mesh:
    """The data x space mesh: only space 1, the 1-D mesh, is ported."""
    if space > 1:
        raise NotImplementedError(
            "height partitioning (space > 1) is not ported: every convolution would need "
            "its halo exchange and GroupNorm an all-reduce (ROADMAP.md Queue 1 item 12b)")
    return make_mesh(devices, axis_names[0])


def initialize_multihost(coordinator: str | None = None, num_processes: int | None = None,
                         process_id: int | None = None, backend: str | None = None,
                         device=None) -> None:
    """torch.distributed.init_process_group, before any use of the card.

    Defaults come from torchrun's environment (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT): `torchrun --nnodes M --nproc-per-node N
    --rdzv-endpoint HOST:PORT ...` on every node is the multi-node launch.
    `coordinator` is "host:port" (TCP) or a URL ("tcp://...", "file://...").
    The backend is NCCL for a CUDA `device` (default: CUDA when a card is
    visible) and gloo on the CPU; name "gloo" to run several ranks on one
    card."""
    if backend is None:
        cuda = torch.cuda.is_available() if device is None else \
            torch.device(device).type == "cuda"
        backend = "nccl" if cuda else "gloo"
    init = "env://" if coordinator is None else (
        coordinator if "://" in coordinator else f"tcp://{coordinator}")
    kwargs = {}
    if backend == "nccl" and device is not None and torch.device(device).index is not None:
        kwargs["device_id"] = torch.device(device)  # the rank's card, not a guess
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(backend, init_method=init, **kwargs)


def shutdown() -> None:
    """Ends the process group (if one is up)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _slice(x, i: int, parts: int):
    """The i-th of `parts` contiguous slices of x's first axis."""
    if len(x) % parts:
        raise ValueError(f"a batch of {len(x)} does not divide over {parts} ways")
    size = len(x) // parts
    return x[i * size:(i + 1) * size]


def shard_batch(batch, mesh: Mesh):
    """This rank's contiguous 1/W slice of each batch-major leaf (tensors or
    arrays) of a global batch; the whole batch in one process."""
    return _tree_map(lambda x: _slice(x, mesh.rank, mesh.world_size), batch)


def split_batch(batch, mesh: Mesh) -> list:
    """An in-process mesh's D contiguous sub-batches, one per device, in
    order (not moved)."""
    d = len(mesh.devices)
    return [_tree_map(lambda x: _slice(x, i, d), batch) for i in range(d)]


def _to(x, device):
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device) if isinstance(x, torch.Tensor) else x


def put_batch(batch, mesh: Mesh):
    """This rank's slice of a global host batch, on its device."""
    return _tree_map(lambda x: _to(x, mesh.device), shard_batch(batch, mesh))


def put_batch_local_shard(batch, mesh: Mesh):
    """This process's own batch (its part of the global batch, e.g. from a
    stream of its own) moved to its device as it is; equal to put_batch in a
    one-process run."""
    return _tree_map(lambda x: _to(x, mesh.device), batch)


def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Rank 0's parameters and buffers on every rank (broadcast in place)."""
    if mesh.distributed:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=0, group=mesh.group)
    return module


class _AllReduceSum(torch.autograd.Function):
    """y = sum over ranks of x; the gradient of every rank's x is the sum of
    the ranks' gradients of y (each rank's loss reads y)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The sum over the ranks, differentiable (the identity in one process)."""
    if mesh is None or not mesh.distributed:
        return x
    return _AllReduceSum.apply(x, mesh.group)


def all_gather(x: torch.Tensor, mesh: Mesh | None) -> tuple[torch.Tensor, list[int]]:
    """Every rank's x (any leading length) concatenated in rank order, from a
    zero-padded all-reduce, and the ranks' lengths. Not differentiable."""
    if mesh is None or not mesh.distributed:
        return x.detach(), [len(x)]
    w = mesh.world_size
    sizes = torch.zeros(w, dtype=torch.int64, device=x.device)
    sizes[mesh.rank] = len(x)
    dist.all_reduce(sizes, group=mesh.group)
    sizes = sizes.tolist()
    buf = x.new_zeros((w, max(sizes)) + tuple(x.shape[1:]))
    buf[mesh.rank, :len(x)] = x.detach()
    dist.all_reduce(buf, group=mesh.group)
    return torch.cat([buf[r, :n] for r, n in enumerate(sizes)]), sizes


def all_reduce_grads(params, mesh: Mesh, average: bool = False) -> None:
    """Sums (or averages) the gradients of `params` over the ranks in one
    coalesced all-reduce; parameters without a gradient are skipped (every
    rank runs the same graph)."""
    if not mesh.distributed:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    if average:
        flat /= mesh.world_size
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def rank_seed(seed: int, mesh: Mesh | None) -> int:
    """The seed of a rank's own random draws (dropout): `seed` on rank 0 and
    in one process, a seed drawn from (seed, rank) on the others."""
    if mesh is None or mesh.rank == 0:
        return seed
    return int(np.random.SeedSequence([seed, mesh.rank]).generate_state(1)[0])

"""Ranks of a data-parallel run of the port on the CPU, for the tests.

    python tests/torch_parallel_worker.py INPUTS.npz OUT_DIR RANK WORLD INIT CASE...

Each rank is a process of a gloo group (INIT: a file:// rendezvous in a
temporary directory, so that test workers running side by side do not
share a port), with torch at one thread. It reads the global inputs from
INPUTS.npz ("<case>/<name>" keys, batch-major, channels first), runs the
named cases on its slice of each batch, and writes OUT_DIR/rank<RANK>.npz
("<case>/<name>" keys). `Ranks` / `run_ranks` launch the ranks from a test. This
module imports the port only, never the JAX package or a test module.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the sizes of tests/test_torch_train.py
H = W = 32
SLOTS = 8
CFG = dict(height=H, width=W, resnet_depth=14, aspp_dropout=0.0)
TRAIN = dict(batch_size=4, max_iter=100, base_lr=1e-3, warmup_iters=2, warmup_factor=0.5)
EEE_LR, EEE_DECAY = 1e-4, 1e-2
STEPS = 2


class Ranks:
    """`world` gloo ranks running `cases` over `inputs` in the background;
    results() waits for them and returns each rank's results as a dict of
    numpy arrays."""

    def __init__(self, inputs: dict, cases, world: int = 2, timeout: float = 300.0):
        self.world, self.timeout = world, timeout
        self._tmp = tempfile.TemporaryDirectory()
        tmp = self._tmp.name
        path = os.path.join(tmp, "inputs.npz")
        np.savez(path, **inputs)
        init = "file://" + os.path.join(tmp, "rendezvous")
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(filter(None, [REPO, os.environ.get("PYTHONPATH")])))
        env.pop("WORLD_SIZE", None)
        env.pop("RANK", None)
        self._procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), path, tmp,
                                         str(r), str(world), init, *cases], env=env,
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True)
                       for r in range(world)]

    def results(self) -> list[dict]:
        outs = []
        try:
            for p in self._procs:
                outs.append(p.communicate(timeout=self.timeout)[0])
        finally:
            for p in self._procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        try:
            for r, (p, out) in enumerate(zip(self._procs, outs)):
                if p.returncode:
                    raise RuntimeError(f"rank {r} exited with {p.returncode}:\n{out}")
            results = []
            for r in range(self.world):
                with np.load(os.path.join(self._tmp.name, f"rank{r}.npz")) as f:
                    results.append({k: f[k] for k in f.files})
            return results
        finally:
            self._tmp.cleanup()


def run_ranks(inputs: dict, cases, world: int = 2, timeout: float = 300.0) -> list[dict]:
    """Runs `cases` on `world` gloo ranks over `inputs` and waits for them."""
    return Ranks(inputs, cases, world, timeout).results()


def _case(inputs: dict, name: str) -> dict:
    prefix = name + "/"
    return {k[len(prefix):]: v for k, v in inputs.items() if k.startswith(prefix)}


def _t(x):
    import torch

    return torch.from_numpy(np.ascontiguousarray(x))


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def case_collectives(inputs, mesh) -> dict:
    """all_reduce_sum's value and gradient (y = sum over ranks of x * x, the
    rank's loss sum(y * c_rank)), and all_gather of rank-long vectors."""
    from quber_tpu_torch.parallel.mesh import all_gather, all_reduce_sum

    x = _t(inputs["x"][mesh.rank]).requires_grad_(True)
    y = all_reduce_sum(x * x, mesh)
    (y * _t(inputs["c"][mesh.rank])).sum().backward()
    gathered, sizes = all_gather(_t(inputs["x"][mesh.rank, :mesh.rank + 1]), mesh)
    return {"y": _np(y), "x_grad": _np(x.grad), "gathered": _np(gathered),
            "sizes": np.asarray(sizes)}


def case_bn(inputs, mesh) -> dict:
    """The head's BatchNorm in training mode on this rank's slice: output,
    input gradient, the parameter gradients summed over the ranks (the
    global batch's), the running statistics."""
    from quber_tpu_torch.models.layers import BatchNorm, sync_batch_norm
    from quber_tpu_torch.parallel.mesh import all_reduce_grads, shard_batch

    x, gy = (shard_batch(_t(inputs[k]), mesh) for k in ("x", "gy"))
    bn = BatchNorm(x.shape[1])
    bn.load_state_dict({k: _t(inputs[k]) for k in
                        ("weight", "bias", "running_mean", "running_var")})
    sync_batch_norm(bn, mesh).train()
    x.requires_grad_(True)
    y = bn(x)
    (y * gy).sum().backward()
    all_reduce_grads([bn.weight, bn.bias], mesh)
    return {"y": _np(y), "x_grad": _np(x.grad), "weight_grad": _np(bn.weight.grad),
            "bias_grad": _np(bn.bias.grad), "running_mean": _np(bn.running_mean),
            "running_var": _np(bn.running_var)}


def case_losses(inputs, mesh) -> dict:
    """Each loss's share on this rank's slice, its sum over the ranks, and
    the gradient of the share in the rank's predictions."""
    from quber_tpu_torch.models import mask_refiner as M
    from quber_tpu_torch.parallel.mesh import all_reduce_sum, shard_batch

    b = {k: shard_batch(_t(v), mesh) for k, v in inputs.items()}
    out = {}
    runs = {
        "fg_top1": ("fg", lambda p: M.foreground_loss(p, b["sem_seg"], b["sem_w"], 1.0, mesh)),
        "fg_top02": ("fg", lambda p: M.foreground_loss(p, b["sem_seg"], b["sem_w"], 0.2, mesh)),
        "mse": ("center", lambda p: M.weighted_mse_loss(p, b["center_t"], b["center_w"], mesh)),
        "l1": ("offset", lambda p: M.weighted_l1_loss(p, b["offset_t"], b["offset_w"][:, None],
                                                      mesh)),
        "dice": ("eee", lambda p: M.dice_loss(p, b["eee_t"], mesh=mesh)),
    }
    for name, (key, fn) in runs.items():
        pred = b[key].clone().requires_grad_(True)
        share = fn(pred)
        share.backward()
        out[f"{name}_share"] = _np(share)
        out[f"{name}_global"] = _np(all_reduce_sum(share.detach(), mesh))
        out[f"{name}_grad"] = _np(pred.grad)
    return out


def _state(mesh, train=TRAIN):
    from quber_tpu_torch.config import TrainConfig
    from quber_tpu_torch.models.mask_refiner import MaskRefinerConfig
    from quber_tpu_torch.train.loop import create_train_state

    return create_train_state(MaskRefinerConfig(**CFG), TrainConfig(**train), device="cpu",
                              mesh=mesh)


def _snapshot(state, metrics, tag) -> dict:
    out = {f"{tag}/metric/{k}": _np(v) for k, v in metrics.items()}
    out.update({f"{tag}/state/{k}": _np(v) for k, v in state.model.state_dict().items()})
    names = {p: n for n, p in state.model.named_parameters()}
    out.update({f"{tag}/exp_avg/{names[p]}": _np(st["exp_avg"])
                for p, st in state.optimizer.state.items()})
    return out


def case_train(inputs, mesh) -> dict:
    """STEPS steps of train.loop.make_train_step on this rank's slice."""
    from quber_tpu_torch.models.mask_refiner import MaskRefinerConfig
    from quber_tpu_torch.parallel.mesh import put_batch
    from quber_tpu_torch.train.loop import make_train_step

    state = _state(mesh)
    step = make_train_step(MaskRefinerConfig(**CFG), mesh)
    batch = put_batch({k: _t(v) for k, v in inputs.items()}, mesh)
    out = {}
    for i in range(STEPS):
        state, metrics = step(state, batch)
        out.update(_snapshot(state, metrics, f"step{i + 1}"))
    return out


def case_control(inputs, mesh) -> dict:
    """The per-rank step a plain DDP port would take: local BatchNorm
    moments, local loss normalisers, gradients averaged over the ranks."""
    import torch

    from quber_tpu_torch.models.mask_refiner import MaskRefinerConfig, compute_losses
    from quber_tpu_torch.parallel.mesh import all_reduce_grads, put_batch

    cfg = MaskRefinerConfig(**CFG)
    state = _state(None)
    batch = put_batch({k: _t(v) for k, v in inputs.items()}, mesh)
    state.model.train()
    out = state.model(batch["image"], batch["offset_enc"], full_res=False)
    losses = compute_losses(out, batch, cfg)
    total = sum(losses.values())
    state.optimizer.zero_grad(set_to_none=True)
    total.backward()
    all_reduce_grads(list(state.model.parameters()), mesh, average=True)
    for group in state.optimizer.param_groups:
        group["lr"] = state.schedule(0)
    state.optimizer.step()
    metrics = {k: v.detach() for k, v in losses.items()}
    metrics["total_loss"] = total.detach()
    values = torch.stack(list(metrics.values()))
    torch.distributed.all_reduce(values)
    return _snapshot(state, dict(zip(metrics, values / mesh.world_size)), "step1")


def case_device(inputs, mesh) -> dict:
    """One device-target step on this rank's slice of DevicePool's first
    global batch (the pool of inputs["bufs"])."""
    from quber_tpu_torch.config import TrainConfig
    from quber_tpu_torch.models.mask_refiner import MaskRefinerConfig
    from quber_tpu_torch.train.device_targets import DevicePool, make_device_target_step

    tc = TrainConfig(**TRAIN)
    pool = DevicePool(inputs["bufs"], tc.batch_size, tc.seed, "cpu", mesh=mesh)
    bufs = pool.next_batch()
    state = _state(mesh)
    step = make_device_target_step(MaskRefinerConfig(**CFG), tc, SLOTS, mesh=mesh)
    state, metrics = step(state, bufs)
    out = _snapshot(state, metrics, "step1")
    out["bufs"] = _np(bufs)
    return out


def case_eee(inputs, mesh) -> dict:
    """One train_eee step (dice-CE, AdamW) of the late-fusion model from the
    seeded init of inputs["seed"], over the global batch."""
    import itertools

    import torch

    from quber_tpu_torch.models.late_fusion import LateFusionEncoderDecoder
    from quber_tpu_torch.train.eee_train import train_eee

    model = LateFusionEncoderDecoder()
    model.reset_parameters(torch.Generator().manual_seed(int(inputs["seed"])))
    batch = {k: _t(v) for k, v in inputs.items() if k != "seed"}
    _, metrics = train_eee(model, itertools.repeat(batch), 1, EEE_LR, EEE_DECAY, "dicece",
                           mesh=mesh, log_every=0, seed=None)
    out = {f"metric/{k}": _np(v) for k, v in metrics.items()}
    for name, p in model.named_parameters():
        out[f"param/{name}"] = _np(p)
        out[f"grad/{name}"] = _np(p.grad)
    return out


CASES = {"collectives": case_collectives, "bn": case_bn, "losses": case_losses, "train": case_train, "control": case_control,
         "device": case_device, "eee": case_eee}


def main(argv) -> int:
    path, out_dir, rank, world, init, *cases = argv
    import torch

    torch.set_num_threads(1)
    from quber_tpu_torch.parallel.mesh import initialize_multihost, make_mesh, shutdown

    initialize_multihost(init, int(world), int(rank), backend="gloo")
    mesh = make_mesh("cpu")
    with np.load(path) as f:
        inputs = {k: f[k] for k in f.files}
    results = {}
    for name in cases:
        for k, v in CASES[name](_case(inputs, name), mesh).items():
            results[f"{name}/{k}"] = v
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **results)
    shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

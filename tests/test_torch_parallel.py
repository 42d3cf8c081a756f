"""The port's data-parallel building blocks (quber_tpu_torch/parallel/mesh.py,
the synchronised BatchNorm and the global loss normalisers) on two gloo
ranks on the CPU, against the one-process computation on the whole batch
and against the JAX package jitted over a 2-device virtual mesh.

The ranks are subprocesses (tests/torch_parallel_worker.py, one thread
each, a file rendezvous), run once for the module. The batch's two halves
differ in scale and in foreground share, so that per-rank moments or
normalisers would show. Tolerances: values and gradients rtol 1e-5 of the
largest (float32 sums in another order), running statistics 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from quber_tpu.models import mask_refiner as JM
from quber_tpu.parallel.mesh import make_mesh as jax_mesh
from quber_tpu.parallel.mesh import put_batch as jax_put
from quber_tpu_torch.models import mask_refiner as TM
from quber_tpu_torch.models.layers import BatchNorm, sync_batch_norm
from quber_tpu_torch.parallel import mesh as P

import torch_parallel_worker as worker

B, C, HB, WB = 4, 8, 5, 6
H = W = 16
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _halves(x, scale=4.0, shift=3.0):
    """The second half of the batch scaled and shifted."""
    x = x.copy()
    x[len(x) // 2:] = x[len(x) // 2:] * scale + shift
    return x


def _inputs():
    rng = np.random.RandomState(0)
    inp = {
        "collectives/x": rng.randn(2, 3).astype(np.float32),
        "collectives/c": rng.randn(2, 3).astype(np.float32),
        "bn/x": _halves(rng.randn(B, C, HB, WB).astype(np.float32)),
        "bn/gy": rng.randn(B, C, HB, WB).astype(np.float32),
        "bn/weight": (rng.rand(C) + 0.5).astype(np.float32),
        "bn/bias": rng.randn(C).astype(np.float32),
        "bn/running_mean": rng.randn(C).astype(np.float32),
        "bn/running_var": (rng.rand(C) + 0.5).astype(np.float32),
    }
    # foreground share 0.1 on rank 0's frames, 0.8 on rank 1's
    share = np.repeat([0.1, 0.8], B // 2)[:, None, None]
    fg = (rng.rand(B, H, W) < share).astype(np.float32)
    eee_t = np.moveaxis(np.eye(2, dtype=np.float32)[(rng.rand(B, H, W) < share).astype(int)],
                        -1, 1)
    inp.update({
        "losses/fg": _halves(rng.randn(B, H, W).astype(np.float32)),
        "losses/sem_seg": fg,
        "losses/sem_w": rng.choice([1.0, 3.0], size=(B, H, W)).astype(np.float32),
        "losses/center": rng.rand(B, H, W).astype(np.float32),
        "losses/center_t": _halves(rng.rand(B, H, W).astype(np.float32)),
        "losses/center_w": fg,
        "losses/offset": rng.randn(B, 2, H, W).astype(np.float32),
        "losses/offset_t": _halves(rng.randn(B, 2, H, W).astype(np.float32)),
        "losses/offset_w": fg,
        "losses/eee": _halves(rng.randn(B, 2, H, W).astype(np.float32)),
        "losses/eee_t": np.ascontiguousarray(eee_t),
    })
    return inp


@pytest.fixture(scope="module")
def run():
    inputs = _inputs()
    return inputs, worker.run_ranks(inputs, ["collectives", "bn", "losses"])


def _cat(ranks, key):
    return np.concatenate([r[key] for r in ranks])


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-30))


def _jax_sharded(fn, *arrays):
    """`fn` jitted over arrays sharded on the batch axis of a 2-device mesh."""
    mesh = jax_mesh(jax.devices()[:2])
    return jax.jit(fn)(*jax_put(tuple(arrays), mesh))


# --- the mesh API ----------------------------------------------------------------

def test_mesh_api_slices_and_refuses():
    mesh = P.make_mesh(["cpu", "cpu"])
    assert mesh.world_size == 1 and mesh.rank == 0 and not mesh.distributed
    assert mesh.devices == (torch.device("cpu"),) * 2 and mesh.axis_name == "data"
    x = np.arange(12).reshape(6, 2)
    batch = {"a": x, "b": torch.from_numpy(x.copy())}
    # one process: this rank's slice is the whole batch, and the local
    # shard goes as it is: put_batch_local_shard equals put_batch
    a, b = P.put_batch(batch, mesh), P.put_batch_local_shard(batch, mesh)
    assert all(torch.equal(a[k], b[k]) and torch.equal(a[k], torch.from_numpy(x))
               for k in batch)
    parts = P.split_batch(batch, mesh)
    assert [p["a"].tolist() for p in parts] == [x[:3].tolist(), x[3:].tolist()]
    three = P.Mesh((torch.device("cpu"),), group=object(), rank=1, world_size=3)
    assert three.distributed and P.shard_batch(x, three).tolist() == x[2:4].tolist()
    with pytest.raises(ValueError, match="divide"):
        P.shard_batch(x[:5], three)
    with pytest.raises(ValueError, match="divide"):
        P.split_batch(x[:5], mesh)
    with pytest.raises(NotImplementedError, match="item 12b"):
        P.make_mesh_2d(["cpu"], space=2)
    assert P.make_mesh_2d(["cpu"], space=1).devices == (torch.device("cpu"),)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            P.make_mesh()
    # the seeds of the ranks' own draws: rank 0 keeps the seed
    assert P.rank_seed(7, None) == P.rank_seed(7, mesh) == 7
    assert len({P.rank_seed(7, P.Mesh((torch.device("cpu"),), object(), r, 3))
                for r in range(3)}) == 3
    # a copied module keeps the mesh (its process group is no value to copy)
    import copy

    bn = sync_batch_norm(BatchNorm(4), three)
    assert copy.deepcopy(bn).mesh is three


def test_collectives_against_one_process(run):
    inputs, ranks = run
    x, c = inputs["collectives/x"], inputs["collectives/c"]
    y = (x * x).sum(axis=0)
    for r, res in enumerate(ranks):
        _close(res["collectives/y"], y)
        # d/dx_r of sum over ranks of sum(y * c_r') = 2 x_r * sum over r' of c_r'
        _close(res["collectives/x_grad"], 2 * x[r] * c.sum(axis=0))
        assert res["collectives/sizes"].tolist() == [1, 2]
        assert res["collectives/gathered"].tolist() == np.concatenate([x[0, :1], x[1, :2]]).tolist()


# --- BatchNorm -------------------------------------------------------------------

def _torch_bn_one_process(inputs):
    bn = BatchNorm(C)
    bn.load_state_dict({k: torch.from_numpy(inputs[f"bn/{k}"]) for k in
                        ("weight", "bias", "running_mean", "running_var")})
    bn.train()
    x = torch.from_numpy(inputs["bn/x"]).requires_grad_(True)
    y = bn(x)
    (y * torch.from_numpy(inputs["bn/gy"])).sum().backward()
    return {"y": y.detach().numpy(), "x_grad": x.grad.numpy(),
            "weight_grad": bn.weight.grad.numpy(), "bias_grad": bn.bias.grad.numpy(),
            "running_mean": bn.running_mean.numpy(), "running_var": bn.running_var.numpy()}


def _jax_bn(inputs):
    """flax's BatchNorm as the JAX package builds it (layers.make_norm("BN",
    train=True): axis_name None) under jit over the sharded batch."""
    module = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    nhwc = lambda a: np.ascontiguousarray(np.moveaxis(a, 1, -1))  # noqa: E731
    variables = {"params": {"scale": inputs["bn/weight"], "bias": inputs["bn/bias"]},
                 "batch_stats": {"mean": inputs["bn/running_mean"],
                                 "var": inputs["bn/running_var"]}}

    def fn(x, gy):
        def loss(params, x):
            y, upd = module.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                  x, mutable=["batch_stats"])
            return jnp.sum(y * gy), (y, upd["batch_stats"])

        (_, (y, stats)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            variables["params"], x)
        return y, gx, gp, stats

    y, gx, gp, stats = _jax_sharded(fn, nhwc(inputs["bn/x"]), nhwc(inputs["bn/gy"]))
    nchw = lambda a: np.moveaxis(np.asarray(a), -1, 1)  # noqa: E731
    return {"y": nchw(y), "x_grad": nchw(gx), "weight_grad": np.asarray(gp["scale"]),
            "bias_grad": np.asarray(gp["bias"]), "running_mean": np.asarray(stats["mean"]),
            "running_var": np.asarray(stats["var"])}


@pytest.mark.parametrize("reference", ["one_process", "jax_mesh"])
def test_synchronised_batch_norm(run, reference):
    """Forward, input and parameter gradients and running statistics of the
    two ranks' BatchNorm against one process on the whole batch and against
    flax's BatchNorm jitted over a 2-device mesh (its moments are the global
    batch's although its axis_name is None); both ranks hold the same
    parameter gradients and statistics."""
    inputs, ranks = run
    want = _torch_bn_one_process(inputs) if reference == "one_process" else _jax_bn(inputs)
    _close(_cat(ranks, "bn/y"), want["y"])
    _close(_cat(ranks, "bn/x_grad"), want["x_grad"])
    for k in ("weight_grad", "bias_grad"):
        _close(ranks[0][f"bn/{k}"], want[k])
        assert np.array_equal(ranks[0][f"bn/{k}"], ranks[1][f"bn/{k}"])
    for k in ("running_mean", "running_var"):
        np.testing.assert_allclose(ranks[0][f"bn/{k}"], want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
        assert np.array_equal(ranks[0][f"bn/{k}"], ranks[1][f"bn/{k}"])
    # the control: each rank's own moments give another output
    local = np.concatenate([_torch_bn_one_process({**inputs, "bn/x": half, "bn/gy": gy})["y"]
                            for half, gy in zip(np.split(inputs["bn/x"], 2),
                                                np.split(inputs["bn/gy"], 2))])
    assert np.abs(local - want["y"]).max() > 100 * RTOL * np.abs(want["y"]).max()


# --- the loss normalisers ---------------------------------------------------------

LOSSES = {
    "fg_top1": ("fg", lambda m, p, b: m.foreground_loss(p, b["sem_seg"], b["sem_w"], 1.0)),
    "fg_top02": ("fg", lambda m, p, b: m.foreground_loss(p, b["sem_seg"], b["sem_w"], 0.2)),
    "mse": ("center", lambda m, p, b: m.weighted_mse_loss(p, b["center_t"], b["center_w"])),
    "l1": ("offset", None),
    "dice": ("eee", lambda m, p, b: m.dice_loss(p, b["eee_t"])),
}


def _loss_inputs(inputs):
    return {k.split("/", 1)[1]: v for k, v in inputs.items() if k.startswith("losses/")}


def _torch_loss(name, b):
    key, fn = LOSSES[name]
    t = {k: torch.from_numpy(v) for k, v in b.items()}
    pred = t[key].clone().requires_grad_(True)
    if name == "l1":
        loss = TM.weighted_l1_loss(pred, t["offset_t"], t["offset_w"][:, None])
    else:
        loss = fn(TM, pred, t)
    loss.backward()
    return float(loss.detach()), pred.grad.numpy()


def _jax_loss(name, b):
    """The JAX package's loss (channels last) jitted over the sharded batch."""
    key, fn = LOSSES[name]
    last = {k: np.ascontiguousarray(np.moveaxis(v, 1, -1)) if v.ndim == 4 else v
            for k, v in b.items()}
    names = sorted(last)

    def loss(pred, *arrays):
        a = dict(zip(names, arrays))
        if name == "l1":
            return JM.weighted_l1_loss(pred, a["offset_t"], a["offset_w"][..., None])
        return fn(JM, pred, a)

    value, grad = _jax_sharded(jax.value_and_grad(loss), last[key], *(last[k] for k in names))
    grad = np.asarray(grad)
    return float(value), np.moveaxis(grad, -1, 1) if grad.ndim == 4 else grad


@pytest.mark.parametrize("name", list(LOSSES))
def test_global_loss_normalisers(run, name):
    """Each rank's share of foreground_loss (top_k 1.0 and 0.2), the
    weighted centre / offset losses and dice: the shares sum to the one
    process's loss and to the JAX package's over the 2-device mesh, and the
    gradient of each share in the rank's predictions is the global loss's
    gradient there. A per-rank loss (each rank's own normaliser, averaged)
    reads otherwise."""
    inputs, ranks = run
    b = _loss_inputs(inputs)
    value, grad = _torch_loss(name, b)
    jvalue, jgrad = _jax_loss(name, b)
    assert value == pytest.approx(jvalue, rel=RTOL)
    _close(grad, jgrad)
    shares = [float(r[f"losses/{name}_share"]) for r in ranks]
    for r in ranks:
        assert float(r[f"losses/{name}_global"]) == pytest.approx(value, rel=RTOL)
    assert sum(shares) == pytest.approx(value, rel=RTOL)
    _close(_cat(ranks, f"losses/{name}_grad"), grad)
    per_rank = np.mean([_torch_loss(name, {k: v[i * B // 2:(i + 1) * B // 2]
                                           for k, v in b.items()})[0] for i in range(2)])
    if name not in ("fg_top1", "dice"):  # plain means over equal shards agree
        assert abs(per_rank - value) > 1e-3 * abs(value), name

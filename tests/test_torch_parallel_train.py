"""Data-parallel training of the port (train/loop.py, train/device_targets.py,
train/eee_train.py under a parallel.mesh.Mesh) on two gloo ranks on the CPU
against the JAX package's steps jitted over a 2-device virtual mesh and
against the port's one-process step on the whole batch.

At tests/test_torch_train.py's sizes (32x32, depth 14, dropout 0, 8 slots),
a global batch of 4 (2 a rank) whose halves differ in image scale, in
foreground share and in centre targets. The ranks (subprocesses of
tests/torch_parallel_worker.py, one thread each) start from the port's
seeded init, which is carried to JAX. Tolerances are test_torch_train.py's:
losses rtol 1e-4; Adam's first moment (0.1 g after a step) within 15% of
each tensor's norm; updated parameters within 2.1 learning rates, and
within 2% of one on 99% of the elements whose gradient is sure; BatchNorm
statistics rtol 1e-4, atol 1e-5. Both ranks hold bit-equal states after
every step. The control, a plain per-rank step (local BatchNorm moments,
local normalisers, gradients averaged), must fail them on the same batch.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from quber_tpu.config import TrainConfig as JTrainConfig
from quber_tpu.data.synthetic import synthetic_records as jax_synthetic_records
from quber_tpu.models import late_fusion as JL
from quber_tpu.models.mask_refiner import MaskRefinerConfig as JConfig
from quber_tpu.parallel.mesh import make_mesh as jax_mesh
from quber_tpu.parallel.mesh import put_batch as jax_put
from quber_tpu.train import device_targets as JDT
from quber_tpu.train import eee_train as JE
from quber_tpu.train import loop as JLoop
from quber_tpu.train import optim as JOptim
from quber_tpu_torch.config import TrainConfig
from quber_tpu_torch.models import late_fusion as TL
from quber_tpu_torch.models.from_jax import state_dict_from_jax, state_dict_to_jax
from quber_tpu_torch.models.layers import BatchNorm, ConvNorm
from quber_tpu_torch.models.mask_refiner import MaskRefinerConfig
from quber_tpu_torch.train.device_targets import DevicePool, make_device_target_step
from quber_tpu_torch.train.loop import create_train_state, make_train_step

import torch_parallel_worker as worker

CFG, TRAIN, SLOTS = worker.CFG, worker.TRAIN, worker.SLOTS
B, H, W = TRAIN["batch_size"], worker.H, worker.W
LOSS_RTOL = 1e-4
POOL = 6
EEE_H, EEE_W = 32, 48


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch():
    """NCHW global batch: rank 1's half dimmer and shifted, with 0.75 of its
    pixels foreground against rank 0's 0.15, and centre targets 3x."""
    rng = np.random.RandomState(3)
    share = np.repeat([0.15, 0.75], B // 2)[:, None, None]
    fg = (rng.rand(B, H, W) < share).astype(np.float32)
    image = (rng.rand(B, 6, H, W) * 255).astype(np.float32)
    image[B // 2:] = image[B // 2:] * 0.25 + 40.0
    center = rng.rand(B, H, W).astype(np.float32)
    center[B // 2:] *= 3.0
    onehot = lambda: np.ascontiguousarray(np.moveaxis(  # noqa: E731
        np.eye(2, dtype=np.float32)[(rng.rand(B, H, W) < share).astype(int)], -1, 1))
    return {
        "image": image, "offset_enc": rng.rand(B, 3, H, W).astype(np.float32),
        "sem_seg": fg,
        "sem_seg_weights": rng.choice([1.0, 3.0], size=(B, H, W)).astype(np.float32),
        "center": center, "center_weights": fg,
        "offset": (rng.randn(B, 2, H, W) * np.repeat([1.0, 4.0], B // 2)[:, None, None, None]
                   ).astype(np.float32),
        "offset_weights": fg, "eee_mask": onehot(), "eee_boundary": onehot(),
    }


def _eee_batch():
    rng = np.random.RandomState(4)
    batch = {name: rng.randn(B, c, EEE_H, EEE_W).astype(np.float32) for name, c in TL.MODALITIES}
    batch["rgb"][B // 2:] = batch["rgb"][B // 2:] * 4.0 + 2.0
    for head in ("mask_target", "boundary_target"):
        batch[head] = np.ascontiguousarray(np.moveaxis(
            np.eye(3, dtype=np.float32)[rng.randint(0, 3, (B, EEE_H, EEE_W))], -1, 1))
    return batch


def _pool():
    mapper = JDT.PackedMapper(JTrainConfig(**TRAIN), JConfig(**CFG), n_slots=SLOTS)
    return np.stack([mapper(r)["packed"] for r in jax_synthetic_records(POOL, H, W, seed=1)])


def _nhwc(batch):
    return {k: np.ascontiguousarray(np.moveaxis(v, 1, -1)) if v.ndim == 4 else v
            for k, v in batch.items()}


def _numpy_tree(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        d = out
        keys = [str(getattr(k, "key", getattr(k, "name", k))) for k in path]
        for k in keys[:-1]:
            d = d.setdefault(k, {})
        d[keys[-1]] = np.asarray(leaf)
    return out


def _jax_snapshot(state, metrics):
    adam = state.opt_state.inner_states["train"].inner_state[0]
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "state": state_dict_from_jax({"params": _numpy_tree(state.params),
                                          "batch_stats": _numpy_tree(state.batch_stats)}),
            "mu": state_dict_from_jax({"params": _numpy_tree(adam.mu)})}


@pytest.fixture(scope="module")
def init():
    """The port's seeded initial state (every rank's) as a JAX TrainState."""
    state = create_train_state(MaskRefinerConfig(**CFG), TrainConfig(**TRAIN), device="cpu")
    tree = state_dict_to_jax(state.model)
    jtc = JTrainConfig(**TRAIN)
    tx = JOptim.build_optimizer(jtc, tree["params"])
    jstate = JLoop.TrainState(jnp.zeros((), jnp.int32), tree["params"], tree["batch_stats"],
                              tx.init(tree["params"]))
    lr = [float(JOptim.warmup_poly_schedule(
        jtc.base_lr, jtc.max_iter, jtc.poly_power, jtc.warmup_iters, jtc.warmup_factor)(i))
        for i in range(2)]
    return {"jstate": jstate, "tx": tx, "lr": lr,
            "skip": {f"{n}.conv.bias" for n, m in state.model.named_modules()
                     if isinstance(m, ConvNorm) and isinstance(m.norm, BatchNorm)
                     and m.conv.bias is not None}}


@pytest.fixture(scope="module")
def launched():
    """The two ranks, started before the JAX references compile."""
    inputs = {f"{case}/{k}": v for case in ("train", "control") for k, v in _batch().items()}
    inputs["device/bufs"] = _pool()
    inputs.update({f"eee/{k}": v for k, v in _eee_batch().items()})
    inputs["eee/seed"] = np.asarray(2)
    return worker.Ranks(inputs, ["train", "control", "device", "eee"])


@pytest.fixture(scope="module")
def reference(init, launched):
    """The JAX package's steps over a 2-device mesh: two train steps, one
    device-target step on DevicePool's first global batch, one late-fusion
    step."""
    mesh = jax_mesh(jax.devices()[:2])
    jcfg, jtc = JConfig(**CFG), JTrainConfig(**TRAIN)
    key = jax.random.PRNGKey(0)
    batch = jax_put(_nhwc(_batch()), mesh)
    step = JLoop.make_train_step(jcfg, jtc, init["tx"], mesh, donate=False)
    s1, m1 = step(init["jstate"], batch, key)
    s2, m2 = step(s1, batch, key)
    pool = _pool()
    bufs = DevicePool(pool, B, TrainConfig(**TRAIN).seed, "cpu").next_batch().numpy()
    dstep = JDT.make_device_target_step(jcfg, jtc, init["tx"], mesh, n_slots=SLOTS, donate=False)
    d1, dm1 = dstep(init["jstate"], jax_put(bufs, mesh), key)

    model = TL.LateFusionEncoderDecoder()
    model.reset_parameters(torch.Generator().manual_seed(2))
    params0 = state_dict_to_jax(model)
    import optax

    tx = optax.adamw(worker.EEE_LR, weight_decay=worker.EEE_DECAY)
    eee = JE.make_eee_train_step(JL.LateFusionEncoderDecoder(), tx, "dicece", mesh)
    p1, opt, em = eee(params0, tx.init(params0), jax_put(_nhwc(_eee_batch()), mesh))
    return {"step1": _jax_snapshot(s1, m1), "step2": {"metrics": {k: float(v) for k, v in
                                                                   m2.items()}},
            "device1": _jax_snapshot(d1, dm1), "bufs": bufs, "pool": pool,
            "eee": {"metrics": {k: float(v) for k, v in em.items()},
                    "params": state_dict_from_jax(jax.tree.map(np.asarray, p1)),
                    "grads": state_dict_from_jax(jax.tree.map(
                        lambda m: np.asarray(m) / np.float32(0.1), opt[0].mu))}}


@pytest.fixture(scope="module")
def ranks(reference, launched):
    return launched.results()


def _rank_snapshot(res, tag):
    def part(kind):
        prefix = f"{tag}/{kind}/"
        return {k[len(prefix):]: torch.from_numpy(v) for k, v in res.items()
                if k.startswith(prefix)}

    return {"metrics": {k: float(v) for k, v in part("metric").items()},
            "state": part("state"), "mu": part("exp_avg")}


def _rel_l2(got, want):
    return float((got.double() - want.double()).norm() / want.double().norm())


def _violations(got, want, lr, skip):
    """The checks of test_torch_train.py that `got` fails against `want`."""
    bad = []
    for k, v in want["metrics"].items():
        if not abs(got["metrics"][k] - v) <= LOSS_RTOL * abs(v):
            bad.append(f"loss {k}")
    for name, mu in want["mu"].items():
        if name not in skip and _rel_l2(got["mu"][name], mu) > 0.15:
            bad.append(f"first moment {name}")
    for name, w in want["state"].items():
        g = got["state"][name]
        if name.endswith(("running_mean", "running_var")):
            if not np.allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-5):
                bad.append(f"statistics {name}")
            continue
        if name not in want["mu"]:
            continue
        if (g - w).abs().max() > 2.1 * lr:
            bad.append(f"parameter {name}")
        elif name not in skip:
            grad = want["mu"][name]
            sure = grad.abs() > 0.25 * grad.square().mean().sqrt()
            if float(((g[sure] - w[sure]).abs() <= 0.02 * lr).float().mean()) < 0.99:
                bad.append(f"parameter {name}")
    assert set(want["metrics"]) == set(got["metrics"]) and len(want["mu"]) > 100
    return bad


def _assert_ranks_equal(ranks, prefix):
    keys = [k for k in ranks[0] if k.startswith(prefix)]
    assert keys and set(keys) == {k for k in ranks[1] if k.startswith(prefix)}
    for k in keys:
        assert np.array_equal(ranks[0][k], ranks[1][k]), k


def test_train_step_matches_jax_mesh(init, reference, ranks):
    """make_train_step over two ranks against JAX's make_train_step over a
    2-device mesh: step 1's losses, first moments, parameters and BatchNorm
    statistics, step 2's losses (rtol 1e-3, as test_torch_train.py: the
    parameters differ by up to two rates where the first gradient was ~0);
    both ranks bit-equal after each step."""
    got = _rank_snapshot(ranks[0], "train/step1")
    assert _violations(got, reference["step1"], init["lr"][0], init["skip"]) == []
    for k, v in reference["step2"]["metrics"].items():
        assert float(ranks[0][f"train/step2/metric/{k}"]) == pytest.approx(v, rel=1e-3), k
    _assert_ranks_equal(ranks, "train/")


def test_train_step_matches_one_process(init, ranks):
    """The two ranks' step against the port's step on the whole batch in one
    process."""
    state = create_train_state(MaskRefinerConfig(**CFG), TrainConfig(**TRAIN), device="cpu")
    step = make_train_step(MaskRefinerConfig(**CFG))
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    _, metrics = step(state, batch)
    names = {p: n for n, p in state.model.named_parameters()}
    want = {"metrics": {k: float(v) for k, v in metrics.items()},
            "state": state.model.state_dict(),
            "mu": {names[p]: s["exp_avg"] for p, s in state.optimizer.state.items()}}
    got = _rank_snapshot(ranks[1], "train/step1")
    assert _violations(got, want, init["lr"][0], init["skip"]) == []


def test_per_rank_control_fails(init, reference, ranks):
    """A plain per-rank step on the same batch fails the tolerances the
    global step meets: its losses, and its BatchNorm statistics."""
    bad = _violations(_rank_snapshot(ranks[0], "control/step1"), reference["step1"],
                      init["lr"][0], init["skip"])
    assert any(b.startswith("loss ") for b in bad), bad
    assert any(b.startswith("statistics ") for b in bad), bad


def test_device_target_step_and_pool(init, reference, ranks):
    """DevicePool gives each rank its contiguous half of the one-rank global
    batch; make_device_target_step over two ranks against JAX's
    device-target step over the 2-device mesh on that batch; ranks
    bit-equal."""
    got_bufs = np.concatenate([r["device/bufs"] for r in ranks])
    assert np.array_equal(got_bufs, reference["bufs"])
    assert not np.array_equal(reference["bufs"], reference["pool"][:B])  # shuffled
    got = _rank_snapshot(ranks[0], "device/step1")
    assert _violations(got, reference["device1"], init["lr"][0], init["skip"]) == []
    _assert_ranks_equal(ranks, "device/step1/")
    # the same step in one process, from the same pool's first batch
    state = create_train_state(MaskRefinerConfig(**CFG), TrainConfig(**TRAIN), device="cpu")
    step = make_device_target_step(MaskRefinerConfig(**CFG), TrainConfig(**TRAIN), SLOTS)
    _, metrics = step(state, torch.from_numpy(reference["bufs"]))
    for k, v in metrics.items():
        assert got["metrics"][k] == pytest.approx(float(v), rel=LOSS_RTOL), k


def test_eee_step_matches_jax_mesh(reference, ranks):
    """train_eee over two ranks (dice-CE, AdamW) against the JAX package's
    make_eee_train_step over the 2-device mesh: metrics rtol 1e-5,
    gradients within 1e-4 of each tensor's norm, updated weights within
    1e-6 where the gradient is above a thousandth of the largest (as
    tests/test_torch_late_fusion.py); both ranks bit-equal."""
    want = reference["eee"]
    for k, v in want["metrics"].items():
        assert float(ranks[0][f"eee/metric/{k}"]) == pytest.approx(v, rel=1e-5), k
    grads = want["grads"]
    noise = 1e-3 * max(float(g.norm()) for g in grads.values())
    compared = 0
    for name, g in grads.items():
        if float(g.norm()) <= noise:
            continue
        got = torch.from_numpy(ranks[0][f"eee/grad/{name}"])
        assert float((got - g).norm()) <= 1e-4 * float(g.norm()), name
        big = g.abs() > noise
        np.testing.assert_allclose(ranks[0][f"eee/param/{name}"][big.numpy()],
                                   want["params"][name][big].numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)
        compared += 1
    assert compared > 50
    _assert_ranks_equal(ranks, "eee/")

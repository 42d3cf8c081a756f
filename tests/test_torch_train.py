"""The training slice as a whole: schedule, freezing, train steps, Adam
moments, checkpoints, the export back to the reference and the CLI of the
torch port against quber_tpu.

The reference side (depth 14, 32x32, batch 2, dropout 0: dropout masks
cannot match across frameworks) is computed once per module. Parameters
cross through from_jax. Tolerances: losses rtol 1e-4. Gradients (read off
Adam's first moment, 0.1 * g after one step) and moments: 15% of each
tensor's norm (cosine >= 0.99), 30% for the second moment. They are not
tighter because activations agree to ~1e-5 only, so among the ~16 k outputs
of a layer one ReLU now and then sits on the other side of zero, and one
such element moves the gradient of every tensor upstream by 2-4% of its
norm (seen in one case between the port's float32 run and its own float64
run, which agreed with the reference; up to 5% was seen in a tensor, and
the bound leaves room for several flips). Updated parameters: 2% of a
learning rate on 99% of the elements whose gradient is sure (above a
quarter of the tensor's RMS), since Adam's first update is lr * g / (|g| +
1e-8), whose sign flips with that noise where g is small.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quber_tpu.config import TrainConfig as JTrainConfig
from quber_tpu.data.synthetic import synthetic_records as jax_synthetic_records
from quber_tpu.models.mask_refiner import MaskRefinerConfig as JConfig
from quber_tpu.parallel.mesh import make_mesh, put_batch
from quber_tpu.predictor import MaskRefinerPredictor as JPredictor
from quber_tpu.train import checkpoint as JCkpt
from quber_tpu.train import device_targets as JDT
from quber_tpu.train import loop as JLoop
from quber_tpu.train import optim as JOptim
from quber_tpu_torch.config import TrainConfig
from quber_tpu_torch.data.synthetic import blob_scene
from quber_tpu_torch.models.from_jax import (
    load_optax_adam_state, state_dict_from_jax, state_dict_to_jax)
from quber_tpu_torch.models.layers import BatchNorm, ConvNorm, FrozenBatchNorm
from quber_tpu_torch.models.mask_refiner import MaskRefinerConfig
from quber_tpu_torch.predictor import MaskRefinerPredictor as TPredictor
from quber_tpu_torch.train import checkpoint as TCkpt
from quber_tpu_torch.train import optim as TOptim
from quber_tpu_torch.train.device_targets import make_device_target_step
from quber_tpu_torch.train.loop import create_train_state, make_eval_step, make_train_step

H = W = 32
SLOTS = 8
CFG = dict(height=H, width=W, resnet_depth=14, aspp_dropout=0.0)
TRAIN = dict(batch_size=2, max_iter=100, base_lr=1e-3, warmup_iters=2, warmup_factor=0.5)
LOSS_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def scratch(tmp_path):
    """tmp_path, emptied after the test: the checkpoints here are ~150 MB each."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _numpy_tree(tree):
    """A pytree of jax arrays as nested dicts of numpy arrays; nodes without
    leaves (optax's MaskedNode at frozen leaves) drop out."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        d = out
        keys = [str(getattr(k, "key", getattr(k, "name", k))) for k in path]
        for k in keys[:-1]:
            d = d.setdefault(k, {})
        d[keys[-1]] = np.asarray(leaf)
    return out


def _adam(state):
    adam = state.opt_state.inner_states["train"].inner_state[0]
    return _numpy_tree(adam.mu), _numpy_tree(adam.nu), int(adam.count)


def _snapshot(state, metrics):
    mu, nu, count = _adam(state)
    return {"params": _numpy_tree(state.params), "batch_stats": _numpy_tree(state.batch_stats),
            "mu": mu, "nu": nu, "count": count, "step": int(state.step),
            "metrics": {k: float(v) for k, v in metrics.items()}}


def _tiny_batch(rng, b, h, w):
    fg = (rng.rand(b, h, w) > 0.5).astype(np.float32)
    return {
        "image": (rng.rand(b, h, w, 6) * 255).astype(np.float32),
        "offset_enc": rng.rand(b, h, w, 3).astype(np.float32),
        "sem_seg": fg,
        "sem_seg_weights": rng.choice([1.0, 3.0], size=(b, h, w)).astype(np.float32),
        "center": rng.rand(b, h, w).astype(np.float32),
        "center_weights": fg,
        "offset": rng.randn(b, h, w, 2).astype(np.float32),
        "offset_weights": fg,
        "eee_mask": np.eye(2, dtype=np.float32)[rng.randint(0, 2, (b, h, w))],
        "eee_boundary": np.eye(2, dtype=np.float32)[rng.randint(0, 2, (b, h, w))],
    }


def _torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(np.moveaxis(v, -1, 1) if v.ndim == 4 else v))
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def reference():
    """Two make_train_step steps and one make_device_target_step step of the
    JAX package from one initial state."""
    jcfg, jtc = JConfig(**CFG), JTrainConfig(**TRAIN)
    state, tx = JLoop.create_train_state(jcfg, jtc)
    mesh = make_mesh(jax.devices()[:1])
    key = jax.random.PRNGKey(0)
    batch = _tiny_batch(np.random.RandomState(0), 2, H, W)
    step = JLoop.make_train_step(jcfg, jtc, tx, mesh, donate=False)
    s1, m1 = step(state, put_batch(batch, mesh), key)
    s2, m2 = step(s1, put_batch(batch, mesh), key)
    mapper = JDT.PackedMapper(jtc, jcfg, n_slots=SLOTS)
    bufs = np.stack([mapper(r)["packed"] for r in jax_synthetic_records(2, H, W, seed=1)])
    dstep = JDT.make_device_target_step(jcfg, jtc, tx, mesh, n_slots=SLOTS, donate=False)
    d1, dm1 = dstep(state, jnp.asarray(bufs), key)
    lr = [float(JOptim.warmup_poly_schedule(
        jtc.base_lr, jtc.max_iter, jtc.poly_power, jtc.warmup_iters, jtc.warmup_factor)(i))
        for i in range(2)]
    return {"init": _snapshot(state, {}), "step1": _snapshot(s1, m1), "step2": _snapshot(s2, m2),
            "device1": _snapshot(d1, dm1), "batch": batch, "bufs": bufs, "lr": lr,
            "freeze_mask": _numpy_tree(jax.tree.map(
                lambda t: np.float32(t), JOptim.make_freeze_mask(state.params)))}


def _port_state(snapshot, adam=False):
    """A port train state holding a reference snapshot's parameters and batch
    statistics (and, with `adam`, its moments and step)."""
    state = create_train_state(MaskRefinerConfig(**CFG), TrainConfig(**TRAIN), device="cpu")
    state.model.load_state_dict(state_dict_from_jax(
        {"params": snapshot["params"], "batch_stats": snapshot["batch_stats"]}), strict=True)
    if adam:
        load_optax_adam_state(state.optimizer, state.model, snapshot["mu"], snapshot["nu"],
                              snapshot["count"])
        state.step = snapshot["step"]
    return state


def _zero_grad_biases(model):
    """Conv biases ahead of a BatchNorm that normalises with batch statistics:
    their gradient is exactly zero, so what comes back is float noise."""
    return {f"{name}.conv.bias" for name, mod in model.named_modules()
            if isinstance(mod, ConvNorm) and isinstance(mod.norm, BatchNorm)
            and mod.conv.bias is not None}


def _assert_losses(got, want, rtol=LOSS_RTOL):
    assert set(got) == set(want)
    for k, v in want.items():
        assert float(got[k]) == pytest.approx(v, rel=rtol), k


def _rel_l2(got, want):
    return float((got.double() - want.double()).norm() / want.double().norm())


def _assert_moments(state, snapshot, skip):
    first = state_dict_from_jax({"params": snapshot["mu"]})
    second = state_dict_from_jax({"params": snapshot["nu"]})
    names = {p: n for n, p in state.model.named_parameters()}
    checked = 0
    for p, st in state.optimizer.state.items():
        name = names[p]
        if name in skip:
            continue
        assert _rel_l2(st["exp_avg"], first[name]) <= 0.15, name
        assert _rel_l2(st["exp_avg_sq"], second[name]) <= 0.30, name
        assert int(st["step"]) == snapshot["count"]
        checked += 1
    assert checked == len(first) - len(skip)


def _sure(grad):
    """Elements whose gradient is well away from zero."""
    return grad.abs() > 0.25 * grad.square().mean().sqrt()


def _assert_updated_params(state, before, after, lr, skip):
    """Against the reference's parameters after Adam's first step from
    `before`."""
    got = state.model.state_dict()
    want = state_dict_from_jax({"params": after["params"], "batch_stats": after["batch_stats"]})
    old = state_dict_from_jax({"params": before["params"]})
    grad = state_dict_from_jax({"params": after["mu"]})  # 0.1 * g after the first step
    for name, w in want.items():
        if name not in grad:  # FrozenBN tensors, BatchNorm statistics
            continue
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0, atol=2.1 * lr,
                                   err_msg=name)
        if name in skip:
            continue
        sure = _sure(grad[name])
        assert bool(sure.any()), name
        # (elements next to a flipped ReLU may still change sign: 99%)
        close = (got[name][sure] - w[sure]).abs() <= 0.02 * lr
        assert float(close.float().mean()) >= 0.99, name
        assert bool(((w - old[name])[sure].abs() > 0.9 * lr).all())  # the update is ~lr


# --- schedule and freezing ---------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(base_lr=1e-3, max_iter=1000, warmup_iters=100, warmup_factor=1e-3),
    dict(base_lr=1.25e-4, max_iter=90000),
    dict(base_lr=1e-2, max_iter=50, power=0.5, warmup_iters=0, constant_ending=0.1),
])
def test_warmup_poly_schedule(kw):
    """Steps 0, around the end of the warm-up, and the last: rel 1e-5, and
    1e-6 of the base rate absolute, since the reference computes in float32
    and 1 - t/T cancels at the last steps."""
    ours, ref = TOptim.warmup_poly_schedule(**kw), JOptim.warmup_poly_schedule(**kw)
    warm, last = kw.get("warmup_iters", 1000), kw["max_iter"] - 1
    for step in (0, 1, warm - 1, warm, warm + 1, last // 2, last, last + 1):
        if step >= 0:
            assert ours(step) == pytest.approx(float(ref(step)), rel=1e-5,
                                               abs=1e-6 * kw["base_lr"]), step
    if warm:
        assert ours(0) == pytest.approx(kw["base_lr"] * kw.get("warmup_factor", 1e-3))


def test_init_shapes_dtypes_and_freeze_mask(reference):
    """The seeded init cannot equal flax's values: its tensors have the
    reference's shapes and dtype, and the trainable set is the reference's."""
    state = create_train_state(MaskRefinerConfig(**CFG), TrainConfig(**TRAIN), device="cpu")
    init = reference["init"]
    want = state_dict_from_jax({"params": init["params"], "batch_stats": init["batch_stats"]})
    got = state.model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == torch.float32, k
    ref_mask = {k: bool(v) for k, v in
                state_dict_from_jax({"params": reference["freeze_mask"]}).items()}
    mask = TOptim.make_freeze_mask(state.model)
    assert mask == ref_mask
    in_optimizer = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    for name, p in state.model.named_parameters():
        assert (id(p) in in_optimizer) == p.requires_grad == mask[name], name
    frozen = [n for n, m in state.model.named_modules() if isinstance(m, FrozenBatchNorm)]
    assert frozen and all(TOptim.is_frozen_path(state.model, f"{n}.weight") for n in frozen)
    assert state.step == 0 and state.generator.initial_seed() == TrainConfig(**TRAIN).seed
    # the same seed gives the same init; predictors start at N(0, 0.001)
    again = create_train_state(MaskRefinerConfig(**CFG), TrainConfig(**TRAIN), device="cpu")
    assert all(torch.equal(v, again.model.state_dict()[k]) for k, v in got.items())
    assert float(got["ins_embed_head.center_predictor.weight"].std()) < 2e-3


def test_freeze_backbone_stages_matches_jax():
    """FREEZE_AT = 2: stem and res2 of BOTH trunks get no update at all."""
    mcfg = MaskRefinerConfig(**CFG)
    tcfg = TrainConfig(**{**TRAIN, "freeze_backbone_stages": 2, "optimizer": "sgd"})
    state = create_train_state(mcfg, tcfg, device="cpu")
    frozen = {n for n, p in state.model.named_parameters() if not p.requires_grad}
    assert frozen and all(
        n.split(".")[0] == "backbone" and n.split(".")[2].split("_")[0] in ("stem", "res2")
        for n in frozen)
    for trunk in ("rgb_trunk", "depth_trunk"):
        assert f"backbone.{trunk}.stem.conv1.conv.weight" in frozen
        assert f"backbone.{trunk}.res2_0.conv2.conv.weight" in frozen
        assert f"backbone.{trunk}.res3_0.conv2.conv.weight" not in frozen
    assert "backbone.fusion_res2_reduce.conv.weight" not in frozen
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    batch = _torch_batch(_tiny_batch(np.random.RandomState(1), 2, H, W))
    make_train_step(mcfg)(state, batch)
    after = state.model.state_dict()
    assert all(torch.equal(before[n], after[n]) for n in frozen)
    assert not torch.equal(before["backbone.rgb_trunk.res3_0.conv2.conv.weight"],
                           after["backbone.rgb_trunk.res3_0.conv2.conv.weight"])
    assert TOptim.freeze_backbone_stages(0) is None
    with pytest.raises(ValueError):
        TOptim.build_optimizer(dataclasses.replace(tcfg, optimizer="lion"), state.model)


# --- the slice as a whole ----------------------------------------------------

def test_train_step_matches_jax(reference):
    """Step 1: the reference's losses, gradients (as Adam's first moment),
    updated parameters and new BatchNorm statistics; FrozenBN untouched.
    Step 2: its losses again (rtol 1e-3) at the schedule's second rate."""
    init, s1, s2 = reference["init"], reference["step1"], reference["step2"]
    state = _port_state(init)
    step = make_train_step(MaskRefinerConfig(**CFG))
    batch = _torch_batch(reference["batch"])
    skip = _zero_grad_biases(state.model)
    assert len(skip) == 16
    frozen_before = {k: v.clone() for k, v in state.model.state_dict().items()
                     if TOptim.is_frozen_path(state.model, k)}

    state, metrics = step(state, batch)
    assert state.step == 1
    _assert_losses(metrics, s1["metrics"])
    _assert_moments(state, s1, skip)
    _assert_updated_params(state, init, s1, reference["lr"][0], skip)
    got = state.model.state_dict()
    for name, want in state_dict_from_jax({"batch_stats": s1["batch_stats"]}).items():
        np.testing.assert_allclose(got[name].numpy(), want.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    assert all(torch.equal(v, got[k]) for k, v in frozen_before.items())

    state, metrics = step(state, batch)
    assert state.step == 2
    # the two packages' parameters now differ by up to two learning rates
    # where the first gradient was ~0 (see the module docstring): rtol 1e-3,
    # and the second gradient is held from the reference's own state in
    # test_optax_adam_state_carries_into_the_port
    _assert_losses(metrics, s2["metrics"], rtol=1e-3)
    assert all(int(st["step"]) == 2 for st in state.optimizer.state.values())
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(reference["lr"][1], rel=1e-6)


def test_device_target_step_matches_jax(reference):
    """The packed path: the same uint8 buffers through both device-target
    steps give the reference's losses, gradients and updated parameters."""
    init, d1 = reference["init"], reference["device1"]
    state = _port_state(init)
    step = make_device_target_step(MaskRefinerConfig(**CFG), TrainConfig(**TRAIN), n_slots=SLOTS)
    marks = []
    state, metrics = step(state, torch.from_numpy(reference["bufs"]), marks.append)
    assert marks == ["targets", "forward", "backward", "optimizer"]
    _assert_losses(metrics, d1["metrics"])
    skip = _zero_grad_biases(state.model)
    _assert_moments(state, d1, skip)
    _assert_updated_params(state, init, d1, reference["lr"][0], skip)


def test_optax_adam_state_carries_into_the_port(reference):
    """The reference's state after step 1 (parameters, statistics, moments,
    count) loaded into the port takes the reference's step 2."""
    s1, s2 = reference["step1"], reference["step2"]
    state = _port_state(s1, adam=True)
    state, metrics = make_train_step(MaskRefinerConfig(**CFG))(
        state, _torch_batch(reference["batch"]))
    assert state.step == 2
    _assert_losses(metrics, s2["metrics"])
    skip = _zero_grad_biases(state.model)
    _assert_moments(state, s2, skip)
    got = state.model.state_dict()
    want = state_dict_from_jax({"params": s2["params"]})
    lr = reference["lr"][1]
    grad = state_dict_from_jax({"params": s1["mu"]})
    for name in grad:
        if name not in skip:
            # the second update is lr * m / sqrt(v) with a tenth of the new
            # gradient in m: a quarter of a learning rate where the gradient is
            # sure catches a wrong count or bias correction (0.8 lr off)
            sure = _sure(grad[name])
            close = (got[name][sure] - want[name][sure]).abs() <= 0.25 * lr
            assert float(close.float().mean()) >= 0.99, name


def test_sgd_update_and_eval_step(reference):
    """SGD with momentum 0.9 and L2 in the gradient: p1 = p0 - lr * (g + wd *
    p0), with g from the reference's first moment. The eval step leaves the
    state alone and returns full-resolution outputs."""
    init, s1 = reference["init"], reference["step1"]
    tcfg = TrainConfig(**{**TRAIN, "optimizer": "sgd", "weight_decay": 0.1})
    mcfg = MaskRefinerConfig(**CFG)
    state = create_train_state(mcfg, tcfg, device="cpu")
    state.model.load_state_dict(state_dict_from_jax(
        {"params": init["params"], "batch_stats": init["batch_stats"]}), strict=True)
    batch = _torch_batch(reference["batch"])
    out = make_eval_step(mcfg)(state, batch)
    assert out["offset"].shape == (2, 2, H, W) and not state.model.training
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    make_train_step(mcfg)(state, batch)
    grad = state_dict_from_jax({"params": s1["mu"]})
    lr = reference["lr"][0]
    name = "ins_embed_head.decoder.fuse_res2_0.conv.weight"
    want = -lr * (grad[name] / 0.1 + 0.1 * before[name])
    assert _rel_l2(state.model.state_dict()[name] - before[name], want) <= 0.15


def test_dropout_train_steps_are_reproducible_from_the_seed():
    mcfg = MaskRefinerConfig(**{**CFG, "aspp_dropout": 0.5})
    batch = _torch_batch(_tiny_batch(np.random.RandomState(2), 2, H, W))
    losses = []
    for dropout_seed in (None, None, 8):
        state = create_train_state(mcfg, TrainConfig(**TRAIN), device="cpu")
        if dropout_seed is not None:  # the same init, another dropout stream
            state.generator.manual_seed(dropout_seed)
        step = make_train_step(mcfg)
        losses.append([float(step(state, batch)[1]["total_loss"]) for _ in range(2)])
    assert losses[0] == losses[1]
    assert losses[0] != losses[2]


# --- checkpoints --------------------------------------------------------------

def _trained_state(steps=1):
    mcfg, tcfg = MaskRefinerConfig(**{**CFG, "aspp_dropout": 0.1}), TrainConfig(**TRAIN)
    state = create_train_state(mcfg, tcfg, device="cpu")
    step = make_train_step(mcfg)
    batch = _torch_batch(_tiny_batch(np.random.RandomState(3), 2, H, W))
    for _ in range(steps):
        step(state, batch)
    return state, step, batch, mcfg, tcfg


def test_checkpoint_round_trip_and_same_next_step(scratch):
    """Parameters, batch statistics, optimizer moments, step and the dropout
    generator come back: the restored state takes the live state's next step
    (dropout on)."""
    state, step, batch, mcfg, tcfg = _trained_state(2)
    ckpt = str(scratch / "ckpt")
    TCkpt.save_state(ckpt, state)
    fresh = create_train_state(mcfg, dataclasses.replace(tcfg, seed=99), device="cpu")
    assert TCkpt.restore_state(ckpt, fresh) is fresh
    assert fresh.step == state.step == 2
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, fresh.model.state_dict()[k]), k
    live = list(state.optimizer.state.values())
    back = list(fresh.optimizer.state.values())
    assert len(live) == len(back) > 0
    for a, b in zip(live, back):
        assert torch.equal(a["exp_avg"], b["exp_avg"])
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"]) and a["step"] == b["step"]
    _, want = step(state, batch)
    _, got = step(fresh, batch)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-6), k


def test_checkpoint_same_step_overwrites_and_keeps_newest_five(tmp_path):
    d = str(tmp_path / "ckpt")
    TCkpt.save_params(d, {"w": np.array([1.0, 2.0], np.float32)}, step=100)
    TCkpt.save_params(d, {"w": np.array([9.0, 9.0], np.float32)}, step=100)
    np.testing.assert_array_equal(TCkpt.restore_params(d)["w"], [9.0, 9.0])
    for s in range(101, 108):
        TCkpt.save_params(d, {"nested": {"w": torch.full((2,), float(s))}}, step=s)
    assert sorted(os.listdir(d), key=int) == ["103", "104", "105", "106", "107"]
    np.testing.assert_array_equal(TCkpt.restore_params(d)["nested"]["w"], [107.0, 107.0])
    # the reference keeps the same semantics
    jd = str(tmp_path / "jax_ckpt")
    JCkpt.save_params(jd, {"w": jnp.asarray([1.0, 2.0])}, step=100)
    JCkpt.save_params(jd, {"w": jnp.asarray([9.0, 9.0])}, step=100)
    np.testing.assert_array_equal(np.asarray(JCkpt.restore_params(jd)["w"]), [9.0, 9.0])


def test_restore_skips_a_step_whose_save_did_not_finish(scratch):
    state, *_ = _trained_state(1)
    d = str(scratch / "ckpt")
    TCkpt.save_state(d, state)                      # step 1, finished
    os.makedirs(os.path.join(d, "400"))             # a bare step directory
    os.makedirs(os.path.join(d, "500"))             # data written, never marked complete
    torch.save({"step": 500}, os.path.join(d, "500", "state.pt"))
    os.makedirs(os.path.join(d, "300.tmp"))
    fresh, *_ = _trained_state(0)
    assert TCkpt.restore_state(d, fresh).step == 1
    TCkpt.save_params(d, {"w": np.zeros(2, np.float32)}, step=2)
    assert set(TCkpt.restore_params(d)) == {"w"}


def test_restore_from_an_empty_directory(tmp_path):
    fresh, *_ = _trained_state(0)
    assert TCkpt.restore_state(str(tmp_path / "nothing_here"), fresh) is None
    os.makedirs(tmp_path / "empty")
    assert TCkpt.restore_state(str(tmp_path / "empty"), fresh) is None
    with pytest.raises(FileNotFoundError):
        TCkpt.restore_params(str(tmp_path / "nothing_here"))
    with pytest.raises(FileNotFoundError):  # the reference raises the same
        JCkpt.restore_params(str(tmp_path / "nothing_here_either"))


# --- back to the reference ----------------------------------------------------

def test_trained_port_model_loads_in_the_jax_package(scratch, reference):
    """state_dict_to_jax + save_quantized_params: the archive has the
    reference's tree (keys and shapes), both packages read the same values
    from it, and both predictors give the same output from it (tolerances of
    tests/test_torch_predictor.py)."""
    state = _port_state(reference["init"])
    step = make_train_step(MaskRefinerConfig(**CFG))
    for _ in range(2):
        step(state, _torch_batch(reference["batch"]))
    with torch.no_grad():  # decisive heads, so that there are instances to compare
        state.model.ins_embed_head.foreground_predictor.bias += 4.0
        k = state.model.ins_embed_head.center_predictor.weight
        k.copy_(torch.randn(k.shape, generator=torch.Generator().manual_seed(5)) * 0.5)
    tree = state_dict_to_jax(state.model)
    init = reference["init"]
    flat = dict(JCkpt._flatten_dict(tree))
    want = dict(JCkpt._flatten_dict({"params": init["params"],
                                     "batch_stats": init["batch_stats"]}))
    assert flat.keys() == want.keys()
    assert all(flat[k].shape == want[k].shape for k in want)
    back = state_dict_from_jax(tree)
    assert all(torch.equal(v, back[k]) for k, v in state.model.state_dict().items())

    path = str(scratch / "trained_int8.npz")
    TCkpt.save_quantized_params(path, tree)
    ours, ref = TCkpt.load_quantized_params(path), JCkpt.load_quantized_params(path)
    for (ka, a), (kb, b) in zip(JCkpt._flatten_dict(ours), JCkpt._flatten_dict(ref)):
        assert ka == kb
        np.testing.assert_array_equal(a, b)
    ref_path = str(scratch / "ref_int8.npz")
    JCkpt.save_quantized_params(ref_path, tree)
    with np.load(path) as a, np.load(ref_path) as b:
        assert a.files == b.files and all(np.array_equal(a[k], b[k]) for k in a.files)

    cfg = dict(height=64, width=96, resnet_depth=14, min_instance_area=64, stuff_area=256)
    jp = JPredictor(JConfig(**cfg), ref)
    tp = TPredictor(MaskRefinerConfig(**cfg), ours, device="cpu")
    rgb, depth, masks = blob_scene(np.random.RandomState(11), 64, 96, 4)
    want = {k: np.asarray(v) for k, v in jp.predict_raw(rgb, depth, list(masks)).items()}
    got = {k: v.numpy() for k, v in tp.predict_raw(rgb, depth, list(masks)).items()}
    for k in ("sem_seg", "center", "offset", "eee_mask", "eee_boundary"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-3, err_msg=k)
    assert int(got["num_instances"]) == int(want["num_instances"]) > 0
    assert (got["panoptic_seg"] == want["panoptic_seg"]).mean() >= 0.999
    np.testing.assert_allclose(got["instance_scores"], want["instance_scores"],
                               rtol=1e-3, atol=1e-6)


# --- the CLI -------------------------------------------------------------------

def _tiny_config(tmp_path):
    path = tmp_path / "tiny.yaml"
    path.write_text("model:\n  height: 32\n  width: 32\n  resnet_depth: 14\n"
                    "train:\n  batch_size: 2\n  warmup_iters: 2\n  base_lr: 0.0005\n")
    return str(path)


@pytest.mark.parametrize("route", [["--device-targets"], []])
def test_train_net_torch_cli_trains_and_resumes(scratch, capsys, route):
    import train_net_torch

    out = str(scratch / "out")
    common = ["--config-file", _tiny_config(scratch), "--synthetic", "--synthetic-size", "4",
              "--target-slots", "8", "--device", "cpu", "--log-period", "1",
              "--output-dir", out, *route]
    train_net_torch.main(common + ["--max-iter", "3"])
    first = capsys.readouterr().out
    assert "iter 3/3" in first and "checkpoint saved at 3" in first and "resumed" not in first
    assert os.path.exists(os.path.join(out, "ckpt", "3", "COMPLETE"))
    train_net_torch.main(common + ["--max-iter", "5", "--resume"])
    second = capsys.readouterr().out
    assert "resumed at step 3" in second
    assert "iter 3/5" not in second and "iter 4/5" in second and "iter 5/5" in second
    assert os.path.exists(os.path.join(out, "ckpt", "5", "COMPLETE"))
    losses = [float(line.split("total_loss=")[1].split()[0])
              for line in (first + second).splitlines() if "total_loss=" in line]
    assert len(losses) == 5 and all(np.isfinite(losses))


def test_train_net_torch_routes_see_the_same_losses(scratch, capsys):
    """The device pool, the host iterator of packed samples and the host
    iterator of finished targets feed the same scenes in the same order."""
    import train_net_torch

    logs = []
    for i, route in enumerate((["--device-targets"], ["--device-targets",
                                                      "--no-data-device-cache"], [])):
        train_net_torch.main(["--config-file", _tiny_config(scratch), "--synthetic",
                              "--synthetic-size", "4", "--target-slots", "8", "--device", "cpu",
                              "--log-period", "1", "--max-iter", "2", "--height", "32",
                              "--output-dir", str(scratch / f"out{i}"), *route])
        logs.append([line.split(" (")[0] for line in capsys.readouterr().out.splitlines()
                     if line.startswith("iter ")])
    assert len(logs[0]) == 2 and logs[0] == logs[1] == logs[2]


_MULTIHOST_YAML = ("model:\n  height: 32\n  width: 32\n  resnet_depth: 14\n  aspp_dropout: 0.0\n"
                   "train:\n  batch_size: 2\n  warmup_iters: 2\n  base_lr: 0.0005\n")


def _multihost_run(tmp_path):
    """--multihost on two gloo ranks (torchrun, on the CPU): each rank trains
    on its own stream, seeded seed + rank, in local batches of batch_size
    2. Its losses (metrics.jsonl, unrounded) against one process taking the
    global batch of 4 from the two streams: rtol 1e-4 at step 1, 1e-3 at
    step 2 (Adam's first update is lr * sign(g): where g is ~0 the two
    computations may move a weight by 2 lr apart)."""
    import json
    import subprocess
    import sys

    from quber_tpu_torch.config import load_any_config
    from quber_tpu_torch.data.pipeline import make_dataloader
    from quber_tpu_torch.data.synthetic import synthetic_records
    from train_net_torch import SyntheticMapper

    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(_MULTIHOST_YAML)
    out = tmp_path / "out"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         os.path.join(repo, "train_net_torch.py"), "--multihost", "--synthetic",
         "--synthetic-size", "6", "--target-slots", "8", "--device", "cpu", "--log-period", "1",
         "--max-iter", "2", "--config-file", str(cfg), "--output-dir", str(out)],
        cwd=repo, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "world_size=2" in res.stdout and "iter 2/2" in res.stdout
    assert "local_batch=2" in res.stdout  # batch_size a rank
    got = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]

    model_cfg, train_cfg = load_any_config(str(cfg))
    # 6 scenes: seeds 7 and 8 shuffle 4 records into the same order
    records = synthetic_records(6, 32, 32, depth_range=train_cfg.depth_range)
    streams = [make_dataloader(records, SyntheticMapper(train_cfg, model_cfg, 8),
                               train_cfg.batch_size, seed=train_cfg.seed + r) for r in range(2)]
    state = create_train_state(model_cfg, train_cfg, device="cpu")
    step = make_train_step(model_cfg)
    assert [g["iter"] for g in got] == [1, 2]
    for i, rtol in enumerate((1e-4, 1e-3)):
        parts = [next(s) for s in streams]
        batch = {k: torch.from_numpy(np.concatenate([p[k] for p in parts])) for k in parts[0]}
        _, metrics = step(state, batch)
        for k, v in metrics.items():
            assert got[i][k] == pytest.approx(float(v), rel=rtol), (i, k)


@pytest.mark.parametrize("flags,item", [
    pytest.param(["--dataset", "uoais_sim_train_panoptic"], "item 11b", id="flags0-item 11b"),
    pytest.param(["--workers", "2"], "item 11b", id="flags1-item 11b"),
    pytest.param(["--space", "2"], "item 12b", id="flags2-item 12"),
    pytest.param(["--multihost"], "item 12", id="flags3-item 12"),
    pytest.param(["--multihost", "--space", "2"], "item 12b", id="flags4-item 12"),
    pytest.param([], "item 11b", id="flags5-item 11b"),  # without --synthetic: nothing to train on
])
def test_train_net_torch_cli_names_what_waits(flags, item, tmp_path):
    """What the CLI's flags wait for in ROADMAP.md, or, where the item is
    done, what they now do: 11b reads the registered dataset, 12 trains
    data-parallel (--multihost: a two-rank run against one process), and
    --space still waits for 12b."""
    import train_net_torch

    if item == "item 11b":
        # done: these flags (and training without --synthetic) now read the
        # registered dataset under --data-root, here a directory without one
        with pytest.raises(FileNotFoundError, match="UOAIS-Sim"):
            train_net_torch.main(flags + ["--data-root", str(tmp_path), "--device", "cpu"])
        return
    if item == "item 12":
        try:
            _multihost_run(tmp_path)
        finally:  # the ranks' checkpoints take ~0.5 GB
            shutil.rmtree(tmp_path, ignore_errors=True)
        return
    argv = flags + ["--synthetic"]
    with pytest.raises(SystemExit) as exc:
        train_net_torch.main(argv + ["--device", "cpu"])
    assert "ROADMAP.md" in str(exc.value) and item in str(exc.value)

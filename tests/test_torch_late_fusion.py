"""The explicit-error-estimation study in the port
(quber_tpu_torch/models/late_fusion.py, quber_tpu_torch/train/eee_train.py)
against the JAX package's at a small size: batch 2 of 32x48 frames, the
five modalities, four levels, GroupNorm, float32.

The forward from the port's seeded init carried across with
state_dict_to_jax: both heads within 1e-5 of the reference. The losses
(focal, dice, dice-CE) on the same logits and one-hot targets rtol 1e-6.
One train_eee step (dice-CE, AdamW) from the port's seeded init carried to
the reference against the reference's step (make_eee_train_step): the metrics rtol 1e-5, the gradients the
step left within 1e-4 of the norm of jax.grad's per tensor, and the updated
weights within 1e-6 of the reference's wherever the gradient is above a
thousandth of the largest (Adam's first step moves a weight by about lr
whatever its gradient, so a gradient at float noise takes any sign).
create_eee_state's optimizer (Adam, or AdamW for a weight decay) equals
optax's adam / adamw within 1e-6 over three steps of fixed gradients.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from quber_tpu.models import late_fusion as JL
from quber_tpu.train import eee_train as JE
from quber_tpu_torch.models import late_fusion as TL
from quber_tpu_torch.models.from_jax import state_dict_from_jax, state_dict_to_jax
from quber_tpu_torch.train import eee_train as TE

B, H, W = 2, 32, 48
LR = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(seed=0):
    """NHWC numpy inputs and one-hot error-map targets."""
    rng = np.random.RandomState(seed)
    batch = {name: rng.randn(B, H, W, c).astype(np.float32) for name, c in TL.MODALITIES}
    for head in ("mask_target", "boundary_target"):
        batch[head] = np.eye(3, dtype=np.float32)[rng.randint(0, 3, (B, H, W))]
    return batch


def _nchw(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(np.moveaxis(v, -1, 1)))
            for k, v in batch.items()}


def test_forward():
    model = TL.LateFusionEncoderDecoder().eval()
    model.reset_parameters(torch.Generator().manual_seed(3))
    batch = _batch()
    inputs = {k: batch[k] for k, _ in TL.MODALITIES}
    want = jax.jit(JL.LateFusionEncoderDecoder().apply)(state_dict_to_jax(model), inputs)
    with torch.no_grad():
        got = model(_nchw(inputs))
    assert set(got) == {"mask", "boundary"}
    for k in got:
        np.testing.assert_allclose(got[k].permute(0, 2, 3, 1).numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", ["focal", "dice", "dicece"])
def test_losses(name):
    rng = np.random.RandomState(1)
    logits = (rng.randn(B, H, W, 3) * 3).astype(np.float32)
    targets = np.eye(3, dtype=np.float32)[rng.randint(0, 3, (B, H, W))]
    want = float(JE.make_loss(name)(jnp.asarray(logits), jnp.asarray(targets)))
    got = float(TE.make_loss(name)(
        *(torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1))) for a in (logits, targets))))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("loss_name,weight_decay", [("dicece", 1e-2)])
def test_one_train_eee_step(loss_name, weight_decay):
    """train_eee's step: the reference's (make_eee_train_step with
    create_eee_state's optimizer, as its train_eee runs it) against the
    port's train_eee from the same weights. The reference's gradients are
    read off Adam's first moment (mu = (1 - 0.9) g after one step)."""
    model = TL.LateFusionEncoderDecoder()
    model.reset_parameters(torch.Generator().manual_seed(2))
    jm, params0 = JL.LateFusionEncoderDecoder(), state_dict_to_jax(model)
    batch = _batch(2)
    tx = optax.adamw(LR, weight_decay=weight_decay) if weight_decay else optax.adam(LR)
    params1, opt_state, want = JE.make_eee_train_step(jm, tx, loss_name)(
        params0, tx.init(params0), batch)
    grads = state_dict_from_jax(jax.tree.map(lambda m: np.asarray(m) / np.float32(0.1),
                                             opt_state[0].mu))

    _, got = TE.train_eee(model, itertools.repeat(_nchw(batch)), 1, LR, weight_decay, loss_name,
                          log_every=0, seed=None, device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5), k
    after = state_dict_from_jax(jax.tree.map(np.asarray, params1))
    noise = 1e-3 * max(float(g.norm()) for g in grads.values())
    compared = 0
    for name, p in model.named_parameters():
        g = grads[name]
        if float(g.norm()) <= noise:
            continue
        assert float((p.grad - g).norm()) <= 1e-4 * float(g.norm()), name
        big = g.abs() > noise
        np.testing.assert_allclose(p.detach()[big].numpy(), after[name][big].numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)
        compared += 1
    assert compared > 50


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_optimizer_is_optax_adam_or_adamw(weight_decay):
    """create_eee_state's optimizer against the reference's (optax.adam, or
    optax.adamw's decoupled decay) over three steps of fixed gradients, at
    a learning rate and decay whose decay term (~1e-4 a weight) dwarfs the
    float rounding the tolerance allows."""
    rng = np.random.RandomState(5)
    lr = 1e-3
    model = TL.LateFusionEncoderDecoder(modalities=(("rgb", 3),), levels=1)
    optimizer = TE.create_eee_state(model, lr, weight_decay, seed=1, device="cpu")
    params = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    tx = optax.adamw(lr, weight_decay=weight_decay) if weight_decay else optax.adam(lr)
    state = tx.init(params)
    for _ in range(3):
        grads = {n: rng.randn(*v.shape).astype(np.float32) for n, v in params.items()}
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n])
        optimizer.step()
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[n]), rtol=0, atol=1e-6,
                                   err_msg=n)


def test_mesh_is_not_ported():
    """train_eee takes a mesh: under a one-process mesh (world size 1) its
    step is mesh=None's, bit for bit; the data-parallel step over two ranks
    is held against the reference's in tests/test_torch_parallel_train.py."""
    from quber_tpu_torch.parallel.mesh import make_mesh

    batch = _nchw(_batch(3))
    runs = []
    for mesh in (None, make_mesh(["cpu"])):
        model = TL.LateFusionEncoderDecoder()
        model.reset_parameters(torch.Generator().manual_seed(4))
        _, metrics = TE.train_eee(model, itertools.repeat(batch), 2, LR, 0.0, "focal",
                                  mesh=mesh, log_every=0, seed=None, device="cpu")
        runs.append((metrics, model.state_dict()))
    (m0, sd0), (m1, sd1) = runs
    assert {k: float(v) for k, v in m0.items()} == {k: float(v) for k, v in m1.items()}
    assert all(torch.equal(v, sd1[k]) for k, v in sd0.items())

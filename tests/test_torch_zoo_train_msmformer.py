"""train_zoo_torch.py --model msmformer against tools/train_zoo.py's recipe
(train_msmformer) at a small size: the recipe's bfloat16 MSMFormer at its
widths on 64x64 scenes.

Two steps in float32 from the JAX package's init carried across with
from_jax, the second from the reference's own state after the first (its
weights and Adam moments), so that each step is compared from the same
point: the losses rtol 1e-3 where the matching is not a tie (the first
test's docstring says which). The recipe's own bfloat16 step: its first
loss rtol 2e-3 (measured 1.25e-3: the two frameworks round bfloat16 in
other places, and the float32 losses of this init already differ by 4e-4).
Then the CLI: two CPU steps write a checkpoint directory,
which build_base_model reads through $QUBER_MSMFORMER_NATIVE_CKPT, and an
int8 archive, which the JAX package's MSMFormer applies.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from quber_tpu.models import msmformer as JM
from quber_tpu.train.checkpoint import load_quantized_params as jax_load_quantized
from quber_tpu_torch.evaluation import base_models as tbase
from quber_tpu_torch.models import msmformer as TM
from quber_tpu_torch.models.from_jax import load_optax_adam_state, state_dict_from_jax
from quber_tpu_torch.train.checkpoint import load_eval_params

_TOOL = os.path.join(os.path.dirname(__file__), "..", "tools", "train_zoo.py")
_spec = importlib.util.spec_from_file_location("jax_train_zoo", _TOOL)
jzoo = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jzoo)

H = W = 64
LR = 1e-4
SEED = 7
LOSS_RTOL = 1e-3
GRAD_SHARE = 0.15
BF16_LOSS_RTOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_recipe(dtype):
    """The JAX recipe's model, init and jitted step (tools/train_zoo.py
    train_msmformer) in `dtype`."""
    model = JM.MSMFormer(dtype=dtype)
    variables = jax.jit(model.init)(jax.random.PRNGKey(SEED), jnp.zeros((1, H, W, 3)),
                                    jnp.zeros((1, H, W, 3)))
    tx = optax.adam(LR)

    @jax.jit
    def jstep(v, opt_state, rgb, xyz, labels, valid):
        gt = labels[::4, ::4][None] == 1 + jnp.arange(jzoo.SLOTS)[:, None, None]

        def loss_fn(v):
            out = model.apply(v, rgb[None], xyz[None])
            parts = JM.msmformer_set_loss(out, gt.astype(jnp.float32)[None], valid[None])
            return sum(parts.values()), parts

        (loss, parts), grads = jax.value_and_grad(loss_fn, has_aux=True)(v)
        updates, opt_state = tx.update(grads, opt_state, v)
        return optax.apply_updates(v, updates), opt_state, loss, parts, grads

    return variables, tx.init(variables), jstep, model


@pytest.fixture(scope="module")
def pool():
    return jzoo.make_labeled_scenes(2, H, W, SEED, (250, 1500))


def _port_recipe(dtype):
    import train_zoo_torch

    model, optimizer = train_zoo_torch.make_msmformer(SEED, LR, "cpu", dtype=dtype)
    return model, optimizer, train_zoo_torch.make_msmformer_step(model, optimizer)


def _stage(pool):
    import train_zoo_torch

    return train_zoo_torch.stage(pool, "cpu")


def _load(model, optimizer, v, opt_state=None):
    """The reference's weights (and Adam moments) into the port's recipe."""
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, dict(v))))
    if opt_state is not None:
        adam = opt_state[0]
        load_optax_adam_state(optimizer, model, jax.tree.map(np.asarray, adam.mu["params"]),
                              jax.tree.map(np.asarray, adam.nu["params"]), int(adam.count))


def _jax_steps(pool, dtype, n):
    """n steps of the JAX recipe on scenes 1, 0: ([(weights, Adam state)
    before each step and after the last], [(loss, parts, gradients) of
    each], the forward applied by itself)."""
    variables, opt_state, jstep, model = _jax_recipe(dtype)
    states, out = [(variables, opt_state)], []
    for scene in (1, 0)[:n]:
        v, o, loss, parts, grads = jstep(*states[-1], *(pool[k][scene] for k in
                                                 ("rgb", "xyz", "labels", "valid")))
        states.append((v, o))
        out.append((float(loss), {k: float(x) for k, x in parts.items()},
                    jax.tree.map(np.asarray, dict(grads))))
    return states, out, model


@pytest.fixture(scope="module")
def jax_float32(pool):
    return _jax_steps(pool, jnp.float32, 2)


def test_two_steps_match_the_jax_recipe_in_float32(pool, jax_float32):
    """The recipe's logic (the ground truth at stride 4, the set loss with
    its matching, Adam over every parameter) in float32.

    Step 1 from the reference's init: the loss rtol 1e-3, and every
    parameter's gradient within 15% of the norm of jax.value_and_grad's
    (tests/test_torch_train.py's rule). Step 2 from the reference's own state (its weights and
    Adam moments): the dice and objectness losses rtol 1e-3, and the mask
    loss of the port's criterion on the reference's own forward equal to the
    reference's. The port's mask loss on its own forward is not compared: at
    this init the masks saturate (sigmoid exactly 1.0 in float32), several
    queries tie on the matching cost, and the last bits of a forward decide
    which of them takes a target; on the 16 pairs of 4 scenes the mask loss
    moved by 1e-4 to 1.7%, and the JAX package's own jitted and op-by-op
    forwards disagree the same way."""
    states, want, jmodel = jax_float32
    model, optimizer, step = _port_recipe(torch.float32)
    tpool = _stage(pool)
    _load(model, optimizer, states[0][0])
    loss1, _ = step(tpool, 1)
    assert float(loss1) == pytest.approx(want[0][0], rel=LOSS_RTOL)
    # each gradient (left by the step) within GRAD_SHARE of the norm of the
    # reference's; one below a thousandth of the largest (a conv bias ahead
    # of a GroupNorm: zero, as float noise) only held below that
    grads = state_dict_from_jax(want[0][2])
    noise = 1e-3 * max(float(g.norm()) for g in grads.values())
    compared = 0
    for name, p in model.named_parameters():
        g = grads[name].double()
        if float(g.norm()) <= noise:
            assert float(p.grad.norm()) <= noise, name
            continue
        assert float((p.grad.double() - g).norm()) <= GRAD_SHARE * float(g.norm()), name
        compared += 1
    assert compared > 200, compared

    _load(model, optimizer, *states[1])
    _, parts2 = step(tpool, 0)
    for k in ("loss_dice", "loss_objectness"):
        assert float(parts2[k]) == pytest.approx(want[1][1][k], rel=LOSS_RTOL), k
    scene = 0
    out = jax.tree.map(np.asarray, jmodel.apply(states[1][0], pool["rgb"][scene][None],
                                                pool["xyz"][scene][None]))
    gt = (pool["labels"][scene][::4, ::4][None] == 1 + np.arange(jzoo.SLOTS)[:, None, None])
    valid = pool["valid"][scene][None]
    ref = JM.msmformer_set_loss(out, jnp.asarray(gt, jnp.float32)[None], jnp.asarray(valid))
    got = TM.msmformer_set_loss({k: torch.from_numpy(v.copy()) for k, v in out.items()},
                                torch.from_numpy(gt.astype(np.float32))[None],
                                torch.from_numpy(valid))
    for k in ref:
        assert float(got[k]) == pytest.approx(float(ref[k]), rel=1e-6), k


def test_first_bfloat16_step_matches_the_jax_recipe(pool, jax_float32):
    """The recipe itself (bfloat16): its first loss from the reference's
    init within BF16_LOSS_RTOL of the reference's bfloat16 loss. At this
    init the mask logits reach ~58 and the loss sums their BCE: the float32
    losses already differ by 4e-4 between the frameworks, and bfloat16,
    which the two round in other places, reads 1.25e-3."""
    states, want16, _ = _jax_steps(pool, jnp.bfloat16, 1)
    model, optimizer, step = _port_recipe(torch.bfloat16)
    _load(model, optimizer, states[0][0])
    got = float(step(_stage(pool), 1)[0])
    assert got == pytest.approx(want16[0][0], rel=BF16_LOSS_RTOL)
    assert got != pytest.approx(jax_float32[1][0][0], rel=1e-4)  # it ran in bfloat16


def test_train_zoo_torch_cli(tmp_path, capsys, monkeypatch):
    import train_zoo_torch

    out = tmp_path / "msm"
    argv = ["--model", "msmformer", "--size", "2", "--height", str(H), "--width", str(W),
            "--max-iter", "2", "--log-period", "1", "--checkpoint-period", "1",
            "--output-dir", str(out)]
    if not torch.cuda.is_available():
        assert train_zoo_torch.main(argv) == 2
    assert train_zoo_torch.main(argv + ["--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "iter 2/2 total=" in text and "loss_objectness=" in text
    assert sorted(os.listdir(out / "ckpt")) == ["1", "2"]
    monkeypatch.setenv("QUBER_MSMFORMER_NATIVE_CKPT", str(out / "ckpt"))
    base = tbase.build_base_model("msmformer", "OSD", device="cpu")
    want = state_dict_from_jax(load_eval_params(str(out / "ckpt")))
    assert all(torch.equal(v, want[k]) for k, v in base.model.state_dict().items())
    tree = jax_load_quantized(str(out / "msmformer_int8.npz"))
    x = jnp.zeros((1, H, W, 3))
    got = JM.MSMFormer(dtype=jnp.bfloat16).apply(tree, x, x)
    assert got["mask_logits"].shape == (1, 50, H // 4, W // 4)
    assert bool(jnp.isfinite(got["mask_logits"]).all())

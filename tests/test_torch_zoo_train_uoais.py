"""train_zoo_torch.py --model uoaisnet against tools/train_zoo.py's UOAIS-Net
recipe at a small size: the recipe's float32 UOAIS-Net (FrozenBN, its
widths) on 64x64 scenes of make_scenes.

Two steps from the JAX package's init carried across with from_jax, the
second from the reference's own state after the first (its parameters, the
FrozenBN tensors among them, and its Adam moments). Tolerances: the total
loss and each part rtol 1e-3 (abs 1e-6 for a part that is zero); the first
step's gradient of every parameter, the FrozenBN tensors included, within
15% of the norm of jax.value_and_grad's (tests/test_torch_train.py's rule),
a gradient below a thousandth of the largest held to that bound alone.
Then the CLI: two CPU steps write a
checkpoint directory, which build_base_model reads through
$QUBER_UOAISNET_CKPT, and an int8 archive, which the JAX package's
UOAIS-Net applies.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from quber_tpu.models import uoais_net as JU
from quber_tpu.train.checkpoint import load_quantized_params as jax_load_quantized
from quber_tpu_torch.evaluation import base_models as tbase
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


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _stack(scenes):
    return {k: np.stack([s[k] for s in scenes]) for k in scenes[0]}


def test_two_steps_match_the_jax_recipe():
    import train_zoo_torch

    scenes = jzoo.make_scenes(2, H, W, SEED, (250, 1500))
    got_pool = train_zoo_torch.make_scenes(2, H, W, SEED, (250, 1500))
    want_pool = _stack(scenes)
    for k, v in want_pool.items():  # the port renders the same scenes
        np.testing.assert_array_equal(got_pool[k], v, err_msg=k)

    model = JU.UOAISNet()  # the recipe's: float32, FrozenBN
    variables = jax.jit(model.init)(jax.random.PRNGKey(SEED), jnp.zeros((1, H, W, 3)),
                                    jnp.zeros((1, H, W, 3)))
    tx = optax.adam(LR)

    @jax.jit
    def jstep(params, opt_state, rgb, depth, boxes, vis, amo, valid):
        def loss_fn(p):
            out = model.apply({"params": p}, rgb[None], depth[None],
                              gt_proposals=jnp.where(valid[:, None], boxes, 0.0))
            losses = JU.uoais_losses(out, boxes, vis, amo, valid)
            return sum(losses.values()), losses

        (loss, parts), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, parts, grads

    tmodel, optimizer = train_zoo_torch.make_uoaisnet(SEED, LR, "cpu")
    frozen = [n for n, _ in tmodel.named_parameters() if ".norm." in n]
    assert len(frozen) == 4 * 2 * 53  # the FrozenBN tensors are trained, as the reference's
    step = train_zoo_torch.make_uoaisnet_step(tmodel, optimizer)
    tpool = train_zoo_torch.stage(got_pool, "cpu")
    params, opt_state = variables["params"], tx.init(variables["params"])
    for i, scene in enumerate((1, 0)):
        tmodel.load_state_dict(state_dict_from_jax({"params": jax.tree.map(np.asarray, params)}))
        if i:
            adam = opt_state[0]
            load_optax_adam_state(optimizer, tmodel, jax.tree.map(np.asarray, adam.mu),
                                  jax.tree.map(np.asarray, adam.nu), int(adam.count))
        s = scenes[scene]
        new_params, opt_state, loss, parts, grads = jstep(
            params, opt_state, *(s[k] for k in ("rgb", "depth", "boxes", "vis", "amo", "valid")))
        got_loss, got_parts = step(tpool, scene)
        assert float(got_loss) == pytest.approx(float(loss), rel=LOSS_RTOL), i
        for k in parts:
            assert float(got_parts[k]) == pytest.approx(float(parts[k]), rel=LOSS_RTOL,
                                                        abs=1e-6), (i, k)
        if i == 0:
            _check_gradients(tmodel, state_dict_from_jax(
                {"params": jax.tree.map(np.asarray, grads)}), frozen)
        params = new_params


def _check_gradients(model, want, frozen):
    """Each parameter's gradient (left by the step) within GRAD_SHARE of the
    norm of the reference's; one below a thousandth of the largest only
    held below that."""
    noise = 1e-3 * max(float(g.norm()) for g in want.values())
    compared = []
    for name, p in model.named_parameters():
        g = want[name].double()
        if float(g.norm()) <= noise:
            assert float(p.grad.norm()) <= noise, name
            continue
        assert float((p.grad.double() - g).norm()) <= GRAD_SHARE * float(g.norm()), name
        compared.append(name)
    assert len(compared) > 300 and len(set(compared) & set(frozen)) > 100, len(compared)


def test_train_zoo_torch_cli(tmp_path, capsys, monkeypatch):
    import train_zoo_torch

    out = tmp_path / "uoais"
    argv = ["--model", "uoaisnet", "--size", "2", "--height", str(H), "--width", str(W),
            "--max-iter", "2", "--log-period", "1", "--checkpoint-period", "1",
            "--output-dir", str(out)]
    if not torch.cuda.is_available():
        assert train_zoo_torch.main(argv) == 2
    assert train_zoo_torch.main(argv + ["--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "iter 2/2 total=" in text and "loss_occlusion=" in text
    assert sorted(os.listdir(out / "ckpt")) == ["1", "2"]
    monkeypatch.setenv("QUBER_UOAISNET_CKPT", str(out / "ckpt"))
    base = tbase.build_base_model("uoaisnet", "OSD", device="cpu")
    want = state_dict_from_jax(load_eval_params(str(out / "ckpt")))
    assert all(torch.equal(v, want[k]) for k, v in base.model.state_dict().items())
    tree = jax_load_quantized(str(out / "uoaisnet_int8.npz"))
    assert set(tree) == {"params"}
    x = jnp.zeros((1, H, W, 3))
    got = JU.UOAISNet().apply(tree, x, x)
    assert got["visible_masks"].shape == (32, 28, 28)

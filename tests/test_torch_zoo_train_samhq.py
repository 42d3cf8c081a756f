"""train_zoo_torch.py --model samhq against tools/train_zoo.py's recipe on
the CPU.

The pool at 64x96 scenes and a 64x64 input against make_samhq_scenes'
(equal: the port's float32 bilinear is OpenCV's arithmetic); the recipe's
architecture equal to SAMHQ_SYNTH_ARCH; the first step of a small SAMHQ
(img 64, width 32, 3 blocks) from the port's seeded init, carried to the
JAX layout, against jax.value_and_grad of the recipe's loss on the same
scene: the loss rtol 1e-4, each parameter's gradient within 15% of the
norm of JAX's (the port's rule since its first trainer; a gradient below a
thousandth of the largest held to that bound alone). Then the CLI: two CPU
steps at the recipe's own size write arch.json, the checkpoint that
`hq-sam` reads through $QUBER_SAMHQ_CKPT, and an int8 archive holding the
JAX package's variable tree (init_sam_variables' structure and shapes).
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quber_tpu.models import sam_hq as J
from quber_tpu.train.checkpoint import load_quantized_params as jax_load_quantized
from quber_tpu_torch.models.from_jax import state_dict_from_jax, state_dict_to_jax

_TOOL = os.path.join(os.path.dirname(__file__), "..", "tools", "train_zoo.py")
_spec = importlib.util.spec_from_file_location("jax_train_zoo", _TOOL)
jzoo = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jzoo)

H, W, S = 64, 96, 64
SEED, LR = 7, 1e-4
LOSS_RTOL = 1e-4
GRAD_SHARE = 0.15
SMALL = dict(img_size=S, embed_dim=32, depth=3, num_heads=2, global_blocks=(1,), window_size=3)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pools():
    import train_zoo_torch as zoo

    return (jzoo.make_samhq_scenes(3, H, W, SEED, (250, 1500), S),
            zoo.make_samhq_scenes(3, H, W, SEED, (250, 1500), S))


def test_pool_matches_jax(pools):
    want, got = pools
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert want["valid"].sum() >= 3 and (want["prompt"][want["valid"]] > 0).any()


def test_architecture_is_the_recipes():
    import train_zoo_torch as zoo

    assert zoo.SAMHQ_SYNTH_ARCH == jzoo.SAMHQ_SYNTH_ARCH
    model, optimizer = zoo.make_samhq(SEED, LR, "cpu")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert model.image_encoder.global_blocks == (2, 5) and model.img_size == 256
    assert len(optimizer.param_groups[0]["params"]) == len(list(model.parameters()))


def test_first_step_matches_jax(pools):
    import train_zoo_torch as zoo
    from quber_tpu_torch.models.sam_hq import SAMHQ

    want_pool, _ = pools
    model = SAMHQ(**SMALL)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    model.eval()
    optimizer = torch.optim.Adam(model.parameters(), lr=LR)
    variables = state_dict_to_jax(model)
    jm, scene = J.SAMHQ(**SMALL), 1
    p = {k: jnp.asarray(v[scene]) for k, v in want_pool.items()}

    def loss_fn(v):  # tools/train_zoo.train_samhq's
        embed, interm = jm.apply(v, p["img"][None], method=J.SAMHQ.encode)

        def one(prompt, tgt, ok):
            masks, _, _ = jm.apply(v, embed, interm, prompt[None, ..., None], False, True,
                                   method=J.SAMHQ.decode)
            return J.sam_hq_mask_loss(masks[:, 0], tgt[None]) * ok

        per = jax.vmap(one)(p["prompt"], p["tgt"], p["valid"].astype(jnp.float32))
        return per.sum() / jnp.maximum(p["valid"].sum(), 1)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables)
    step = zoo.make_samhq_step(model, optimizer)
    got_loss, parts = step(zoo.stage(want_pool, "cpu"), scene)
    assert float(got_loss) == pytest.approx(float(loss), rel=LOSS_RTOL)
    assert set(parts) == {"focal_dice"}
    want = state_dict_from_jax(jax.tree.map(np.asarray, grads))
    noise = 1e-3 * max(float(g.norm()) for g in want.values())
    compared = 0
    for name, param in model.named_parameters():
        g = want[name].double()
        # no gradient where the mask loss does not reach (JAX's zeros): the
        # point and box embeddings, the IoU head, SAM's own mask tokens
        grad = torch.zeros_like(g) if param.grad is None else param.grad.double()
        if float(g.norm()) <= noise:
            assert float(grad.norm()) <= noise, name
            continue
        assert float((grad - g).norm()) <= GRAD_SHARE * float(g.norm()), name
        compared += 1
    assert compared >= 100, compared


def test_cli_writes_what_hq_sam_and_the_jax_package_read(tmp_path, monkeypatch):
    import train_zoo_torch as zoo
    from quber_tpu_torch.evaluation.refiner_models import build_refiner_model
    from quber_tpu_torch.train.checkpoint import load_eval_params

    out = tmp_path / "samhq"
    assert zoo.main(["--model", "samhq", "--device", "cpu", "--size", "2", "--max-iter", "2",
                     "--log-period", "1", "--output-dir", str(out)]) == 0
    arch = json.loads((out / "arch.json").read_text())
    assert arch == dict(zoo.SAMHQ_SYNTH_ARCH, global_blocks=[2, 5])
    assert sorted(os.listdir(out / "ckpt")) == ["2"]
    monkeypatch.setenv("QUBER_SAMHQ_CKPT", str(out / "ckpt"))
    refiner = build_refiner_model("hq-sam", "OSD", device="cpu")
    want = state_dict_from_jax(load_eval_params(str(out / "ckpt")))
    got = refiner.model.state_dict()
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    tree = jax_load_quantized(str(out / "samhq_int8.npz"))
    jm = J.SAMHQ(**jzoo.SAMHQ_SYNTH_ARCH)
    shapes = jax.eval_shape(lambda k: J.init_sam_variables(jm, k), jax.random.PRNGKey(0))
    assert jax.tree.structure(tree) == jax.tree.structure(shapes)
    assert all(a.shape == b.shape for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(shapes)))

"""The port's MSMFormer against the JAX package (quber_tpu/models/msmformer.py)
at a small size: dim 64, 8 queries, one encoder and one decoder layer, a
64x96 frame.

Parameters are the JAX package's init with the sampling offsets randomised
(so that the deformable attention samples off its reference points),
carried across with from_jax. Tolerances: the float32 forward within 1e-4
of max |JAX|; the bfloat16 forward held by the ratio rule of
tests/test_torch_bf16.py (mean |port bf16 - JAX bf16| below mean |JAX bf16
- JAX f32| on each output, over two frames, JAX's bf16 run op by op: the
two frameworks round bfloat16 in other places) and, against the jitted JAX
bf16 that the wrapper and the recipe run, the port's mean |bf16 - f32|
within 0.5-2x of JAX's;
masks_from_queries and hungarian_match exactly (the latter also against
scipy, and with invalid targets -> -1); the set loss rtol 1e-4 and its
gradient on every parameter within 15% of the gradient's norm
(tests/test_torch_train.py's rule: one ReLU or a GroupNorm statistic in
another summation order moves a tensor's gradient by a few percent).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from quber_tpu.models import msmformer as JM
from quber_tpu_torch.models import msmformer as TM
from quber_tpu_torch.models.from_jax import state_dict_from_jax, state_dict_to_jax
from quber_tpu_torch.models.layers import flax_softmax

H, W = 64, 96
SMALL = dict(dim=64, num_queries=8, encoder_layers=1, decoder_layers=1)
F32_RTOL = 1e-4
GRAD_SHARE = 0.15


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


@pytest.fixture(scope="module")
def setup():
    """(inputs, JAX variables with randomised offsets, the JAX float32 and
    bfloat16 outputs)."""
    rng = np.random.RandomState(0)
    rgb = rng.randn(2, H, W, 3).astype(np.float32)
    xyz = rng.randn(2, H, W, 3).astype(np.float32)
    jm = JM.MSMFormer(**SMALL)
    v = jax.tree.map(np.asarray, dict(jax.jit(jm.init)(jax.random.PRNGKey(0), rgb, xyz)))
    kernel = v["params"]["enc_0"]["offsets"]["kernel"]
    v["params"]["enc_0"]["offsets"]["kernel"] = (rng.randn(*kernel.shape) * 0.05).astype(np.float32)
    want32 = jax.tree.map(np.asarray, jax.jit(jm.apply)(v, rgb, xyz))
    # op by op, as tests/test_torch_bf16.py runs it, and jitted, as the
    # reference's wrapper and recipe run it (XLA fuses the elementwise steps
    # and drops roundings inside a fusion)
    bf16 = JM.MSMFormer(**SMALL, dtype=jnp.bfloat16)
    want16 = {how: jax.tree.map(np.asarray, fn(v, rgb, xyz))
              for how, fn in (("op by op", bf16.apply), ("jitted", jax.jit(bf16.apply)))}
    return (rgb, xyz), v, want32, want16


def _port(variables, dtype=torch.float32):
    model = TM.MSMFormer(**SMALL, dtype=dtype).eval()
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def test_forward_float32(setup):
    (rgb, xyz), v, want, _ = setup
    with torch.no_grad():
        got = _port(v)(nchw(rgb), nchw(xyz))
    assert got["mask_logits"].shape == (2, 8, H // 4, W // 4)
    for k in ("mask_logits", "objectness"):
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=F32_RTOL * np.abs(want[k]).max(), err_msg=k)


def test_forward_bfloat16_follows_jax_bfloat16(setup):
    (rgb, xyz), v, want32, want16 = setup
    with torch.no_grad():
        got = _port(v, torch.bfloat16)(nchw(rgb), nchw(xyz))
    for k in ("mask_logits", "objectness"):
        ours = got[k].float().numpy()
        gap = np.abs(ours - want16["op by op"][k]).mean()
        bf16 = np.abs(want16["op by op"][k] - want32[k]).mean()
        assert bf16 > 0 and gap < bf16, (k, gap, bf16)
        # the jitted bf16 is as far from the op-by-op one as from float32:
        # against it the port's own bf16 error is held to 0.5-2x its error
        err = np.abs(ours - want32[k]).mean()
        jit_err = np.abs(want16["jitted"][k] - want32[k]).mean()
        assert 0.5 * jit_err < err < 2 * jit_err, (k, err, jit_err)


def test_bfloat16_gelu_and_softmax_follow_jitted_jax():
    """The port's bfloat16 GELU and softmax round each step, as jitted XLA
    does on these ops (it does not round once at a fusion's end): GELU
    bit-equal to jax.jit(nn.gelu), softmax below 10% of the elements off
    jax.jit(jax.nn.softmax) where torch.softmax, which rounds once, is off on
    more than half."""
    import flax.linen as nn
    import torch.nn.functional as F

    x = np.random.RandomState(0).randn(2, 8, 50, 50).astype(np.float32) * 3
    xb, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    off = lambda a, b: float((a.float().numpy() != np.asarray(b, np.float32)).mean())  # noqa: E731
    assert off(TM.gelu(tx), jax.jit(nn.gelu)(xb)) == 0.0
    assert off(F.gelu(tx, approximate="tanh"), jax.jit(nn.gelu)(xb)) > 0.3
    want = jax.jit(jax.nn.softmax)(xb)
    assert off(flax_softmax(tx), want) < 0.1 and off(torch.softmax(tx, -1), want) > 0.5


def test_variables_round_trip(setup):
    _, v, _, _ = setup
    back = state_dict_to_jax(_port(v))
    flat = lambda t: dict(jax.tree_util.tree_leaves_with_path(t))  # noqa: E731
    want, got = flat(v), flat(back)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masks_from_queries_exact(seed):
    rng = np.random.RandomState(seed)
    q, h, w = 10, 40, 56
    logits = (rng.randn(q, h, w) * 4).astype(np.float32)
    logits[3] = logits[5]  # equal probabilities: the lower query wins
    obj = (rng.randn(q) * 2).astype(np.float32)
    labels, n = JM.masks_from_queries(jnp.asarray(logits), jnp.asarray(obj), min_pixels=64)
    got, got_n = TM.masks_from_queries(torch.from_numpy(logits), torch.from_numpy(obj),
                                       min_pixels=64)
    assert got.dtype == torch.int32 and int(got_n) == int(n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(labels))
    assert int(n) > 0


@pytest.mark.parametrize("n_valid", [0, 3, 6])
def test_hungarian_match_equals_jax_and_scipy(n_valid):
    rng = np.random.RandomState(n_valid)
    q, n = 9, 6
    cost = rng.rand(q, n).astype(np.float32)  # tie-free
    valid = np.arange(n) < n_valid
    valid = valid[rng.permutation(n)]
    want = np.asarray(JM.hungarian_match(jnp.asarray(cost), jnp.asarray(valid)))
    got = TM.hungarian_match(torch.from_numpy(cost), torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    rows, cols = linear_sum_assignment(cost.T[valid])
    np.testing.assert_array_equal(got[valid][rows], cols)
    assert (got[~valid] == -1).all()


def _gt(rng, n_valid):
    labels = rng.randint(0, n_valid + 1, (H // 4, W // 4))
    gt = (labels[None] == 1 + np.arange(6)[:, None, None]).astype(np.float32)
    return gt[None], (np.arange(6) < n_valid)[None]


def test_set_loss_and_its_gradient(setup):
    (rgb, xyz), v, _, _ = setup
    gt, valid = _gt(np.random.RandomState(3), 4)
    jm = JM.MSMFormer(**SMALL)

    def loss_fn(params):
        out = jm.apply(params, rgb[:1], xyz[:1])
        parts = JM.msmformer_set_loss(out, jnp.asarray(gt), jnp.asarray(valid))
        return sum(parts.values()), parts

    (loss, parts), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v)
    model = _port(v)
    got_parts = TM.msmformer_set_loss(model(nchw(rgb[:1]), nchw(xyz[:1])), torch.from_numpy(gt),
                                      torch.from_numpy(valid))
    sum(got_parts.values()).backward()
    for k in parts:
        assert float(got_parts[k].detach()) == pytest.approx(float(parts[k]), rel=1e-4), k
    want = state_dict_from_jax(jax.tree.map(np.asarray, dict(grads)))
    # a conv bias ahead of a GroupNorm has an exactly zero gradient, which
    # both frameworks return as float noise: below a thousandth of the
    # largest gradient it is held to that bound alone
    noise = 1e-3 * max(float(w.norm()) for w in want.values())
    compared = 0
    for name, p in model.named_parameters():
        g = want[name].double()
        if float(g.norm()) <= noise:
            assert float(p.grad.norm()) <= noise, name
            continue
        assert float((p.grad.double() - g).norm()) <= GRAD_SHARE * float(g.norm()), name
        compared += 1
    assert compared > 100

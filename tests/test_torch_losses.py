"""Losses, morphology and the train mode of the layers: the torch port
against quber_tpu.

Inputs are made with numpy from a seed and go through the JAX function and
its counterpart. The JAX side is channels-last, the port channels-first.
Losses: rtol 1e-5 (float32 sums in another order). Morphology: exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from quber_tpu.models import layers as JL
from quber_tpu.models import mask_refiner as JM
from quber_tpu.ops import morphology as JMo
from quber_tpu_torch.models import layers as TL
from quber_tpu_torch.models import mask_refiner as TM
from quber_tpu_torch.models import resnet as TR
from quber_tpu_torch.models.from_jax import state_dict_from_jax
from quber_tpu_torch.ops import morphology as TMo

RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # the suite runs several workers side by side
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def nchw(x):
    return t(np.moveaxis(x, -1, 1))


def test_bce_with_logits():
    rng = np.random.RandomState(0)
    logits = (rng.randn(2, 24, 40) * 6).astype(np.float32)
    targets = (rng.rand(2, 24, 40) > 0.5).astype(np.float32)
    want = np.asarray(JM._bce_with_logits(jnp.asarray(logits), jnp.asarray(targets)))
    got = TM._bce_with_logits(t(logits), t(targets)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("top_k", [1.0, 0.2, 1e-9])
@pytest.mark.parametrize("weighted", [False, True])
def test_foreground_loss(top_k, weighted):
    rng = np.random.RandomState(1)
    logits = (rng.randn(2, 48, 64) * 3).astype(np.float32)
    targets = (rng.rand(2, 48, 64) > 0.6).astype(np.float32)
    weights = rng.choice([1.0, 3.0], size=(2, 48, 64)).astype(np.float32) if weighted else None
    want = float(JM.foreground_loss(jnp.asarray(logits), jnp.asarray(targets),
                                    None if weights is None else jnp.asarray(weights), top_k))
    got = float(TM.foreground_loss(t(logits), t(targets),
                                   None if weights is None else t(weights), top_k))
    assert got == pytest.approx(want, rel=RTOL)


@pytest.mark.parametrize("zero_weights", [False, True])
def test_weighted_mse_and_l1_loss(zero_weights):
    rng = np.random.RandomState(2)
    pred = rng.randn(2, 32, 48, 2).astype(np.float32) * 10
    target = rng.randn(2, 32, 48, 2).astype(np.float32) * 10
    w = np.zeros((2, 32, 48), np.float32) if zero_weights else \
        (rng.rand(2, 32, 48) > 0.7).astype(np.float32)
    want = float(JM.weighted_mse_loss(jnp.asarray(pred[..., 0]), jnp.asarray(target[..., 0]),
                                      jnp.asarray(w)))
    got = float(TM.weighted_mse_loss(t(pred[..., 0]), t(target[..., 0]), t(w)))
    assert got == pytest.approx(want, rel=RTOL)
    # the weight broadcasts over the two offset channels, its sum counts once
    want = float(JM.weighted_l1_loss(jnp.asarray(pred), jnp.asarray(target),
                                     jnp.asarray(w)[..., None]))
    got = float(TM.weighted_l1_loss(nchw(pred), nchw(target), t(w)[:, None]))
    assert got == pytest.approx(want, rel=RTOL)
    if zero_weights:
        assert got == 0.0


@pytest.mark.parametrize("channels", [2, 4])
def test_dice_loss(channels):
    rng = np.random.RandomState(3)
    logits = rng.randn(2, 32, 48, channels).astype(np.float32) * 2
    targets = np.eye(channels, dtype=np.float32)[rng.randint(0, channels, (2, 32, 48))]
    want = float(JM.dice_loss(jnp.asarray(logits), jnp.asarray(targets)))
    got = float(TM.dice_loss(nchw(logits), nchw(targets)))
    assert got == pytest.approx(want, rel=RTOL)


@pytest.mark.parametrize("error_type", ["e3", "e2", "e33", "e32"])
def test_assemble_eee_targets(error_type):
    rng = np.random.RandomState(4)
    maps = np.eye(4, dtype=np.float32)[rng.randint(0, 4, (2, 16, 24))]  # one-hot TP/TN/FP/FN
    parts = [maps[..., i] for i in range(4)]
    want = np.asarray(JM.assemble_eee_targets(*[jnp.asarray(p) for p in parts], error_type))
    got = TM.assemble_eee_targets(*[t(p) for p in parts], error_type).numpy()
    np.testing.assert_array_equal(got, np.moveaxis(want, -1, 1))
    with pytest.raises(ValueError):
        TM.assemble_eee_targets(*[t(p) for p in parts], "e5")


def _loss_inputs(rng, b, h, w, c):
    s = 4
    outputs = {
        "foreground": rng.randn(b, h // s, w // s, 1).astype(np.float32) * 2,
        "center": rng.rand(b, h // s, w // s, 1).astype(np.float32),
        "offset": rng.randn(b, h // s, w // s, 2).astype(np.float32) * 5,
        "eee_mask": rng.randn(b, h // s, w // s, c).astype(np.float32),
        "eee_boundary": rng.randn(b, h // s, w // s, c).astype(np.float32),
    }
    fg = (rng.rand(b, h, w) > 0.5).astype(np.float32)
    targets = {
        "sem_seg": fg,
        "sem_seg_weights": rng.choice([1.0, 3.0], size=(b, h, w)).astype(np.float32),
        "center": rng.rand(b, h, w).astype(np.float32),
        "center_weights": fg,
        "offset": rng.randn(b, h, w, 2).astype(np.float32) * 20,
        "offset_weights": fg,
        "eee_mask": np.eye(c, dtype=np.float32)[rng.randint(0, c, (b, h, w))],
        "eee_boundary": np.eye(c, dtype=np.float32)[rng.randint(0, c, (b, h, w))],
    }
    return outputs, targets


def _channels_first(d):
    return {k: nchw(v) if v.ndim == 4 else t(v) for k, v in d.items()}


@pytest.mark.parametrize("overrides", [
    {},
    {"foreground_loss_top_k": 0.2, "error_type": "e3"},
    {"eee_mask_on": False, "eee_boundary_on": False, "center_loss_weight": 100.0},
])
def test_compute_losses(overrides):
    rng = np.random.RandomState(5)
    jcfg = JM.MaskRefinerConfig(height=32, width=48, **overrides)
    tcfg = TM.MaskRefinerConfig(height=32, width=48, **overrides)
    outputs, targets = _loss_inputs(rng, 2, 32, 48, jcfg.eee_channels)
    if "sem_seg_weights" in targets and overrides.get("eee_mask_on") is False:
        del targets["sem_seg_weights"]  # the optional field
    want = JM.compute_losses({k: jnp.asarray(v) for k, v in outputs.items()},
                             {k: jnp.asarray(v) for k, v in targets.items()}, jcfg)
    got = TM.compute_losses(_channels_first(outputs), _channels_first(targets), tcfg)
    assert set(got) == set(want)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=RTOL), k


# --- morphology -------------------------------------------------------------

def _border_masks(rng, n, h, w):
    """Rectangles and discs, several of them touching the image border."""
    ys, xs = np.mgrid[:h, :w]
    out = np.zeros((n, h, w), np.uint8)
    for i in range(n):
        if i % 2:
            y0, x0 = rng.randint(-5, h - 8), rng.randint(-5, w - 8)
            out[i, max(y0, 0):y0 + rng.randint(8, h), max(x0, 0):x0 + rng.randint(8, w)] = 1
        else:
            cy, cx, r = rng.randint(0, h), rng.randint(0, w), rng.randint(4, h // 2)
            out[i] = (ys - cy) ** 2 + (xs - cx) ** 2 <= r * r
    out[0, :, :] = 1  # the whole frame: erodes inward from every side
    return out


@pytest.mark.parametrize("iterations", [0, 1, 3, 8])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_erode_dilate_exact(iterations, dtype):
    masks = _border_masks(np.random.RandomState(6), 6, 40, 56).astype(dtype)
    for jfn, tfn in ((JMo.erode, TMo.erode), (JMo.dilate, TMo.dilate)):
        want = np.asarray(jfn(jnp.asarray(masks), iterations))
        got = tfn(t(masks), iterations)
        assert got.dtype == t(masks).dtype
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(tfn(t(masks[1]), iterations).numpy(), want[1])
    if iterations:
        assert TMo.erode(t(masks), iterations)[0, 0, 0] == 0  # the border erodes


def test_boundary_width_and_bands():
    assert TMo.boundary_width(480, 640, 0.01) == JMo.boundary_width(480, 640, 0.01) == 8
    assert TMo.boundary_width(8, 8, 0.01) == 1
    masks = _border_masks(np.random.RandomState(7), 5, 96, 128)
    want = np.asarray(JMo.mask_to_boundary(jnp.asarray(masks)))
    np.testing.assert_array_equal(TMo.mask_to_boundary(t(masks)).numpy(), want)
    valid = np.array([True, True, False, True, False])
    for v in (None, valid):
        jv, tv = (None, None) if v is None else (jnp.asarray(v), t(v))
        np.testing.assert_array_equal(TMo.masks_to_fg(t(masks), tv).numpy(),
                                      np.asarray(JMo.masks_to_fg(jnp.asarray(masks), jv)))
        np.testing.assert_array_equal(
            TMo.masks_to_boundary(t(masks), tv).numpy(),
            np.asarray(JMo.masks_to_boundary(jnp.asarray(masks), jv)))
    np.testing.assert_array_equal(TMo.seg2bmap(t(masks)).numpy(),
                                  np.asarray(JMo.seg2bmap(jnp.asarray(masks))))


@pytest.mark.parametrize("batched", [False, True])
def test_quadruple_error_maps_exact(batched):
    rng = np.random.RandomState(8)
    h, w = 120, 160  # boundary width 2
    gt = np.stack([_border_masks(rng, 6, h, w) for _ in range(2)])
    pred = np.roll(gt, (3, -2), axis=(2, 3))
    gv = np.array([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1]], bool)
    pv = np.array([[1, 1, 1, 0, 0, 0], [0, 1, 1, 1, 1, 1]], bool)
    want = [JMo.quadruple_error_maps(jnp.asarray(gt[b]), jnp.asarray(pred[b]),
                                     jnp.asarray(gv[b]), jnp.asarray(pv[b])) for b in range(2)]
    if batched:
        got = TMo.quadruple_error_maps(t(gt), t(pred), t(gv), t(pv))
        got = [{k: v[b] for k, v in got.items()} for b in range(2)]
    else:
        got = [TMo.quadruple_error_maps(t(gt[b]), t(pred[b]), t(gv[b]), t(pv[b]))
               for b in range(2)]
    for g, wnt in zip(got, want):
        assert set(g) == set(wnt)
        for k in wnt:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(wnt[k]), err_msg=k)
        assert g["mask"].sum(dim=0).eq(1).all()  # TP/TN/FP/FN partition the frame


# --- train mode of the layers ------------------------------------------------

def test_batchnorm_train_mode_matches_flax():
    """Batch statistics normalise; the running ones move by 0.1 towards the
    batch's mean and BIASED variance (flax momentum 0.9). rtol/atol 1e-4."""
    rng = np.random.RandomState(9)
    x = rng.randn(2, 12, 16, 24).astype(np.float32) * 2 + 1
    jmod = JL.ConvNorm(32, 3, use_bias=True, norm="BN", act=nn.relu, train=True)
    variables = jax.tree.map(np.asarray, dict(jmod.init(jax.random.PRNGKey(0), x)))
    variables["batch_stats"]["BatchNorm_0"]["var"] = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    variables["batch_stats"]["BatchNorm_0"]["mean"] = rng.randn(32).astype(np.float32)
    tmod = TL.ConvNorm(24, 32, 3, use_bias=True, norm="BN", act=F.relu)
    tmod.load_state_dict(state_dict_from_jax(variables), strict=True)
    tmod.train()
    want, updated = jmod.apply(variables, x, mutable=["batch_stats"])
    got = tmod(nchw(x))
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    stats = updated["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(tmod.norm.running_mean.numpy(), np.asarray(stats["mean"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tmod.norm.running_var.numpy(), np.asarray(stats["var"]),
                               rtol=1e-4, atol=1e-5)
    # eval mode reads the statistics and leaves them alone
    tmod.eval()
    before = tmod.norm.running_var.clone()
    tmod(nchw(x))
    assert torch.equal(tmod.norm.running_var, before)


def test_frozen_batchnorm_is_frozen_in_train_mode():
    mod = TL.ConvNorm(8, 16, 3, norm="FrozenBN").train()
    before = {k: v.clone() for k, v in mod.norm.state_dict().items()}
    y = mod(torch.randn(2, 8, 12, 12, generator=torch.Generator().manual_seed(0)))
    y.sum().backward()
    assert all(torch.equal(v, before[k]) for k, v in mod.norm.state_dict().items())
    assert not list(mod.norm.parameters())  # buffers: no optimizer ever sees them


def test_aspp_dropout_reproducible_and_scaled():
    """Dropout masks cannot match JAX's; the port's come from its generator:
    the same seed gives the same output, kept values scale by 1 / (1 - p),
    and eval mode drops nothing."""
    p = 0.25
    mod = TL.ASPP(16, 32, (2, 4, 6), "GN", dropout=p)
    x = torch.randn(2, 16, 20, 24, generator=torch.Generator().manual_seed(1))
    mod.eval()
    with torch.no_grad():
        clean = mod(x)
    mod.train()
    with pytest.raises(RuntimeError):
        mod(x)  # no generator given
    outs = []
    for seed in (3, 3, 4):
        mod.dropout_generator = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            outs.append(mod(x))
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    kept = outs[0] != 0
    torch.testing.assert_close(outs[0][kept], clean[kept] / (1 - p))
    dropped = float(((outs[0] == 0) & (clean != 0)).sum() / (clean != 0).sum())
    assert abs(dropped - p) < 0.03
    zero = TL.ASPP(16, 32, (2, 4, 6), "GN", dropout=0.0).train()
    zero.load_state_dict(mod.state_dict())
    with torch.no_grad():
        assert torch.equal(zero(x), clean)  # dropout 0 needs no generator


def test_remat_backbone_gives_the_same_gradients():
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(1, 6, 32, 32, generator=gen)
    plain = TR.ResNetTrunk(6, depth=14)
    remat = TR.ResNetTrunk(6, depth=14, remat=True)
    remat.load_state_dict(plain.state_dict())
    grads = []
    for mod in (plain, remat):
        out = mod(x)
        sum(v.square().mean() for v in out.values()).backward()
        grads.append({k: p.grad for k, p in mod.named_parameters()})
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=1e-5, atol=1e-7)
    cfg = dataclasses.replace(TM.MaskRefinerConfig(resnet_depth=14), remat_backbone=True)
    assert TM.MaskRefiner(cfg).backbone.rgb_trunk.remat

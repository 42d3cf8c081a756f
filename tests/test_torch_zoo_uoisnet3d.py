"""UOIS-Net-3D in the port (models/uois_net.py, uois_net_pretrained.py)
against the JAX package's (quber_tpu/models/uois_net.py,
uois_net_pretrained.py) on the CPU, at small sizes.

Tolerances: each float32 forward (the native DSN and RRN at their widths on
64x96, the released architectures at feature_dim 10) within 1e-4 of max
|JAX| per output, its weights carried across by models/from_jax and back
by state_dict_to_jax unchanged; each bfloat16 native forward's mean |port -
JAX| within 2x the mean |bf16 - float32| of the JAX package's own; every
loss rtol 1e-4 with the cluster loss's draws (jax.random.choice's indices)
handed over, its gradients with respect to the logits and offsets within
1e-3 of their norm; the wrappers' pipelines (the float32 models, both
frameworks: at a random init bfloat16 decides the argmax foreground
differently) on a rendered 96x128 scene the instance count equal and >=
99.5% of the labels, with the heads' offset weights zeroed so that the
votes are the cloud itself and the foreground taking every pixel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quber_tpu.models import uois_net as JU
from quber_tpu.models import uois_net_pretrained as JUP
from quber_tpu_torch.models import uois_net as TU
from quber_tpu_torch.models import uois_net_pretrained as TUP
from quber_tpu_torch.models.from_jax import state_dict_from_jax, state_dict_to_jax
from quber_tpu_torch.models.layers import set_compute_dtype

H, W = 64, 96
FD = 10
RTOL = 1e-4
LOSS_RTOL = 1e-4
GRAD_SHARE = 1e-3
AGREEMENT = 0.995
BF16_RATIO = 2.0

MODELS = {
    # name: (JAX module, port module, input channels, input size)
    "dsn": (lambda **k: JU.DepthSeedingNetwork(**k), lambda **k: TU.DepthSeedingNetwork(**k),
            3, (H, W)),
    "rrn": (lambda **k: JU.RegionRefinementNetwork(**k),
            lambda **k: TU.RegionRefinementNetwork(**k), 4, (H, W)),
    "pretrained_dsn": (lambda **k: JUP.PretrainedDSN(feature_dim=FD, **k),
                       lambda **k: TUP.PretrainedDSN(feature_dim=FD, **k), 3, (H, W)),
    "pretrained_rrn": (lambda **k: JUP.PretrainedRRN(feature_dim=FD, **k),
                       lambda **k: TUP.PretrainedRRN(feature_dim=FD, **k), 4, (64, 64)),
}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _outputs(out):
    out = out if isinstance(out, tuple) else (out,)
    return [np.asarray(o) for o in out]


def _port_outputs(out):
    out = out if isinstance(out, tuple) else (out,)
    return [(o.permute(0, 2, 3, 1) if o.dim() == 4 else o).detach().float().numpy() for o in out]


@pytest.mark.parametrize("name", list(MODELS))
def test_forwards_match_jax(name):
    make_j, make_t, c, size = MODELS[name]
    x = np.random.RandomState(1).randn(1, *size, c).astype(np.float32)
    variables = _np(jax.jit(make_j().init)(jax.random.PRNGKey(3), x))
    want = _outputs(jax.jit(make_j().apply)(variables, x))
    model = make_t().eval()
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got = _port_outputs(model(torch.from_numpy(x).permute(0, 3, 1, 2)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = w if w.ndim == g.ndim else w[..., 0]
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= RTOL * np.abs(w).max(), (name, np.abs(g - w).max())
    back = state_dict_to_jax(model)
    assert jax.tree.structure(back) == jax.tree.structure(variables)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["dsn", "rrn"])
def test_bfloat16_forwards_against_jax_own_distance(name):
    make_j, make_t, c, size = MODELS[name]
    x = np.random.RandomState(2).randn(1, *size, c).astype(np.float32)
    variables = _np(jax.jit(make_j().init)(jax.random.PRNGKey(4), x))
    f32 = _outputs(jax.jit(make_j().apply)(variables, x))
    bf16 = _outputs(jax.jit(make_j(dtype=jnp.bfloat16).apply)(variables, x))
    model = make_t(dtype=torch.bfloat16).eval()
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got = _port_outputs(model(torch.from_numpy(x).permute(0, 3, 1, 2)))
    for g, b, f in zip(got, bf16, f32):
        own = np.abs(b - f).mean()
        assert own > 0
        assert np.abs(g - b).mean() <= BF16_RATIO * own, (name, np.abs(g - b).mean(), own)


def _loss_inputs(seed=0, k=4, object_label=1):
    rng = np.random.RandomState(seed)
    labels = np.zeros((H, W), np.int32)
    centers = np.zeros((k, 3), np.float32)
    valid = np.zeros(k, bool)
    xyz = rng.randn(H, W, 3).astype(np.float32) * 0.1
    offsets_t = np.zeros((H, W, 3), np.float32)
    for i in range(k - 1):  # the last slot stays empty
        y0, x0 = rng.randint(0, H - 20), rng.randint(0, W - 24)
        labels[y0:y0 + 16 + 2 * i, x0:x0 + 20] = object_label + i
    for i in range(k):
        m = labels == object_label + i
        if m.any():
            centers[i] = xyz[m].mean(0)
            offsets_t[m] = centers[i] - xyz[m]
            valid[i] = True
    fg_logits = rng.randn(H, W, 2).astype(np.float32)
    offsets = rng.randn(H, W, 3).astype(np.float32) * 0.05
    return fg_logits, offsets, xyz, offsets_t, labels, centers, valid


def _jax_draws(key, labels, object_label, num_samples=256, num_seeds=32):
    """The indices jax.random.choice draws inside the reference's cluster loss."""
    fg = (labels.reshape(-1) >= object_label).astype(np.float32)
    total = fg.sum()
    p = fg / max(total, 1.0) if total > 0 else np.full_like(fg, 1.0 / fg.shape[0])
    k1, k2 = jax.random.split(key)
    idx = jax.random.choice(k1, fg.shape[0], (num_samples,), replace=True, p=jnp.asarray(p))
    sidx = jax.random.choice(k2, num_samples, (num_seeds,), replace=True)
    return torch.from_numpy(np.array(idx)).long(), torch.from_numpy(np.array(sidx)).long()


@pytest.mark.parametrize("object_label", [1, 2])
def test_dsn_train_losses_match_jax(object_label):
    fg_logits, offsets, xyz, offsets_t, labels, centers, valid = _loss_inputs(
        object_label=object_label)
    key = jax.random.PRNGKey(5)
    kw = dict(object_label=object_label, sigma=0.05, delta=0.1)

    def jax_total(fgl, off):
        parts = JU.dsn_train_losses(fgl, off, xyz, offsets_t, labels, centers, valid, key, **kw)
        return sum(parts.values()), parts

    (_, want), (g_fg, g_off) = jax.value_and_grad(jax_total, argnums=(0, 1), has_aux=True)(
        jnp.asarray(fg_logits), jnp.asarray(offsets))
    idx, sidx = _jax_draws(key, labels, object_label)
    t_fg = torch.from_numpy(fg_logits).requires_grad_()
    t_off = torch.from_numpy(offsets).requires_grad_()
    got = TU.dsn_train_losses(t_fg, t_off, torch.from_numpy(xyz), torch.from_numpy(offsets_t),
                              torch.from_numpy(labels), torch.from_numpy(centers),
                              torch.from_numpy(valid), idx, sidx, **kw)
    assert set(got) == set(want)
    for k, v in want.items():
        assert float(got[k].detach()) == pytest.approx(float(v), rel=LOSS_RTOL), k
        assert float(v) > 0, k
    sum(got.values()).backward()
    for t, g in ((t_fg, g_fg), (t_off, g_off)):
        g = np.asarray(g)
        assert np.linalg.norm(t.grad.numpy() - g) <= GRAD_SHARE * np.linalg.norm(g)


def test_cluster_loss_without_foreground_is_zero():
    votes = torch.randn(H, W, 3)
    labels = torch.zeros(H, W, dtype=torch.int32)
    idx, sidx = TU.draw_cluster_indices(labels, torch.Generator().manual_seed(0))
    assert float(TU.dsn_cluster_loss(votes, labels, idx, sidx, num_classes=4)) == 0.0
    want = JU.dsn_cluster_loss(jnp.asarray(votes.numpy()), jnp.asarray(labels.numpy()),
                               jax.random.PRNGKey(0), num_classes=4)
    assert float(want) == 0.0


def test_draw_cluster_indices_take_the_foreground():
    labels = torch.zeros(H, W, dtype=torch.int32)
    labels[10:20, 30:50] = 3
    labels[40:44, 5:9] = 2
    idx, sidx = TU.draw_cluster_indices(labels, torch.Generator().manual_seed(1), object_label=2,
                                        num_samples=500, num_seeds=40)
    assert idx.shape == (500,) and sidx.shape == (40,)
    assert bool((labels.reshape(-1)[idx] >= 2).all())
    assert int(sidx.min()) >= 0 and int(sidx.max()) < 500
    # proportional to the foreground: the small object gets its share
    small = float((labels.reshape(-1)[idx] == 2).float().mean())
    assert 0.02 < small < 0.15


def test_small_losses_match_jax():
    rng = np.random.RandomState(3)
    fg_logits = rng.randn(H, W, 2).astype(np.float32)
    offsets = rng.randn(H, W, 3).astype(np.float32)
    off_t = rng.randn(H, W, 3).astype(np.float32)
    fg_t = (rng.rand(H, W) > 0.6).astype(np.int32)
    want = JU.dsn_losses(fg_logits, offsets, fg_t, off_t, fg_weight=2.0)
    got = TU.dsn_losses(*(torch.from_numpy(a) for a in (fg_logits, offsets, fg_t, off_t)),
                        fg_weight=2.0)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=LOSS_RTOL), k
    logits = rng.randn(H, W).astype(np.float32) * 3
    assert float(TU.rrn_loss(torch.from_numpy(logits), torch.from_numpy(fg_t.astype(np.float32)))) \
        == pytest.approx(float(JU.rrn_loss(logits, fg_t.astype(np.float32))), rel=LOSS_RTOL)
    labels = rng.randint(0, 5, (3, 7)).astype(np.int32)
    for kw in (dict(), dict(ignore=(0, 1)), dict(image_axes=(-1,))):
        np.testing.assert_allclose(
            TU.inverse_frequency_weights(torch.from_numpy(labels), 6, **kw).numpy(),
            np.asarray(JU.inverse_frequency_weights(labels, 6, **kw)), rtol=1e-6)


def _scene(h=96, w=128, seed=11):
    import train_zoo_torch

    pool = train_zoo_torch.make_labeled_scenes(1, h, w, seed, (250, 1500))
    return pool["rgb"][0], pool["xyz"][0]


def _float32_native(dsn_vars, rrn_vars):
    """Both frameworks' native wrappers over the same variables, float32
    models, the DSN head's offset rows zeroed and its foreground bias
    raised."""
    dsn_vars = _np(dsn_vars)
    head = dsn_vars["params"]["unet"]["head"]
    head["kernel"] = head["kernel"].copy()
    head["kernel"][..., 2:] = 0.0
    head["bias"] = head["bias"].copy()
    head["bias"][1] += 5.0
    ref = JU.UOISNet3DBaseModel(dsn_params=dsn_vars, rrn_params=rrn_vars)
    ref.dsn, ref.rrn = JU.DepthSeedingNetwork(), JU.RegionRefinementNetwork()
    port = TU.UOISNet3DBaseModel(dsn_params=dsn_vars, rrn_params=rrn_vars, device="cpu")
    set_compute_dtype(port.dsn, torch.float32)
    set_compute_dtype(port.rrn, torch.float32)
    return ref, port


def _labels(masks):
    out = np.zeros(masks.shape[1:], np.int32)
    for i, m in enumerate(masks):
        out[m] = i + 1
    return out


def test_native_pipeline_matches_jax():
    rgb, xyz = _scene()
    dsn_vars = jax.jit(JU.DepthSeedingNetwork().init)(jax.random.PRNGKey(0), xyz[None])
    rrn_vars = _np(jax.jit(JU.RegionRefinementNetwork().init)(
        jax.random.PRNGKey(1), np.zeros((1, 96, 128, 4), np.float32)))
    ref, port = _float32_native(dsn_vars, rrn_vars)
    assert port.dsn.dtype == torch.float32 and port.MAX_INSTANCES == ref.MAX_INSTANCES
    want, n_want = ref._pipeline(ref.dsn_params, ref.rrn_params, rgb, xyz)
    want, n_want = np.asarray(want), int(n_want)
    got, n_got = port.segment(torch.from_numpy(rgb).permute(2, 0, 1),
                              torch.from_numpy(xyz).permute(2, 0, 1))
    got = got.numpy()
    assert int(n_got) == n_want and n_want > 1
    assert not want[n_want:].any() and not got[n_want:].any()
    assert want[:n_want].any()
    agree = (_labels(got[:n_want]) == _labels(want[:n_want])).mean()
    assert agree >= AGREEMENT, agree


def pretrained_state(fd=FD, seed=0):
    """PretrainedDSN / PretrainedRRN state dicts (the reference's names) of
    width `fd`, LeCun-initialised from `seed`, the GroupNorms moved by
    seeded noise; the DSN's centre head zeroed and its object class taking
    every pixel (the decoder's last bias +3 and the object row of the class
    head +1)."""
    out = {}
    for i, cls in enumerate((TUP.PretrainedDSN, TUP.PretrainedRRN)):
        model = cls(feature_dim=fd)
        g = torch.Generator().manual_seed(seed + i)
        model.reset_parameters(g)
        sd = {k: v.clone() for k, v in model.state_dict().items()}
        for k, v in sd.items():
            if ".gn" in k:
                sd[k] = v + 0.1 * torch.randn(v.shape, generator=g)
        if cls is TUP.PretrainedDSN:
            sd["cd_module.weight"].zero_()
            sd["fg_module.weight"].zero_()
            sd["fg_module.weight"][2] = 1.0
            sd["decoder.last_conv.bias"] += 3.0
        out["dsn" if i == 0 else "rrn"] = sd
    return out


def test_pretrained_pipeline_matches_jax():
    from quber_tpu_torch.models.from_jax import state_dict_to_jax as to_jax

    rgb, xyz = _scene()
    state = pretrained_state()
    port = TUP.UOISNet3DPretrainedBaseModel(state["dsn"], state["rrn"], device="cpu")
    assert port.dsn.dtype == torch.bfloat16
    TUP.set_dtype(port.dsn, torch.float32)
    TUP.set_dtype(port.rrn, torch.float32)
    ref = JUP.UOISNet3DPretrainedBaseModel(to_jax(port.dsn), to_jax(port.rrn), feature_dim=FD)
    ref.dsn, ref.rrn = JUP.PretrainedDSN(feature_dim=FD), JUP.PretrainedRRN(feature_dim=FD)
    want, n_want, fg_want = (np.asarray(a) for a in ref._pipeline(
        ref.dsn_variables, ref.rrn_variables, rgb, xyz))
    got, n_got, fg_got = port.segment(torch.from_numpy(rgb).permute(2, 0, 1),
                                      torch.from_numpy(xyz).permute(2, 0, 1))
    assert int(n_got) == int(n_want) > 1
    np.testing.assert_array_equal(fg_got.numpy(), fg_want)
    assert len(np.unique(want)) > 2
    agree = (got.numpy() == want).mean()
    assert agree >= AGREEMENT, agree

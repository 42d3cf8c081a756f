"""The CascadePSP-RGBD and RICE refiner baselines in the port
(models/cascadepsp.py, models/rice.py, layers.resize_bilinear) against the
JAX package's (quber_tpu/models/cascadepsp.py, rice.py) on the CPU.

Tolerances: jax.image.resize's antialiased bilinear between 480x640 and
224x224, both ways, within 1e-6; the NodeScorer within 1e-4 of max |JAX|,
its weights and PSPNetUOAIS's round-tripping through state_dict_to_jax
unchanged (PSPNetUOAIS's forward is held by tests/test_torch_zoo_pretrained.py
through the importers); the losses
rtol 1e-4; the scorer's crops within 1e-6; the 2-means split at 480x640 >=
99.9% of the pixels on either side; the adjacency equal; the CascadePSP
wrapper (its global size 64, 4 slots) on a written frame >= 99.5% of each
mask's pixels; the greedy and the CEM searches (CEM given the Gumbel noise the
JAX package's key draws) the same masks and slots; `rice` through
build_refiner_model on a written frame the same masks as the JAX wrapper
(6 slots and 32x32 crops in both for the searches).
The scorer's last layer is scaled by 20 so that operations pass the
search's margin at a random init.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quber_tpu.models import cascadepsp as JC
from quber_tpu.models import rice as JR
from quber_tpu_torch.models import cascadepsp as TC
from quber_tpu_torch.models import rice as TR
from quber_tpu_torch.models.from_jax import state_dict_from_jax, state_dict_to_jax
from quber_tpu_torch.models.layers import resize_bilinear

RTOL = 1e-4
LOSS_RTOL = 1e-4
RESIZE_ATOL = 1e-6
SPLIT_AGREEMENT = 0.999
AGREEMENT = 0.995
SCORE_SCALE = 20.0


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("src,dst", [((480, 640), (224, 224)), ((224, 224), (480, 640))])
def test_resize_matches_jax_image_resize(src, dst):
    rng = np.random.RandomState(0)
    img = rng.rand(*src, 3).astype(np.float32)
    masks = (rng.rand(3, *src) > 0.5).astype(np.float32)
    want = np.asarray(jax.jit(lambda x: jax.image.resize(x, (*dst, 3), "bilinear"))(img))
    got = resize_bilinear(torch.from_numpy(img).permute(2, 0, 1), dst).permute(1, 2, 0).numpy()
    assert np.abs(got - want).max() <= RESIZE_ATOL
    want = np.asarray(jax.jit(jax.vmap(lambda m: jax.image.resize(m, dst, "bilinear")))(masks))
    assert np.abs(resize_bilinear(torch.from_numpy(masks), dst).numpy() - want).max() <= RESIZE_ATOL


def psp_variables(seed=0):
    """PSPNetUOAIS's variables in the flax layout from the port's seeded init
    (a flax init compiles for ~15 s), the BatchNorm statistics seeded (means
    N(0, 0.1^2), variances in [0.5, 1.5))."""
    model = TC.PSPNetUOAIS()
    model.reset_parameters(torch.Generator().manual_seed(seed))
    variables = state_dict_to_jax(model)
    rng = np.random.RandomState(seed)
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.randn(*a.shape) * 0.1 if path[-1].key == "mean"
                         else 0.5 + rng.rand(*a.shape)).astype(np.float32),
        variables["batch_stats"])
    return variables


def test_pspnet_weights_round_trip():
    """The flax tree onto the module and back unchanged (the forward against
    the JAX package's: tests/test_torch_zoo_pretrained.py, through the
    importers)."""
    variables = psp_variables()
    model = TC.PSPNetUOAIS().eval()
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    back = state_dict_to_jax(model)
    assert jax.tree.structure(back) == jax.tree.structure(variables)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(a, b)


def test_cascadepsp_refine_loss_matches_jax():
    rng = np.random.RandomState(2)
    images = {k: rng.randn(2, 32, 40, 1).astype(np.float32) * 3
              for k in ("out_28", "out_28_2", "out_28_3", "out_56", "out_56_2", "out_224")}
    images["pred_224"] = 1 / (1 + np.exp(-images["out_224"]))
    target = (rng.rand(2, 32, 40) > 0.5).astype(np.float32)
    want = JC.cascadepsp_refine_loss(images, target)
    got = TC.cascadepsp_refine_loss(
        {k: torch.from_numpy(v).permute(0, 3, 1, 2) for k, v in images.items()},
        torch.from_numpy(target))
    assert set(got) == set(want)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=LOSS_RTOL), k


def _scene(h=96, w=128, seed=3):
    """A rendered scene: (image [H, W, 6] float32 0-255 BGR + depth x3,
    instance masks [N, H, W] bool)."""
    from quber_tpu_torch.data.synthetic import render_scene
    from quber_tpu_torch.ops.preprocess import normalize_depth

    rgb, depth_mm, vis = render_scene(np.random.RandomState(seed), h, w, depth_range=(250, 1500))
    image = np.concatenate([rgb[..., ::-1], normalize_depth(depth_mm)], -1).astype(np.float32)
    return image, np.asarray([m > 0 for m in vis if m.any()])


class _SmallCascade(JC.CascadePSPRefiner):
    GLOBAL = 64
    MAX_INSTANCES = 4


@pytest.fixture(scope="module")
def frame(tmp_path_factory):
    from quber_tpu_torch.data.make_synthetic_dataset import main as make_dataset
    from quber_tpu.evaluation import datasets as jdata

    root = str(tmp_path_factory.mktemp("osd"))
    make_dataset(["--out", root, "--n", "1", "--seed", "1001", "--depth-range", "250", "1500"])
    rgb, depth, anno = jdata.build_file_lists("OSD", root)
    from quber_tpu_torch.evaluation.base_models import GT

    return rgb[0], depth[0], GT().predict(rgb[0], depth[0])[0]


def test_cascadepsp_through_build_refiner_model(frame, tmp_path, monkeypatch):
    """The wrapper at global size 64 with 4 slots (3 masks and an empty
    one), the final bias moved by the median logit of the first mask's
    global pass so that the masks hold pixels."""
    from quber_tpu_torch.evaluation.refiner_models import build_refiner_model
    from quber_tpu_torch.ops.preprocess import load_rgbd
    from quber_tpu_torch.train.checkpoint import save_params

    rgb_path, depth_path, initial = frame
    initial = initial[:3]
    variables = psp_variables(seed=2)
    rgb, depth, _ = load_rgbd(rgb_path, depth_path, (480, 640))
    probe = TC.CascadePSPRefiner(params=variables, device="cpu")
    g = _SmallCascade.GLOBAL
    image = torch.from_numpy(np.concatenate([rgb, depth], -1).astype(np.float32)).permute(2, 0, 1)
    mean = torch.from_numpy(TC.IMAGENET_MEAN)[:, None, None]
    std = torch.from_numpy(TC.IMAGENET_STD)[:, None, None]
    seg = resize_bilinear(torch.from_numpy(initial[:1].astype(np.float32)), (g, g))
    with torch.no_grad():
        out = probe.model(resize_bilinear((image[:3] / 255 - mean) / std, (g, g))[None],
                          resize_bilinear(image[3:4] / 255, (g, g))[None], (seg[None] - 0.5) / 0.5)
    variables["params"]["final_21"]["bias"] = \
        variables["params"]["final_21"]["bias"] - float(out["out_224"].median())
    save_params(str(tmp_path / "ckpt"), variables, step=1)
    monkeypatch.setenv("QUBER_CASCADEPSP_CKPT", str(tmp_path / "ckpt"))
    port = build_refiner_model("cascadepsp-rgbd", "OSD", device="cpu")
    assert isinstance(port, TC.CascadePSPRefiner)
    port.GLOBAL, port.MAX_INSTANCES = g, _SmallCascade.MAX_INSTANCES
    got, _, seconds, _ = port.predict(rgb_path, depth_path, initial, None)
    want = _SmallCascade(params=variables).predict(rgb_path, depth_path, initial, None)[0]
    assert got.shape == want.shape == (3, 480, 640) and seconds > 0
    for g_mask, w_mask in zip(got, want):
        assert w_mask.any() and (g_mask == w_mask).mean() >= AGREEMENT


def scorer_variables(seed=0):
    """NodeScorer's variables in the flax layout from the port's seeded
    init, the last layer scaled by SCORE_SCALE."""
    model = TR.NodeScorer()
    model.reset_parameters(torch.Generator().manual_seed(seed))
    variables = state_dict_to_jax(model)
    fc2 = variables["params"]["fc2"]
    fc2["kernel"] = fc2["kernel"] * SCORE_SCALE
    return variables


def test_node_scorer_matches_jax():
    variables = scorer_variables()
    x = np.random.RandomState(4).rand(5, 64, 64, 6).astype(np.float32)
    want = np.asarray(jax.jit(JR.NodeScorer().apply)(variables, x))
    model = TR.NodeScorer().eval()
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()
    back = state_dict_to_jax(model)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(a, b)


def test_node_scorer_loss_matches_jax():
    rng = np.random.RandomState(5)
    args = (rng.randn(7).astype(np.float32), rng.rand(7) > 0.3,
            rng.randn(7).astype(np.float32), rng.rand(7) > 0.5)
    want = JR.node_scorer_loss(*args)
    got = TR.node_scorer_loss(*(torch.from_numpy(a) for a in args))
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=LOSS_RTOL), k


def _rice_inputs(h=96, w=128, n=6, seed=3):
    """image6 [H, W, 6] in [0, 1] and a mask stack [n, H, W] float32 of the
    scene's objects, one of them split in two and two merged, n - 1 valid."""
    image, gt = _scene(h, w, seed)
    masks = np.zeros((n, h, w), np.float32)
    k = min(len(gt), n - 2)
    masks[:k] = gt[:k]
    masks[0] = np.maximum(masks[0], masks[1])
    masks[1] = 0
    ys, xs = np.nonzero(masks[2])
    cut = masks[2] * (np.arange(w)[None, :] < xs.mean())
    masks[k], masks[2] = masks[2] - cut, cut
    valid = masks.reshape(n, -1).any(1)
    return image / 255.0, masks, valid


def test_hypothesis_node_crops_and_adjacency_match_jax():
    image6, masks, valid = _rice_inputs()
    crops, ok = JR.hypothesis_node_crops(image6, masks, valid, crop=32)
    got, got_ok = TR.hypothesis_node_crops(torch.from_numpy(image6).permute(2, 0, 1),
                                           torch.from_numpy(masks > 0), torch.from_numpy(valid),
                                           crop=32)
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(ok))
    assert np.abs(got.permute(0, 2, 3, 1).numpy() - np.asarray(crops)).max() <= RESIZE_ATOL
    np.testing.assert_array_equal(TR.masks_adjacent(torch.from_numpy(masks > 0)).numpy(),
                                  np.asarray(JR.masks_adjacent(masks)))


def _ellipses(h, w, seed, n=4):
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[:h, :w]
    out = []
    for _ in range(n):
        cy, cx = rng.uniform(0.2, 0.8) * h, rng.uniform(0.2, 0.8) * w
        a, b = rng.uniform(20, 120), rng.uniform(20, 120)
        out.append((((ys - cy) / a) ** 2 + ((xs - cx) / b) ** 2) <= 1)
    return np.asarray(out)


def test_split_mask_2means_matches_jax():
    masks = _ellipses(480, 640, 6)
    split = jax.jit(jax.vmap(JR.split_mask_2means))
    want = [np.asarray(a) for a in split(masks.astype(np.float32))]
    got = [a.numpy() for a in TR.split_mask_2means(torch.from_numpy(masks))]
    for g, w in zip(got, want):
        for i in range(len(masks)):
            assert w[i].any() and g[i].any()
            on = masks[i]
            assert (g[i][on] == w[i][on]).mean() >= SPLIT_AGREEMENT, i
    np.testing.assert_array_equal(got[0] + got[1], masks.astype(np.float32))


class _SmallRICE(JR.RICERefiner):
    MAX_INST = 6
    CROP = 32


def _port_rice(variables, search):
    port = TR.RICERefiner(params=variables, search=search, device="cpu")
    port.MAX_INST, port.CROP = _SmallRICE.MAX_INST, _SmallRICE.CROP
    return port


def jax_cem_noise(key, n, rounds, samples, depth):
    """The Gumbel noise behind each jax.random.categorical of the JAX
    package's CEM search under `key`, laid out as draw_cem_noise's."""
    out = {"op": np.zeros((rounds, samples, depth, 4), np.float32),
           "i": np.zeros((rounds, samples, depth, n), np.float32),
           "j": np.zeros((rounds, samples, depth, n), np.float32)}
    for r, kr in enumerate(jax.random.split(key, rounds)):
        for s, ks in enumerate(jax.random.split(kr, samples)):
            for t, kt in enumerate(jax.random.split(ks, depth)):
                k_op, k_i, k_j = jax.random.split(kt, 3)
                out["op"][r, s, t] = jax.random.gumbel(k_op, (4,), jnp.float32)
                out["i"][r, s, t] = jax.random.gumbel(k_i, (n,), jnp.float32)
                out["j"][r, s, t] = jax.random.gumbel(k_j, (n,), jnp.float32)
    return {k: torch.from_numpy(v) for k, v in out.items()}


@pytest.mark.parametrize("search", ["greedy", "cem"])
def test_searches_match_jax(search):
    image6, masks, valid = _rice_inputs()
    variables = scorer_variables()
    ref = _SmallRICE(params=variables, search=search)
    key = jax.random.PRNGKey(3)
    want_m, want_v = (np.asarray(a) for a in ref._search(variables, image6, masks, valid, key))
    port = _port_rice(variables, search)
    noise = jax_cem_noise(key, port.MAX_INST, port.CEM_ROUNDS, port.SAMPLES, port.DEPTH) \
        if search == "cem" else None
    got_m, got_v = port.search(torch.from_numpy(image6).permute(2, 0, 1),
                               torch.from_numpy(masks > 0), torch.from_numpy(valid), noise)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(got_m.numpy(), want_m > 0.5)
    # the search changed the hypothesis
    assert not (np.array_equal(want_v, valid) and np.array_equal(want_m, masks))


def test_draw_cem_noise_is_gumbel():
    noise = TR.draw_cem_noise(torch.Generator().manual_seed(0), 16, 2, 8, 3)
    assert noise["op"].shape == (2, 8, 3, 4) and noise["i"].shape == noise["j"].shape == (2, 8, 3, 16)
    x = torch.cat([v.flatten() for v in noise.values()])
    assert bool(torch.isfinite(x).all()) and abs(float(x.mean()) - 0.5772) < 0.1


def test_rice_through_build_refiner_model(frame, tmp_path, monkeypatch):
    from quber_tpu_torch.evaluation.refiner_models import build_refiner_model
    from quber_tpu_torch.train.checkpoint import save_params

    variables = scorer_variables(seed=1)
    save_params(str(tmp_path / "ckpt"), variables, step=1)
    monkeypatch.setenv("QUBER_RICE_CKPT", str(tmp_path / "ckpt"))
    monkeypatch.delenv("QUBER_RICE_SEARCH", raising=False)
    port = build_refiner_model("rice", "OSD", device="cpu")
    assert isinstance(port, TR.RICERefiner) and port.search_mode == "greedy"
    port.MAX_INST, port.CROP = _SmallRICE.MAX_INST, _SmallRICE.CROP
    rgb_path, depth_path, initial = frame
    got, _, seconds, _ = port.predict(rgb_path, depth_path, initial, None)
    want = _SmallRICE(params=variables, search="greedy").predict(
        rgb_path, depth_path, initial, None)[0]
    assert got.shape == want.shape and seconds > 0
    np.testing.assert_array_equal(got, want)
    monkeypatch.setenv("QUBER_RICE_SEARCH", "cem")
    monkeypatch.setenv("QUBER_RICE_CKPT", str(tmp_path / "missing"))
    cem = build_refiner_model("rice", "OSD", device="cpu")
    assert cem.search_mode == "cem"
    want = TR.RICERefiner(device="cpu").scorer.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in cem.scorer.state_dict().items())

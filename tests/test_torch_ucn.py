"""The UCN base segmenter of the port against the JAX package: the point
cloud, mean-shift, the embedding net, its metric loss and training recipe,
ROI-align and the zoom-in stage, and the evaluation wrapper.

Inputs come from numpy seeds; network parameters are the JAX package's
(randomised or its own init) carried across with from_jax. Tolerances:
compute_xyz, the scenes of the training pool, the boxes and every label map
exact; ROI-align within 1e-5 on features of unit scale (XLA's fused
arithmetic rounds the sample positions in their last bits differently, and a
position moves a sample by its neighbours' difference times that); mean-shift seeds within 1e-5 (float32
products in another order; the clusters are separated by wide margins, so
no threshold is near a decision); the net's embeddings within 1e-5 at 64x96;
the loss rtol 1e-5; one training step as tests/test_torch_train.py holds it:
the loss rtol 1e-4, each gradient within 15% of its norm, the updated
parameters and BatchNorm statistics within 2.1 learning rates (Adam's first
update is lr * sign(g) where g is ~0) and within 2% of one on 99% of the
elements whose gradient is sure.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from quber_tpu.evaluation import datasets as jdata
from quber_tpu.models import ucn as JU
from quber_tpu.ops import boxes as JB
from quber_tpu.ops import meanshift as JMS
from quber_tpu.ops import preprocess as JPre
from quber_tpu.ops import zoom as JZ
from quber_tpu.train.checkpoint import load_quantized_params as jax_load_quantized
from quber_tpu_torch.data.make_synthetic_dataset import main as make_dataset
from quber_tpu_torch.evaluation import base_models as tbase
from quber_tpu_torch.models import ucn as TU
from quber_tpu_torch.models.from_jax import state_dict_from_jax, state_dict_to_jax
from quber_tpu_torch.ops import boxes as TB
from quber_tpu_torch.ops import meanshift as TMS
from quber_tpu_torch.ops import preprocess as TPre
from quber_tpu_torch.ops import zoom as TZ
from quber_tpu_torch.train.checkpoint import load_eval_params, save_quantized_params

_TOOL = os.path.join(os.path.dirname(__file__), "..", "tools", "train_zoo.py")
_spec = importlib.util.spec_from_file_location("jax_train_zoo", _TOOL)
jzoo = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jzoo)

H, W = 64, 96
LR = 1e-4


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


def _randomize(tree, rng):
    """Seeded random leaves of a UCN variable tree, scaled so that activations
    stay O(1) through 36 BatchNorm layers."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng)
            continue
        shape = np.shape(v)
        if k == "kernel":
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif k == "scale":
            a = 1.0 + 0.1 * rng.randn(*shape)
        elif k == "var":
            a = rng.uniform(0.5, 1.5, shape)
        else:
            a = 0.1 * rng.randn(*shape)
        out[k] = a.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def jax_init():
    """The JAX package's own init of its UCN net (PRNGKey(0)), as numpy."""
    x = jnp.zeros((1, H, W, 3))
    return jax.tree.map(np.asarray, dict(jax.jit(JU.UCNEmbeddingNet().init)(
        jax.random.PRNGKey(0), x, x)))


@pytest.fixture(scope="module")
def net(jax_init):
    """(flax module, randomised variables, the port's net holding them)."""
    jn = JU.UCNEmbeddingNet()
    variables = _randomize(jax_init, np.random.RandomState(0))
    tn = TU.UCNEmbeddingNet()
    tn.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jn, variables, tn.eval()


# --- the point cloud -----------------------------------------------------------

@pytest.mark.parametrize("camera", [
    {"fx": 550.0, "fy": 550.0, "x_offset": 320.0, "y_offset": 240.0,
     "img_width": 640, "img_height": 480},
    {"fov": 45.0, "near": 0.01, "img_width": 96, "img_height": 64},
])
def test_compute_xyz_matches_jax(camera):
    depth = np.random.RandomState(1).uniform(0.25, 1.5, (64, 96)).astype(np.float32)
    got = TPre.compute_xyz(depth, camera)
    want = JPre.compute_xyz(depth, camera)
    # float32 with given focal lengths, float64 where numpy computes them
    assert got.dtype == want.dtype and got.shape == (64, 96, 3)
    np.testing.assert_array_equal(got, want)


# --- mean-shift ----------------------------------------------------------------

def _clusters(rng, n_clusters=4, per=300, d=8, noise=0.05):
    """Unit embeddings in `n_clusters` tight groups around orthogonal
    directions (similarity ~1 within a group, ~0 across)."""
    centres = np.eye(d, dtype=np.float32)[:n_clusters]
    x = np.repeat(centres, per, axis=0) + noise * rng.randn(n_clusters * per, d)
    x = x[rng.permutation(len(x))].astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_farthest_point_seeds_and_mean_shift_match_jax():
    x = _clusters(np.random.RandomState(2))
    for first in (0, 17):
        want = np.asarray(JMS.farthest_point_seeds(jnp.asarray(x), 8, first=first))
        got = TMS.farthest_point_seeds(t(x), 8, first=first).numpy()
        np.testing.assert_array_equal(got, want)
    seeds = x[want]
    want = np.asarray(JMS.mean_shift(jnp.asarray(x), jnp.asarray(seeds), 10, 0.5))
    got = TMS.mean_shift(t(x), t(seeds), 10, 0.5).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(TMS.l2_normalize(t(x * 3)).numpy(),
                               np.asarray(JMS.l2_normalize(jnp.asarray(x * 3))), atol=1e-6)


def test_merge_seeds_matches_jax():
    rng = np.random.RandomState(3)
    base = _clusters(rng, n_clusters=3, per=1, noise=0.0)
    # 10 seeds: chains of near copies of three directions
    seeds = base[[0, 1, 0, 2, 1, 2, 0, 1, 2, 0]] + 0.02 * rng.randn(10, 8)
    seeds = (seeds / np.linalg.norm(seeds, axis=1, keepdims=True)).astype(np.float32)
    want_l, want_r = JMS.merge_seeds(jnp.asarray(seeds), 0.9)
    got_l, got_r = TMS.merge_seeds(t(seeds), 0.9)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    assert int(got_r.sum()) == 3


def test_euclidean_twins_match_jax():
    rng = np.random.RandomState(4)
    centres = np.array([[0, 0, 1], [0.3, 0, 1], [0, 0.3, 1.2]], np.float32)
    x = (np.repeat(centres, 200, axis=0) + 0.005 * rng.randn(600, 3)).astype(np.float32)
    x = x[rng.permutation(600)]
    want = np.asarray(JMS.farthest_point_seeds_euclidean(jnp.asarray(x), 6, first=5))
    got = TMS.farthest_point_seeds_euclidean(t(x), 6, first=5).numpy()
    np.testing.assert_array_equal(got, want)
    want_s = JMS.mean_shift_euclidean(jnp.asarray(x), jnp.asarray(x[want]), 10, 0.05)
    got_s = TMS.mean_shift_euclidean(t(x), t(x[want]), 10, 0.05)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-5)

    points = x.reshape(20, 30, 3)
    fg = np.ones((20, 30), np.float32)
    fg[:2] = 0
    want = JMS.cluster_points_euclidean(jnp.asarray(points), jnp.asarray(fg), num_seeds=8,
                                        min_pixels=50)
    got = TMS.cluster_points_euclidean(t(points), t(fg), num_seeds=8, min_pixels=50)
    np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]))
    assert int(got["num_instances"]) == int(want["num_instances"]) == 3


@pytest.mark.parametrize("with_fg", [False, True])
def test_cluster_embeddings_matches_jax(with_fg):
    rng = np.random.RandomState(5)
    emb = _clusters(rng, n_clusters=5, per=240, d=16).reshape(30, 40, 16)
    fg = None
    if with_fg:
        fg = np.ones((30, 40), np.float32)
        fg[:, :6] = 0  # background columns
    want = JMS.cluster_embeddings(jnp.asarray(emb), None if fg is None else jnp.asarray(fg),
                                  num_seeds=12, min_pixels=100)
    got = TMS.cluster_embeddings(t(emb), None if fg is None else t(fg), num_seeds=12,
                                 min_pixels=100)
    np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]))
    assert got["labels"].dtype == torch.int32
    assert int(got["num_instances"]) == int(want["num_instances"]) == 5
    np.testing.assert_allclose(got["seeds"].numpy(), np.asarray(want["seeds"]), atol=1e-5)
    if with_fg:
        assert not got["labels"][:, :6].any()


# --- the embedding net and its loss ------------------------------------------

def test_embedding_net_matches_jax(net):
    jn, variables, tn = net
    rng = np.random.RandomState(6)
    rgb, xyz = rng.randn(2, H, W, 3).astype(np.float32), rng.randn(2, H, W, 3).astype(np.float32)
    want = np.asarray(jn.apply(variables, jnp.asarray(rgb), jnp.asarray(xyz)))
    with torch.no_grad():
        got = tn(nchw(rgb), nchw(xyz)).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_from_jax_round_trip(net):
    """JAX -> port -> JAX gives the UCN tree back, leaf for leaf, the
    BatchNorm statistics in `batch_stats`."""
    _, variables, tn = net
    back = state_dict_to_jax(tn)
    assert jax.tree.structure(back) == jax.tree.structure(variables)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(a, b)
    bn = back["batch_stats"]["rgb_branch"]["trunk"]["layer4_0"]["downsample_bn"]
    assert set(bn) == {"mean", "var"}


def test_dilated_trunk_layout():
    """layer3 / layer4 at stride 1: the first block takes the previous
    dilation, the 1x1 projections none."""
    trunk = TU.ResNet34Trunk8s()
    assert trunk.layer3_0.conv1.dilation == (1, 1) and trunk.layer3_1.conv1.dilation == (2, 2)
    assert trunk.layer4_0.conv1.dilation == (2, 2) and trunk.layer4_2.conv2.dilation == (4, 4)
    assert trunk.layer4_0.downsample_conv.dilation == (1, 1)
    assert trunk.layer2_0.conv1.stride == (2, 2) and trunk.layer3_0.conv1.stride == (1, 1)
    assert trunk(torch.zeros(1, 3, H, W)).shape == (1, 512, H // 8, W // 8)


def test_prototype_metric_loss_matches_jax():
    rng = np.random.RandomState(7)
    emb = rng.randn(2, 24, 32, 8).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    labels = rng.randint(0, 6, (2, 24, 32)).astype(np.int32)
    labels[1] = np.where(labels[1] == 4, 0, labels[1])  # an absent cluster
    want, wparts = JU.prototype_metric_loss(jnp.asarray(emb), jnp.asarray(labels), 13)
    e = nchw(emb).requires_grad_()
    got, parts = TU.prototype_metric_loss(e, t(labels), 13)
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    for k in ("loss_intra", "loss_inter"):
        assert float(parts[k].detach()) == pytest.approx(float(wparts[k]), rel=1e-5)
    got.backward()
    g = jax.grad(lambda x: JU.prototype_metric_loss(x, jnp.asarray(labels), 13)[0])(
        jnp.asarray(emb))
    np.testing.assert_allclose(e.grad.numpy().transpose(0, 2, 3, 1), np.asarray(g),
                               rtol=1e-4, atol=1e-7)


# --- the training recipe -----------------------------------------------------

def test_labeled_scenes_and_order_match_jax():
    want = jzoo.make_labeled_scenes(2, H, W, 3, (250, 1500))
    import train_zoo_torch

    got = train_zoo_torch.make_labeled_scenes(2, H, W, 3, (250, 1500))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    class Args:
        seed, max_iter, log_period, checkpoint_period = 7, 11, 100, 100

    orders = []
    for fit in (jzoo._fit_loop, train_zoo_torch.fit_loop):
        seen = []
        fit(lambda it, i, seen=seen: (seen.append(i), (0.0, {}))[1], 4, Args, lambda it: None)
        orders.append(seen)
    assert orders[0] == orders[1] and sorted(orders[1][:4]) == [0, 1, 2, 3]


def _rel_l2(got, want):
    return float((got.double() - want.double()).norm() / want.double().norm())


def test_train_step_matches_jax_train_ucn(jax_init):
    """One step of train_zoo_torch's recipe from the JAX package's init
    against the step of tools/train_zoo.train_ucn (value_and_grad over the
    whole variable tree, optax.adam), the Adam-updated BatchNorm statistics
    included."""
    import train_zoo_torch

    seed = 7
    pool = jzoo.make_labeled_scenes(2, H, W, seed, (250, 1500))
    jn = JU.UCNEmbeddingNet()
    variables = jax_init
    tx = optax.adam(LR)

    @jax.jit
    def jstep(v, opt_state, rgb, xyz, labels):
        def loss_fn(v):
            emb = jn.apply(v, rgb[None], xyz[None])
            return JU.prototype_metric_loss(emb, labels[None], max_instances=jzoo.SLOTS + 1)

        (loss, parts), grads = jax.value_and_grad(loss_fn, has_aux=True)(v)
        updates, opt_state = tx.update(grads, opt_state, v)
        return optax.apply_updates(v, updates), loss, parts, grads

    idx = 1
    new, loss, parts, grads = jstep(variables, tx.init(variables), pool["rgb"][idx],
                                    pool["xyz"][idx], pool["labels"][idx])

    model, optimizer = train_zoo_torch.make_ucn(seed, LR, "cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    step = train_zoo_torch.make_ucn_step(model, optimizer)
    got_loss, got_parts = step(train_zoo_torch.stage(pool, "cpu"), idx)
    assert float(got_loss) == pytest.approx(float(loss), rel=1e-4)
    for k in parts:
        assert float(got_parts[k]) == pytest.approx(float(parts[k]), rel=1e-4), k

    want_grad = state_dict_from_jax(jax.tree.map(np.asarray, dict(grads)))
    want_new = state_dict_from_jax(jax.tree.map(np.asarray, dict(new)))
    old = state_dict_from_jax(variables)
    got = dict(model.named_parameters())
    assert set(got) == set(want_new)
    n_stats = 0
    for name, p in got.items():
        g = want_grad[name]
        assert _rel_l2(p.grad, g) <= 0.15, name
        np.testing.assert_allclose(p.detach().numpy(), want_new[name].numpy(), rtol=0,
                                   atol=2.1 * LR, err_msg=name)
        sure = g.abs() > 0.25 * g.square().mean().sqrt()
        assert bool(sure.any()), name
        close = (p.detach()[sure] - want_new[name][sure]).abs() <= 0.02 * LR
        assert float(close.float().mean()) >= 0.99, name
        assert bool(((want_new[name] - old[name])[sure].abs() > 0.9 * LR).all()), name
        n_stats += name.endswith(("running_mean", "running_var"))
    assert n_stats == 2 * 2 * 36  # two trunks, 36 BatchNorms each, mean and var


def test_train_zoo_torch_cli(tmp_path, capsys, monkeypatch):
    """Two CPU steps write a checkpoint directory, which build_base_model
    reads through $QUBER_UCN_CKPT, and an int8 archive, which the JAX
    package reads; the other models name their item."""
    import train_zoo_torch

    out = tmp_path / "ucn"
    argv = ["--model", "ucn", "--size", "2", "--height", str(H), "--width", str(W),
            "--max-iter", "2", "--log-period", "1", "--checkpoint-period", "1",
            "--output-dir", str(out)]
    if not torch.cuda.is_available():
        assert train_zoo_torch.main(argv) == 2
    assert train_zoo_torch.main(argv + ["--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "iter 2/2 total=" in text and "checkpoint saved at 2" in text
    assert sorted(os.listdir(out / "ckpt")) == ["1", "2"]
    monkeypatch.setenv("QUBER_UCN_CKPT", str(out / "ckpt"))
    base = tbase.build_base_model("ucn", "OSD", device="cpu")
    want = state_dict_from_jax(load_eval_params(str(out / "ckpt")))
    assert all(torch.equal(v, want[k]) for k, v in base.model.state_dict().items())
    tree = jax_load_quantized(str(out / "ucn_int8.npz"))
    assert set(tree) == {"params", "batch_stats"}
    x = jnp.zeros((1, H, W, 3))
    emb = JU.UCNEmbeddingNet().apply(tree, x, x)
    assert emb.shape == (1, H, W, 64) and bool(jnp.isfinite(emb).all())


# --- ROI-align and the zoom-in stage ------------------------------------------

def test_roi_align_matches_jax():
    rng = np.random.RandomState(8)
    feats = rng.randn(40, 50, 5).astype(np.float32)
    boxes = np.array([[3.2, 4.7, 20.1, 31.0], [-5.0, -3.0, 12.0, 9.0],
                      [40.0, 30.0, 60.0, 45.0], [0, 0, 0, 0]], np.float32)
    want = np.asarray(JB.roi_align(jnp.asarray(feats), jnp.asarray(boxes), out_size=7))
    got = TB.roi_align(t(feats.transpose(2, 0, 1)), t(boxes), out_size=7)
    assert got.shape == (4, 5, 7, 7)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, rtol=0, atol=1e-5)


def _label_map(rng, h=60, w=80):
    labels = np.zeros((h, w), np.int32)
    labels[5:20, 10:30] = 1
    labels[25:50, 5:25] = 3
    labels[30:58, 40:75] = 2
    labels[35:45, 50:60] = 5  # inside 2
    return labels


def test_instance_boxes_from_labels_matches_jax():
    labels = _label_map(np.random.RandomState(9))
    want_b, want_v = JZ.instance_boxes_from_labels(jnp.asarray(labels), 6)
    got_b, got_v = TZ.instance_boxes_from_labels(t(labels), 6)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert got_v.tolist() == [True, True, True, False, True, False]


def test_zoom_refine_labels_matches_jax():
    """Seeded random crops pasted in slot order (later slots overwrite)."""
    labels = _label_map(np.random.RandomState(10))
    z, m = 16, 6
    crops = (np.random.RandomState(11).rand(m, z, z) > 0.4).astype(np.float32)
    want = JZ.zoom_refine_labels(jnp.asarray(labels), lambda box, ok, i: jnp.asarray(crops)[i - 1],
                                 m, z)
    got = TZ.zoom_refine_labels(t(labels), lambda boxes, valid, ids: t(crops)[ids - 1], m, z)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), labels)


# --- the evaluation wrapper ---------------------------------------------------

@pytest.fixture(scope="module")
def osd2(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("osd2") / "osd")
    make_dataset(["--out", root, "--n", "2", "--seed", "1000", "--depth-range", "250", "1500",
                  "--dropout-frac", "0.0005"])
    return root


@pytest.fixture(scope="module")
def ucn_npz(tmp_path_factory, jax_init):
    """The JAX wrapper's own init (seed 0), as an int8 archive."""
    path = str(tmp_path_factory.mktemp("ucn") / "ucn_int8.npz")
    save_quantized_params(path, jax_init)
    return path


@pytest.mark.parametrize("name", ["ucn", "ucn-zoomin"])
def test_build_base_model_ucn_matches_jax_wrapper(name, osd2, ucn_npz, monkeypatch):
    """$QUBER_UCN_CKPT as an int8 archive in the JAX layout; two frames of the
    synthetic-OSD protocol: the same masks as the JAX package's UCNBaseModel
    on the same (dequantised) weights."""
    monkeypatch.setenv("QUBER_UCN_CKPT", ucn_npz)
    port = tbase.build_base_model(name, "OSD", device="cpu")
    assert isinstance(port, TU.UCNBaseModel) and port.zoom_in == name.endswith("zoomin")
    ref = JU.UCNBaseModel(params=jax_load_quantized(ucn_npz), zoom_in=port.zoom_in)
    rgb, depth, _ = jdata.build_file_lists("OSD", osd2)
    for r, d in zip(rgb, depth):
        got, fg, seconds = port.predict(r, d)
        want = ref.predict(r, d)[0]
        assert fg is None and seconds > 0
        assert got.shape == want.shape and got.shape[1:] == (480, 640)
        np.testing.assert_array_equal(got, want)


def test_ucn_without_a_checkpoint_initialises_from_seed_0(monkeypatch, tmp_path):
    monkeypatch.setenv("QUBER_UCN_CKPT", str(tmp_path / "missing"))
    a = tbase.build_base_model("ucn", "OSD", device="cpu")
    monkeypatch.delenv("QUBER_UCN_CKPT")
    b = tbase.build_base_model("ucn", "OSD", device="cpu")
    assert all(torch.equal(v, b.model.state_dict()[k]) for k, v in a.model.state_dict().items())
    with pytest.raises(NotImplementedError) as err:
        tbase.build_base_model("no-such-base", "OSD", device="cpu")
    assert "ucn, ucn-zoomin," in str(err.value)  # both listed as available
    assert set(state_dict_to_jax(a.model)) == {"params", "batch_stats"}

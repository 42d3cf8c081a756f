"""The foreground nets (CGNet, LMFFNet) and their predictors: the port
against the JAX package, from the same JAX-initialised variables.

Tolerances: logits within 1e-4 of their largest magnitude (float32
summation order); predictor masks equal on >= 99.9% of the pixels (the
port's bilinear resize of the colour image may differ from OpenCV's by one
grey level, which can flip a pixel whose classes are nearly tied).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quber_tpu.models.cgnet import CGNet as JCGNet
from quber_tpu.models.fg_predictor import CGNetPredictor as JCGNetPredictor
from quber_tpu.models.fg_predictor import LMFFNetPredictor as JLMFFNetPredictor
from quber_tpu.models.lmffnet import LMFFNet as JLMFFNet
from quber_tpu_torch.data.make_synthetic_dataset import main as make_dataset
from quber_tpu_torch.evaluation.datasets import build_file_lists
from quber_tpu_torch.models.cgnet import CGNet
from quber_tpu_torch.models.fg_predictor import CGNetPredictor, LMFFNetPredictor
from quber_tpu_torch.models.from_jax import state_dict_from_jax, state_dict_to_jax
from quber_tpu_torch.models.lmffnet import LMFFNet

torch.set_num_threads(2)


def _init(model, shape, seed=0):
    """JAX-initialised variables with non-trivial BatchNorm statistics and
    PReLU slopes, as numpy arrays."""
    variables = jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(seed),
                                                             jnp.zeros(shape)))
    rng = np.random.RandomState(seed)

    def jitter(path, a):
        name = jax.tree_util.keystr(path)
        if "var" in name:
            return (0.5 + rng.rand(*a.shape)).astype(np.float32)
        if a.ndim == 1:
            return (a + 0.1 * rng.randn(*a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(jitter, variables)


NETS = {
    "cgnet": (lambda: JCGNet(classes=2, in_channels=4), lambda: CGNet(2, 4), (1, 40, 56, 4)),
    "lmffnet": (lambda: JLMFFNet(classes=3), lambda: LMFFNet(3), (1, 64, 96, 6)),
}


@pytest.mark.parametrize("name", sorted(NETS))
def test_logits_match_jax(name):
    jmodel, tmodel, shape = NETS[name]
    jnet = jmodel()
    variables = _init(jnet, shape)
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    want = np.asarray(jax.jit(jnet.apply)(variables, x))
    net = tmodel()
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("name", sorted(NETS))
def test_strict_load_of_converted_tree(name):
    jmodel, tmodel, shape = NETS[name]
    variables = _init(jmodel(), shape)
    sd = state_dict_from_jax(variables)
    net = tmodel()
    assert set(sd) == set(net.state_dict())
    net.load_state_dict(sd, strict=True)
    sd.pop(next(iter(sd)))
    with pytest.raises(RuntimeError):
        net.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("name", sorted(NETS))
def test_converted_tree_round_trips(name):
    """state_dict_to_jax gives back the flax tree (PReLU slopes as `alpha`,
    BatchNorm statistics under batch_stats)."""
    jmodel, tmodel, shape = NETS[name]
    variables = _init(jmodel(), shape)
    net = tmodel()
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    got = dict(jax.tree_util.tree_leaves_with_path(state_dict_to_jax(net)))
    want = dict(jax.tree_util.tree_leaves_with_path(variables))
    assert set(got) == set(want)
    for key, value in want.items():
        assert np.array_equal(got[key], value), jax.tree_util.keystr(key)


def test_random_init_is_seeded():
    a, b = CGNet(2, 4, m=2, n=2), CGNet(2, 4, m=2, n=2)
    a.reset_parameters(torch.Generator().manual_seed(3))
    b.reset_parameters(torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                b.state_dict().values()))


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fg") / "osd")
    make_dataset(["--out", root, "--n", "2", "--height", "120", "--width", "160"])
    rgb, depth, _ = build_file_lists("OSD", root)
    return list(zip(rgb, depth))


@pytest.mark.parametrize("name", ["cgnet", "lmffnet"])
def test_predictor_masks_match_jax(frames, name):
    if name == "cgnet":
        jpred = JCGNetPredictor(params=_init(JCGNet(classes=2, in_channels=4), (1, 240, 320, 4)))
        tpred = CGNetPredictor(params=jpred.variables, device="cpu")
    else:
        jpred = JLMFFNetPredictor(params=_init(JLMFFNet(classes=3), (1, 480, 640, 6)))
        tpred = LMFFNetPredictor(params=jpred.variables, device="cpu")
    for rgb_path, depth_path in frames:
        want = jpred.predict(rgb_path, depth_path)
        got = tpred.predict(rgb_path, depth_path)
        assert got.shape == want.shape == (480, 640) and got.dtype == bool
        assert (got == want).mean() >= 0.999


def test_predictors_default_to_the_card():
    import inspect

    for cls in (CGNetPredictor, LMFFNetPredictor):
        assert inspect.signature(cls).parameters["device"].default == "cuda"

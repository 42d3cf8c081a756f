"""The port's CGNet, LMFFNet and UCN importers (quber_tpu_torch/models/
import_zoo.py) against the JAX package's (quber_tpu/models/import_zoo.py).

No released checkpoint is in the repository, so each state dict is a twin in
the reference's layout: torch module trees written here after the module
trees the JAX importers name (tests/reference_twins.py), every tensor
seeded at a trained net's scales (kernels LeCun-normal, BatchNorm variances
positive, PReLU slopes moved). The port's importer must
give state_dict_from_jax of the JAX importer's tree exactly; the port's
module with those weights must match the JAX module with the JAX tree
(the foreground nets' logits within 1e-4 of their peak, as
tests/test_torch_fg.py holds them; UCN's embeddings within 1e-5, as
tests/test_torch_ucn.py does); a key left unmapped or a key missing raises
KeyError in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quber_tpu.models import import_zoo as JIZ
from quber_tpu.models.cgnet import CGNet as JCGNet
from quber_tpu.models.lmffnet import LMFFNet as JLMFFNet
from quber_tpu.models.ucn import UCNEmbeddingNet as JUCN
from quber_tpu_torch.models import import_zoo as TIZ
from quber_tpu_torch.models.cgnet import CGNet
from quber_tpu_torch.models.from_jax import state_dict_from_jax
from quber_tpu_torch.models.lmffnet import LMFFNet
from quber_tpu_torch.models.ucn import UCNEmbeddingNet
from reference_twins import cgnet_twin, lmffnet_twin, seeded_state as _seeded, ucn_twin


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _logits_gap(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax_forward(model, variables, *xs):
    return np.asarray(jax.jit(model.apply)(
        {"params": variables["params"], "batch_stats": variables["batch_stats"]},
        *(jnp.asarray(x) for x in xs)))


def _port_forward(model, sd, *xs):
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = model.eval()(*(torch.from_numpy(x).permute(0, 3, 1, 2) for x in xs))
    return out.permute(0, 2, 3, 1).numpy()


def _same(got: dict, tree: dict):
    want = state_dict_from_jax(tree)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and torch.equal(got[k], v), k


FG_CASES = {
    "cgnet_small": (lambda: cgnet_twin(m=2, n=3), dict(m=2, n=3), JIZ.import_cgnet,
                    TIZ.import_cgnet, lambda: (JCGNet(classes=2, in_channels=4, m=2, n=3),
                                               CGNet(2, 4, m=2, n=3)), (1, 40, 56, 4)),
    "cgnet_full": (cgnet_twin, {}, JIZ.import_cgnet, TIZ.import_cgnet,
                   lambda: (JCGNet(classes=2, in_channels=4), CGNet(2, 4)), (1, 40, 56, 4)),
    "lmffnet": (lmffnet_twin, {}, JIZ.import_lmffnet, TIZ.import_lmffnet,
                lambda: (JLMFFNet(classes=3), LMFFNet(3)), (1, 64, 96, 6)),
    "lmffnet_small": (lambda: lmffnet_twin(1, 2), dict(block_1=1, block_2=2), JIZ.import_lmffnet,
                      TIZ.import_lmffnet, lambda: (JLMFFNet(classes=3, block_1=1, block_2=2),
                                                   LMFFNet(3, block_1=1, block_2=2)),
                      (1, 64, 96, 6)),
}


@pytest.mark.parametrize("name", sorted(FG_CASES))
def test_foreground_net_import_matches_jax(name):
    twin, kwargs, jimport, timport, models, shape = FG_CASES[name]
    sd = _seeded(twin(), seed=len(name))
    tree = jimport(sd, **kwargs)
    got = timport(sd, **kwargs)
    _same(got, tree)
    jnet, tnet = models()
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    want = _jax_forward(jnet, tree, x)
    assert _logits_gap(_port_forward(tnet, got, x), want) <= 1e-4


@pytest.mark.parametrize("name", sorted(FG_CASES))
def test_foreground_net_import_refuses_like_jax(name):
    twin, kwargs, jimport, timport, _, _ = FG_CASES[name]
    sd = _seeded(twin(), seed=1)
    extra = dict(sd, **{"head.weight": np.zeros((2, 2), np.float32)})
    missing = dict(sd)
    del missing[sorted(k for k in sd if k.endswith("running_mean"))[-1]]
    for bad in (extra, missing):
        with pytest.raises(KeyError):
            jimport(bad, **kwargs)
        with pytest.raises(KeyError):
            timport(bad, **kwargs)
    # not strict: the extra key is left out, the rest as strict
    _same(timport(extra, strict=False, **kwargs), jimport(extra, strict=False, **kwargs))


UCN_CASES = {
    "rgb_depth_fcn": ("rgb_fcn", "depth_fcn", ""),
    "data_parallel": ("rgb_fcn", "depth_fcn", "module."),
    "depth_first": ("rgb_fcn", "d_fcn", ""),  # the depth branch sorts first
}


@pytest.mark.parametrize("name", sorted(UCN_CASES))
def test_ucn_import_matches_jax(name):
    rgb, depth, wrap = UCN_CASES[name]
    sd = {wrap + k: v for k, v in _seeded(ucn_twin(rgb=rgb, depth=depth), seed=5).items()}
    assert TIZ.detect_ucn_prefixes({k.removeprefix(wrap): v for k, v in sd.items()}) == \
        (f"{rgb}.", f"{depth}.")
    tree = JIZ.import_ucn(sd)
    got = TIZ.import_ucn(sd)
    _same(got, tree)
    rs = np.random.RandomState(2)
    rgb_x, xyz_x = (rs.rand(1, 64, 96, 3).astype(np.float32) for _ in range(2))
    want = _jax_forward(JUCN(embed_dim=16), tree, rgb_x, xyz_x)
    got_e = _port_forward(UCNEmbeddingNet(16), got, rgb_x, xyz_x)
    np.testing.assert_allclose(got_e, want, rtol=0, atol=1e-5)


def test_ucn_import_refuses_like_jax():
    sd = _seeded(ucn_twin(), seed=6)
    # prefixes given by the caller win over the detection
    swapped = TIZ.import_ucn(sd, rgb_prefix="depth_fcn.", depth_prefix="rgb_fcn.")
    _same(swapped, JIZ.import_ucn(sd, rgb_prefix="depth_fcn.", depth_prefix="rgb_fcn."))
    assert torch.equal(swapped["rgb_branch.fc.weight"], torch.from_numpy(sd["depth_fcn.fc.weight"]))
    extra = dict(sd, **{"rgb_fcn.extra.weight": np.zeros(3, np.float32)})
    missing = {k: v for k, v in sd.items() if k != "depth_fcn.layer3.5.bn2.running_var"}
    third = dict(sd, **{"other.conv1.weight": np.zeros((64, 3, 7, 7), np.float32)})
    for bad in (extra, missing, third):
        with pytest.raises(KeyError):
            JIZ.import_ucn(bad)
        with pytest.raises(KeyError):
            TIZ.import_ucn(bad)

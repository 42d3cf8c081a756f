"""The port's UOAIS-Net against the JAX package (quber_tpu/models/uoais_net.py)
at the JAX tests' small size: max_proposals 16, max_detections 4, GroupNorm,
a 64x64 frame of 0-255 values.

Parameters are the JAX package's init carried across with from_jax.
Tolerances: in float32 every float output (boxes, scores, mask and
occlusion logits, the RPN and box-head outputs) within 1e-4 of its max
|JAX|, and the selections (det_index, valid, proposal_valid) equal, with
and without ground-truth proposals spliced in; paste_masks exactly; the
losses rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quber_tpu.models import uoais_net as JU
from quber_tpu_torch.models import uoais_net as TU
from quber_tpu_torch.models.from_jax import state_dict_from_jax, state_dict_to_jax

SMALL = dict(max_proposals=16, max_detections=4, norm="GN")
RTOL = 1e-4
GT_BOXES = np.asarray([[8, 8, 30, 30], [35, 12, 60, 40], [0, 0, 0, 0]], np.float32)


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
    """(inputs, JAX variables, the JAX outputs without and with GT
    proposals, the port's net holding the variables)."""
    rng = np.random.RandomState(0)
    rgb = (rng.rand(1, 64, 64, 3) * 255).astype(np.float32)
    dep = (rng.rand(1, 64, 64, 3) * 255).astype(np.float32)
    jm = JU.UOAISNet(**SMALL)
    v = jax.tree.map(np.asarray, dict(jax.jit(jm.init)(jax.random.PRNGKey(0), rgb, dep)))
    apply = jax.jit(jm.apply)
    want = {False: jax.tree.map(np.asarray, apply(v, rgb, dep)),
            True: jax.tree.map(np.asarray, apply(v, rgb, dep, gt_proposals=GT_BOXES))}
    model = TU.UOAISNet(**SMALL).eval()
    model.load_state_dict(state_dict_from_jax(v), strict=True)
    return (rgb, dep), v, want, model


def _port_outputs(setup, with_gt):
    (rgb, dep), _, _, model = setup
    with torch.no_grad():
        return model(nchw(rgb), nchw(dep),
                     gt_proposals=torch.from_numpy(GT_BOXES) if with_gt else None)


@pytest.mark.parametrize("with_gt", [False, True], ids=["rpn", "gt-proposals"])
def test_forward_float32(setup, with_gt):
    want = setup[2][with_gt]
    got = _port_outputs(setup, with_gt)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.shape == w.shape, k
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=RTOL * np.abs(w).max(), err_msg=k)
    if with_gt:  # the two valid ground-truth boxes (slots 13, 14) rank into the detections
        assert {13, 14} <= set(want["det_index"].tolist())


def test_variables_round_trip(setup):
    _, v, _, model = setup
    flat = lambda t: dict(jax.tree_util.tree_leaves_with_path(t))  # noqa: E731
    want, got = flat(v), flat(state_dict_to_jax(model))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("seed", [0, 1])
def test_paste_masks_exact(seed):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(6, 28, 28) * 3).astype(np.float32)
    xy = rng.rand(6, 2) * [90, 60] - 10  # some boxes cross the frame's edge
    boxes = np.concatenate([xy, xy + rng.rand(6, 2) * 50 + 0.5], axis=1).astype(np.float32)
    valid = np.asarray([True, True, False, True, True, True])
    want = np.asarray(JU.paste_masks(jnp.asarray(logits), jnp.asarray(boxes),
                                     jnp.asarray(valid), 72, 96))
    got = TU.paste_masks(torch.from_numpy(logits), torch.from_numpy(boxes),
                         torch.from_numpy(valid), 72, 96).numpy()
    np.testing.assert_array_equal(got, want)
    assert want[valid].any(axis=(1, 2)).sum() >= 4 and not want[~valid].any()


@pytest.mark.parametrize("with_gt", [False, True], ids=["rpn", "gt-proposals"])
def test_losses(setup, with_gt):
    n = 3
    vis = np.zeros((n, 64, 64), np.float32)
    vis[0, 8:30, 8:30] = 1
    vis[1, 12:40, 35:60] = 1
    amo = vis.copy()
    amo[0, 8:34, 8:34] = 1  # instance 0 occluded
    valid = np.asarray([True, True, False])
    args = (GT_BOXES, vis, amo, valid)
    want = JU.uoais_losses(setup[2][with_gt], *map(jnp.asarray, args))
    got = TU.uoais_losses(_port_outputs(setup, with_gt), *map(torch.from_numpy, args))
    assert set(got) == set(want)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=RTOL, abs=1e-7), k
    if with_gt:  # the mask and occlusion heads see positives
        assert float(want["loss_visible_mask"]) > 0 and float(want["loss_occlusion"]) != 0

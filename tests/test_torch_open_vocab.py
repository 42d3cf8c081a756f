"""The port's open-vocabulary models (quber_tpu_torch/models/open_vocab.py)
against the JAX package's (quber_tpu/models/open_vocab.py) at a small size.

Weights are the port's seeded init carried to the JAX modules with
state_dict_to_jax (so the layouts must agree leaf for leaf), float32.
Tolerances: hash_tokenize equal; the text tower's embeddings, a padded and
an empty text among them, within 1e-5 and finite; the detector (GroupNorm,
a 64x64 frame of 0-255 values, 16 proposals, 4 detections) with and without
ground-truth proposals: every float output within 1e-4 of its max |JAX|,
the selections (classes, valid, det_index, proposal_valid) equal; the
losses on the reference's own outputs rtol 1e-4, with an invalid slot that
shares its anchor with a valid ground truth before or after it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quber_tpu.models import open_vocab as JO
from quber_tpu_torch.models import open_vocab as TO
from quber_tpu_torch.models.from_jax import state_dict_to_jax

RTOL = 1e-4
SMALL = dict(max_proposals=16, max_detections=4, norm="GN")
TEXTS = ["A rigid object.", "cereal_box", "", "nine_hole_peg_test timer mug bowl ball",
         "Ünïcode wörds 一 ٣", " ".join(f"w{i}" for i in range(20))]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_hash_tokenize_equal():
    texts = TEXTS + JO.VOCABULARIES["OCID"] + JO.VOCABULARIES["OSD"]
    for kw in ({}, {"vocab_size": 97, "max_len": 4}):
        want = JO.hash_tokenize(texts, **kw)
        got = TO.hash_tokenize(texts, **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert TO.VOCABULARIES == JO.VOCABULARIES


def test_text_encoder_with_padding():
    model = TO.TextEncoder(vocab_size=512, dim=64, out_dim=32, depth=2, num_heads=4).eval()
    model.reset_parameters(torch.Generator().manual_seed(0))
    ids, mask = JO.hash_tokenize(TEXTS, vocab_size=512)
    want = np.asarray(JO.TextEncoder(vocab_size=512, dim=64, out_dim=32, depth=2,
                                     num_heads=4).apply(state_dict_to_jax(model), ids, mask))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert np.isfinite(want).all() and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert not got[2].any()  # no token: the pool is empty
    norms = np.linalg.norm(got[[0, 1, 3, 4, 5]], axis=1)
    np.testing.assert_allclose(norms, 1.0, rtol=1e-5)


def test_masked_rows_are_uniform_not_nan():
    """A padding query's logits all masked: flax's lowest finite logit gives
    a uniform row (-inf would give NaN)."""
    from quber_tpu_torch.models.layers import MultiHeadDotProductAttention

    attn = MultiHeadDotProductAttention(8, 2)
    x = torch.randn(1, 3, 8, generator=torch.Generator().manual_seed(0))
    mask = torch.tensor([True, True, False])
    out = attn(x, mask[None, None, None, :] & mask[None, None, :, None])
    assert torch.isfinite(out).all()
    v = attn.value(x).reshape(1, 3, 2, 4).transpose(1, 2)
    uniform = attn.out(v.mean(dim=2, keepdim=True).expand(1, 2, 3, 4)
                       .transpose(1, 2).reshape(1, 3, 8))
    torch.testing.assert_close(out[0, 2], uniform[0, 2], rtol=1e-6, atol=1e-6)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


GT_BOXES = np.asarray([[8, 8, 30, 30], [35, 12, 60, 40], [0, 0, 0, 0]], np.float32)


@pytest.fixture(scope="module")
def detector():
    """(rgb, text embeddings, the port's detector, the JAX outputs without
    and with ground-truth proposals)."""
    rng = np.random.RandomState(0)
    rgb = (rng.rand(1, 64, 64, 3) * 255).astype(np.float32)
    text = rng.randn(5, 256).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    model = TO.DeticDetector(**SMALL).eval()
    model.reset_parameters(torch.Generator().manual_seed(1))
    variables = state_dict_to_jax(model)
    apply = jax.jit(JO.DeticDetector(**SMALL).apply)
    want = {False: jax.tree.map(np.asarray, apply(variables, rgb, text)),
            True: jax.tree.map(np.asarray, apply(variables, rgb, text, gt_proposals=GT_BOXES))}
    return rgb, text, model, want


@pytest.mark.parametrize("with_gt", [False, True], ids=["rpn", "gt-proposals"])
def test_detector_float32(detector, with_gt):
    rgb, text, model, want = detector
    want = want[with_gt]
    with torch.no_grad():
        got = model(nchw(rgb), torch.from_numpy(text),
                    gt_proposals=torch.from_numpy(GT_BOXES) if with_gt else None)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.shape == w.shape, k
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=RTOL * np.abs(w).max(), err_msg=k)
    assert want["valid"].any()
    if with_gt:  # the two valid ground-truth boxes (slots 13, 14) rank into the detections
        assert {13, 14} <= set(want["det_index"].tolist())


def _anchor0_box():
    """A box whose best anchor is anchor 0 of the 64x64 frame."""
    from quber_tpu_torch.models.uoais_net import multilevel_anchors

    a0 = torch.cat(list(multilevel_anchors(64, 64).values()))[0].numpy()
    return np.clip(a0, 0, 64).astype(np.float32)


@pytest.mark.parametrize("order", ["invalid-after", "invalid-before"])
def test_losses_with_a_shared_anchor(detector, order):
    """The losses on the reference's outputs (with ground-truth proposals).
    A valid box's best anchor is anchor 0, which the invalid slot's all-zero
    IoU column names too: the reference's scatter lets the later slot
    decide whether anchor 0 is a forced positive."""
    from quber_tpu_torch.models.uoais_net import forced_positives
    from quber_tpu_torch.ops.boxes import box_iou

    out = detector[3][True]
    boxes = np.stack([_anchor0_box(), GT_BOXES[0], GT_BOXES[1], GT_BOXES[2]])
    valid = np.asarray([True, True, True, False])
    classes = np.asarray([3, 1, 4, 0], np.int32)
    if order == "invalid-before":
        boxes, valid, classes = boxes[[3, 0, 1, 2]], valid[[3, 0, 1, 2]], classes[[3, 0, 1, 2]]
    anchors = torch.from_numpy(np.array(out["anchors"]))
    k = int(np.flatnonzero(valid)[0]) if order == "invalid-before" else 0
    iou = box_iou(anchors, torch.from_numpy(boxes))
    assert int(iou[:, k].argmax()) == 0 and float(iou[0, k]) < 0.7
    forced = forced_positives(torch.where(torch.from_numpy(valid)[None], iou, 0.0),
                              torch.from_numpy(valid))
    assert bool(forced[0]) == (order == "invalid-before")  # the later slot decides
    masks = np.zeros((4, 64, 64), np.float32)
    for i, (x0, y0, x1, y1) in enumerate(boxes.astype(int)):
        masks[i, y0:y1, x0:x1] = 1
    args = (boxes, classes, masks, valid)
    want = jax.jit(JO.detic_losses)(out, *map(jnp.asarray, args))
    got = TO.detic_losses({k: torch.from_numpy(np.asarray(v)) for k, v in out.items()},
                          *map(torch.from_numpy, args))
    assert set(got) == set(want)
    for key in want:
        assert float(got[key]) == pytest.approx(float(want[key]), rel=RTOL, abs=1e-7), key
    assert float(want["loss_mask"]) > 0 and float(want["loss_cls"]) > 0

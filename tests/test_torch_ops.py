"""The port's plain encode and grouping ops against the JAX package.

Encode and group are held against both the XLA functions and the Pallas
kernels in interpret mode, as tests/test_pallas_kernels.py runs them.
Tolerances: heatmap atol 1e-6 (exp and division rounding), offsets atol
1e-5 (float32 centroid sums in JAX, exact sums in the port), centroids
atol 1e-4 px; grouping ids, NMS and instance counts exact; scores rtol
1e-5. The wrappers of the CUDA kernels (ops.kernels) run their plain
versions here, and equal them exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from quber_tpu.ops import encoding as JE
from quber_tpu.ops import grouping as JG
from quber_tpu.ops.pallas_kernels import (
    encode_initial_masks_pallas, encode_initial_masks_pallas_batched, group_pixels_pallas,
    group_pixels_pallas_batched)
from quber_tpu_torch.ops import encoding as TE
from quber_tpu_torch.ops import grouping as TG
from quber_tpu_torch.ops import kernels as TK


def _t(a):
    return torch.from_numpy(np.array(a))


def _mask_cases(rng, blobs):
    """(name, masks [N,H,W] bool, valid [N] bool) cases of the Pallas tests:
    blobs, an overlapping pair, empty and invalid slots, an odd size."""
    h, w = 64, 128
    m = np.zeros((6, h, w), bool)
    m[:4] = blobs(rng, 4, h, w, min_r=8, max_r=16) > 0
    m[1] |= m[0]  # overlap: last-wins owner
    yield "overlap_invalid", m, np.array([True, True, True, True, False, False])
    m2 = blobs(rng, 5, h, w, min_r=8, max_r=16) > 0
    m2[2] = False  # valid but empty
    m2[4] = m2[3]  # identical masks: the later index owns them
    yield "empty_slot", m2, np.ones(5, bool)
    h, w = 33, 41
    yield "odd_size", blobs(rng, 3, h, w, min_r=4, max_r=8) > 0, np.array([True, False, True])
    yield "all_empty", np.zeros((4, 24, 40), bool), np.zeros(4, bool)


def test_instance_stats_matches_jax(rng, blobs):
    for name, masks, valid in _mask_cases(rng, blobs):
        ja, jc = JE.instance_stats(jnp.asarray(masks), jnp.asarray(valid))
        ta, tc = TE.instance_stats(_t(masks), _t(valid))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja), err_msg=name)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4, err_msg=name)


@pytest.mark.parametrize("normalize", [True, False])
def test_encode_matches_xla_and_pallas(rng, blobs, normalize):
    for name, masks, valid in _mask_cases(rng, blobs):
        xla = np.asarray(JE.encode_initial_masks(
            jnp.asarray(masks), jnp.asarray(valid), sigma=10, normalize=normalize))
        areas, centers = JE.instance_stats(jnp.asarray(masks), jnp.asarray(valid))
        pallas = np.asarray(encode_initial_masks_pallas(
            jnp.asarray(masks), jnp.asarray(valid) & (areas > 0), centers,
            sigma=10, normalize=normalize, interpret=True))
        got = TE.encode_initial_masks(_t(masks), _t(valid), sigma=10,
                                      normalize=normalize).numpy()
        for ref in (xla, pallas):
            np.testing.assert_allclose(got[0], ref[0], atol=1e-6, rtol=0, err_msg=name)
            np.testing.assert_allclose(got[1:], ref[1:], atol=1e-5, rtol=0, err_msg=name)


def test_encode_wrapper_takes_plain_version_on_cpu(rng, blobs):
    masks = _t(blobs(rng, 4, 48, 64, min_r=6, max_r=12) > 0)
    valid = torch.tensor([True, True, False, True])
    areas, centers = TE.instance_stats(masks, valid)
    ok = valid & (areas > 0)
    before = TK.encode_initial_masks.launches
    got = TK.encode_initial_masks(masks, ok, centers)
    assert TK.encode_initial_masks.launches == before  # the CPU runs no kernel
    torch.testing.assert_close(got, TE.encode_from_stats(masks, ok, centers), rtol=0, atol=0)


def test_encode_rounds_centroids_half_to_even():
    # a 2-pixel-wide bar has a centroid at x = 10.5: half to even gives 10
    h, w = 32, 48
    masks = np.zeros((1, h, w), bool)
    masks[0, 8:24, 10:12] = True
    got = TE.encode_initial_masks(_t(masks)).numpy()
    ref = np.asarray(JE.encode_initial_masks(jnp.asarray(masks)))
    np.testing.assert_allclose(got, ref, atol=1e-6)
    assert got[0, 16, 10] == 1.0 and got[0, 16, 11] < 1.0


def _group_cases(rng, blobs):
    h, w = 120, 160
    masks = blobs(rng, 5, h, w)
    enc = np.asarray(JE.encode_initial_masks(jnp.asarray(masks), normalize=False))
    centers, valid = JG.find_instance_centers(jnp.asarray(enc[0]), 0.3, 7, 200)
    yield "blobs_k200", np.asarray(centers), np.asarray(valid), enc[1:]
    yield "blobs_k32", np.asarray(centers)[:32], np.asarray(valid)[:32], enc[1:]
    h, w = 33, 41
    offsets = rng.randn(2, h, w).astype(np.float32)
    centers = np.zeros((200, 2), np.int32)
    centers[:3] = [[5, 7], [20, 30], [30, 10]]
    valid = np.zeros(200, bool)
    valid[:3] = True
    yield "odd_size", centers, valid, offsets
    # exact ties: (10, 10) is equidistant from (10, 6) and (10, 14), and the
    # duplicate centre at index 3 ties with index 1 everywhere
    centers = np.array([[10, 6], [10, 14], [30, 30], [10, 14]], np.int32)
    valid = np.array([True, True, True, True])
    yield "ties", centers, valid, np.zeros((2, 40, 40), np.float32)
    yield "all_invalid", centers, np.zeros(4, bool), rng.randn(2, 40, 40).astype(np.float32)


def test_group_pixels_matches_xla_and_pallas(rng, blobs):
    for name, centers, valid, offsets in _group_cases(rng, blobs):
        jc, jv, jo = jnp.asarray(centers), jnp.asarray(valid), jnp.asarray(offsets)
        xla = np.asarray(JG.group_pixels(jc, jv, jo))
        pallas = np.asarray(group_pixels_pallas(jc, jv, jo, interpret=True))
        got = TK.group_pixels(_t(centers), _t(valid), _t(offsets)).numpy()
        np.testing.assert_array_equal(got, xla, err_msg=name)
        np.testing.assert_array_equal(got, pallas, err_msg=name)
        if name == "ties":
            assert got[10, 10] == 1 and not (got == 4).any()
        if name == "all_invalid":
            assert (got == 1).all()


def _heatmap(rng, blobs, h=120, w=160):
    masks = blobs(rng, 6, h, w)
    heat = np.asarray(JE.encode_initial_masks(jnp.asarray(masks), normalize=False))[0]
    # noise breaks the plateau ties; a few flat plateaus keep some
    heat = heat + 0.01 * rng.rand(h, w).astype(np.float32)
    heat[5:9, 5:9] = 0.9
    return heat.astype(np.float32)


@pytest.mark.parametrize("kernel", [3, 7])
def test_nms_heatmap_matches_jax(rng, blobs, kernel):
    heat = _heatmap(rng, blobs)
    want = np.asarray(JG.nms_heatmap(jnp.asarray(heat), 0.3, kernel))
    got = TG.nms_heatmap(_t(heat), 0.3, kernel).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("top_k", [200, 32, 4])
def test_find_instance_centers_matches_jax(rng, blobs, top_k):
    heat = _heatmap(rng, blobs)
    jc, jv = JG.find_instance_centers(jnp.asarray(heat), 0.3, 7, top_k)
    tc, tv = TG.find_instance_centers(_t(heat), 0.3, 7, top_k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tc.dtype == torch.int32


def _merge_inputs(rng, blobs, with_centers=True):
    h, w = 120, 160
    masks = blobs(rng, 5, h, w, min_r=14, max_r=40)
    fg = (masks.sum(0) > 0).astype(np.int32)
    fg_prob = np.where(fg > 0, 0.6 + 0.4 * rng.rand(h, w), 0.4 * rng.rand(h, w)).astype(np.float32)
    enc = np.asarray(JE.encode_initial_masks(jnp.asarray(masks), normalize=False))
    centers, valid = JG.find_instance_centers(jnp.asarray(enc[0]), 0.3, 7, 32)
    if not with_centers:
        valid = jnp.zeros_like(valid)
    raw = np.asarray(JG.group_pixels(centers, valid, jnp.asarray(enc[1:])))
    return fg, fg_prob, enc[0], raw, np.asarray(valid)


@pytest.mark.parametrize("with_centers", [True, False])
def test_merge_and_score_matches_jax(rng, blobs, with_centers):
    fg, fg_prob, heat, raw, cvalid = _merge_inputs(rng, blobs, with_centers)
    want = JG.merge_and_score(jnp.asarray(fg), jnp.asarray(fg_prob), jnp.asarray(heat),
                              jnp.asarray(raw), jnp.asarray(cvalid),
                              min_instance_area=512, stuff_area=2048)
    got = TG.merge_and_score(_t(fg), _t(fg_prob), _t(heat), _t(raw), _t(cvalid),
                             min_instance_area=512, stuff_area=2048)
    assert int(got["num_instances"]) == int(want["num_instances"])
    assert int(got["num_instances"]) > 0  # instances, or the stuff blob
    np.testing.assert_array_equal(got["panoptic"].numpy(), np.asarray(want["panoptic"]))
    np.testing.assert_array_equal(got["areas"].numpy(), np.asarray(want["areas"]))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]),
                               rtol=1e-5, atol=1e-7)


# --- batched twins: the plain batched versions against the batched Pallas
# kernels (interpret mode), frame by frame ---

def _batched_mask_case(rng, blobs, h, w):
    """[B=4, N=6, H, W] masks with a different number of valid slots per
    frame (4, 6, 2, 0), an overlapping pair, an empty valid slot and a frame
    with no valid slot at all."""
    n = 6
    masks = np.zeros((4, n, h, w), bool)
    valid = np.zeros((4, n), bool)
    for b, n_valid in enumerate((4, 6, 2, 0)):
        masks[b] = blobs(rng, n, h, w, min_r=4, max_r=min(h, w) // 4) > 0
        valid[b, :n_valid] = True
    masks[0, 1] |= masks[0, 0]  # last-wins owner
    masks[1, 3] = False  # valid but empty
    return masks, valid


@pytest.mark.parametrize("size", [(64, 128), (33, 41)])
@pytest.mark.parametrize("normalize", [True, False])
def test_encode_batched_matches_pallas(rng, blobs, size, normalize):
    masks, valid = _batched_mask_case(rng, blobs, *size)
    ja, jc = JE.instance_stats(jnp.asarray(masks.reshape(-1, *size)),
                               jnp.asarray(valid.reshape(-1)))
    ok = jnp.asarray(valid) & (ja.reshape(valid.shape) > 0)
    pallas = np.asarray(encode_initial_masks_pallas_batched(
        jnp.asarray(masks), ok, jc.reshape(*valid.shape, 2), sigma=10,
        normalize=normalize, interpret=True))
    ta, tc = TE.instance_stats(_t(masks), _t(valid))
    got = TK.encode_initial_masks_batched(_t(masks), _t(valid) & (ta > 0), tc,
                                          normalize=normalize).numpy()
    assert got.shape == pallas.shape == (4, 3, *size)
    for b in range(4):
        np.testing.assert_allclose(got[b, 0], pallas[b, 0], atol=1e-6, rtol=0, err_msg=str(b))
        np.testing.assert_allclose(got[b, 1:], pallas[b, 1:], atol=1e-5, rtol=0, err_msg=str(b))
    np.testing.assert_array_equal(got[3], 0.0)  # the frame with no valid slot


def test_instance_stats_batched_matches_frames(rng, blobs):
    masks, valid = _batched_mask_case(rng, blobs, 48, 64)
    areas, centers = TE.instance_stats(_t(masks), _t(valid))
    for b in range(4):
        fa, fc = TE.instance_stats(_t(masks[b]), _t(valid[b]))
        torch.testing.assert_close(areas[b], fa, rtol=0, atol=0)
        torch.testing.assert_close(centers[b], fc, rtol=0, atol=0)


def _batched_group_case(rng, blobs, k):
    """[B=3] frames at 64x128 with 3, 5 and 0 valid centres (of k), centres
    from the encoded blobs and random offsets."""
    h, w = 64, 128
    centers = np.zeros((3, k, 2), np.int32)
    valid = np.zeros((3, k), bool)
    offsets = np.zeros((3, 2, h, w), np.float32)
    for b, n_valid in enumerate((3, 5, 0)):
        masks = blobs(rng, 5, h, w, min_r=8, max_r=16)
        enc = np.asarray(JE.encode_initial_masks(jnp.asarray(masks), normalize=False))
        c, _ = JG.find_instance_centers(jnp.asarray(enc[0]), 0.3, 7, k)
        centers[b] = np.asarray(c)
        centers[b, :n_valid] = np.stack([rng.randint(0, h, n_valid),
                                         rng.randint(0, w, n_valid)], -1)
        valid[b, :n_valid] = True
        offsets[b] = enc[1:] + rng.randn(2, h, w).astype(np.float32)
    return centers, valid, offsets


@pytest.mark.parametrize("k", [200, 32])
def test_group_pixels_batched_matches_pallas(rng, blobs, k):
    centers, valid, offsets = _batched_group_case(rng, blobs, k)
    jc, jv, jo = jnp.asarray(centers), jnp.asarray(valid), jnp.asarray(offsets)
    pallas = np.asarray(group_pixels_pallas_batched(jc, jv, jo, interpret=True))
    got = TK.group_pixels_batched(_t(centers), _t(valid), _t(offsets)).numpy()
    assert got.shape == pallas.shape == (3, 64, 128) and got.dtype == np.int32
    for b in range(3):
        np.testing.assert_array_equal(got[b], pallas[b], err_msg=str(b))
        np.testing.assert_array_equal(
            got[b], np.asarray(JG.group_pixels(jc[b], jv[b], jo[b])), err_msg=str(b))
    assert (got[2] == 1).all()  # every centre invalid: argmin index 0


def test_batched_wrappers_take_plain_versions_on_cpu(rng, blobs):
    masks, valid = _batched_mask_case(rng, blobs, 24, 40)
    areas, centers = TE.instance_stats(_t(masks), _t(valid))
    ok = _t(valid) & (areas > 0)
    cen, val, off = (_t(a) for a in _batched_group_case(rng, blobs, 32))
    TK.reset_launch_counts()
    enc = TK.encode_initial_masks_batched(_t(masks), ok, centers)
    ids = TK.group_pixels_batched(cen, val, off)
    assert TK.encode_initial_masks_batched.launches == 0  # the CPU runs no kernel
    assert TK.group_pixels_batched.launches == 0
    torch.testing.assert_close(enc, TE.encode_from_stats_batched(_t(masks), ok, centers),
                               rtol=0, atol=0)
    for b in range(3):
        torch.testing.assert_close(ids[b], TG.group_pixels(cen[b], val[b], off[b]),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("top_k", [200, 32])
def test_find_instance_centers_batched_matches_jax(rng, blobs, top_k):
    heats = np.stack([_heatmap(rng, blobs) for _ in range(3)])
    heats[2] = 0.0  # no peak above the threshold
    tc, tv = TG.find_instance_centers_batched(_t(heats), 0.3, 7, top_k)
    assert tc.shape == (3, top_k, 2) and tv.shape == (3, top_k)
    for b in range(3):
        jc, jv = JG.find_instance_centers(jnp.asarray(heats[b]), 0.3, 7, top_k)
        np.testing.assert_array_equal(tv[b].numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tc[b].numpy(), np.asarray(jc))
    assert not tv[2].any()


# --- the shapes the CUDA kernels treat specially (vector against scalar
# variants, owner tags above a byte, tables of one entry): the semantics the
# kernels are held to on the card, pinned here against the JAX package ---

def _special_mask_case(name, rng, blobs):
    if name == "hw_not_multiple_of_16":  # 37 * 45 = 1665: no 16-byte rows
        masks = blobs(rng, 5, 37, 45, min_r=4, max_r=9) > 0
        masks[3] |= masks[2]
        return masks, np.array([True, True, False, True, True])
    if name == "more_than_255_ok":  # owners above 255 do not fit a byte lane
        h, w, n = 40, 48, 300
        masks = np.zeros((n, h, w), bool)
        for i in range(n):
            y, x = rng.randint(0, h - 6), rng.randint(0, w - 6)
            masks[i, y:y + rng.randint(2, 7), x:x + rng.randint(2, 7)] = True
        valid = np.ones(n, bool)
        valid[::17] = False
        return masks, valid
    if name == "single_instance":
        return blobs(rng, 1, 48, 64, min_r=6, max_r=12) > 0, np.ones(1, bool)
    assert name == "all_invalid"
    return blobs(rng, 4, 48, 64, min_r=6, max_r=12) > 0, np.zeros(4, bool)


@pytest.mark.parametrize("name", ["hw_not_multiple_of_16", "more_than_255_ok",
                                  "single_instance", "all_invalid"])
def test_stats_and_encode_special_shapes_match_jax(rng, blobs, name):
    masks, valid = _special_mask_case(name, rng, blobs)
    ja, jc = JE.instance_stats(jnp.asarray(masks), jnp.asarray(valid))
    areas, centers, ok = TK.instance_stats(_t(masks), _t(valid), return_ok=True)
    np.testing.assert_array_equal(areas.numpy(), np.asarray(ja))
    np.testing.assert_allclose(centers.numpy(), np.asarray(jc), atol=1e-4)
    np.testing.assert_array_equal(ok.numpy(), valid & (np.asarray(ja) > 0))
    if name == "more_than_255_ok":
        assert int(ok.sum()) > 255
    xla = np.asarray(JE.encode_initial_masks(jnp.asarray(masks), jnp.asarray(valid), sigma=10))
    pallas = np.asarray(encode_initial_masks_pallas(
        jnp.asarray(masks), jnp.asarray(valid) & (ja > 0), jc, sigma=10, interpret=True))
    got = TK.encode_initial_masks(_t(masks), ok, centers).numpy()
    for ref in (xla, pallas):
        np.testing.assert_allclose(got[0], ref[0], atol=1e-6, rtol=0)
        np.testing.assert_allclose(got[1:], ref[1:], atol=1e-5, rtol=0)
    if name == "all_invalid":
        np.testing.assert_array_equal(got, 0.0)


def _special_group_case(name, rng):
    h, w = 33, 47
    k = {"k1": 1, "k33": 33, "last_valid": 64}[name]
    centers = np.stack([rng.randint(0, h, k), rng.randint(0, w, k)], -1).astype(np.int32)
    valid = np.ones(k, bool)
    if name == "k33":
        valid[1::3] = False
    if name == "last_valid":  # the only valid centre at the last index
        valid[:-1] = False
    return centers, valid, (rng.randn(2, h, w) * 5).astype(np.float32)


@pytest.mark.parametrize("name", ["k1", "k33", "last_valid"])
def test_group_pixels_special_tables_match_jax(rng, name):
    centers, valid, offsets = _special_group_case(name, rng)
    jc, jv, jo = jnp.asarray(centers), jnp.asarray(valid), jnp.asarray(offsets)
    got = TK.group_pixels(_t(centers), _t(valid), _t(offsets)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JG.group_pixels(jc, jv, jo)))
    np.testing.assert_array_equal(
        got, np.asarray(group_pixels_pallas(jc, jv, jo, interpret=True)))
    if name == "last_valid":
        assert (got == 64).all()
    if name == "k1":
        assert (got == 1).all()


@pytest.mark.parametrize("batched", [False, True])
def test_stats_wrapper_takes_plain_version_on_cpu(rng, blobs, batched):
    masks, valid = _batched_mask_case(rng, blobs, 37, 45)
    if not batched:
        masks, valid = masks[0], valid[0]
    before = TK.instance_stats.launches
    areas, centers, ok = TK.instance_stats(_t(masks), _t(valid), return_ok=True)
    assert TK.instance_stats.launches == before  # the CPU runs no kernel
    want_areas, want_centers = TE.instance_stats(_t(masks), _t(valid))
    assert torch.equal(areas, want_areas) and torch.equal(centers, want_centers)
    assert torch.equal(ok, _t(valid) & (want_areas > 0))
    two = TK.instance_stats(_t(masks), _t(valid))
    assert len(two) == 2 and torch.equal(two[0], want_areas)
    no_valid = TK.instance_stats(_t(masks))  # valid=None: every slot counts
    assert torch.equal(no_valid[0], TE.instance_stats(_t(masks))[0])

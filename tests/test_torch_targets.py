"""Training data and device-side targets: the torch port against quber_tpu.

The same seeded inputs go through quber_tpu (per sample, channels last) and
the port (batched, channels first). Tolerances are those the reference
allows between its host-side and device-side targets: binary maps and weights
exact, centre heatmap and input encoding 1e-5, offsets 1e-4 px (the port's
centroid sums are exact, the reference's are float32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quber_tpu.config import TrainConfig as JTrainConfig
from quber_tpu.data import mappers as JMap
from quber_tpu.data import perturb as JP
from quber_tpu.data import rle as JRle
from quber_tpu.data import synthetic as JSyn
from quber_tpu.models.mask_refiner import MaskRefinerConfig as JConfig
from quber_tpu.ops import encoding as JE
from quber_tpu.train import device_targets as JDT
from quber_tpu_torch.config import TrainConfig
from quber_tpu_torch.data import mappers as TMap
from quber_tpu_torch.data import perturb as TP
from quber_tpu_torch.data import rle as TRle
from quber_tpu_torch.data import synthetic as TSyn
from quber_tpu_torch.models.mask_refiner import MaskRefinerConfig
from quber_tpu_torch.ops import encoding as TE
from quber_tpu_torch.ops import imgproc
from quber_tpu_torch.train import device_targets as TDT

TOLERANCES = [("sem_seg", 0), ("sem_seg_weights", 0), ("center", 1e-5), ("offset", 1e-4),
              ("offset_enc", 1e-5), ("eee_mask", 0), ("eee_boundary", 0),
              ("center_weights", 0), ("offset_weights", 0)]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _discs(rng, n, h, w):
    ys, xs = np.mgrid[:h, :w]
    out = np.zeros((n, h, w), bool)
    for i in range(n):
        cy, cx, r = rng.randint(0, h), rng.randint(0, w), rng.randint(3, h // 3)
        out[i] = (ys - cy) ** 2 + (xs - cx) ** 2 <= r * r
    return out


def _first(x):
    """Channels-first [C, H, W] -> the reference's [H, W, C]."""
    return np.moveaxis(x, 0, -1)


def _assert_field(key, tol, got, want):
    assert got.shape == want.shape, (key, got.shape, want.shape)
    if tol:
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=key)
    else:
        np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("flags", [False, True])
def test_panoptic_train_targets_matches_jax(flags):
    """Overlapping discs (the last valid thing wins a pixel), an empty slot,
    invalid slots, small instances, and optionally stuff and crowd flags."""
    rng = np.random.RandomState(0)
    b, n, h, w = 3, 7, 72, 96
    masks = np.stack([_discs(rng, n, h, w) for _ in range(b)])
    masks[:, 2] = False
    valid = np.ones((b, n), bool)
    valid[0, 5:] = False
    valid[2] = False  # a frame with no instance at all
    is_thing = rng.rand(b, n) > 0.3 if flags else None
    is_crowd = rng.rand(b, n) > 0.7 if flags else None
    kw = dict(sigma=4, small_instance_area=300, small_instance_weight=3)
    got = TE.panoptic_train_targets(
        torch.from_numpy(masks), torch.from_numpy(valid),
        None if is_thing is None else torch.from_numpy(is_thing),
        None if is_crowd is None else torch.from_numpy(is_crowd), **kw)
    for i in range(b):
        want = JE.panoptic_train_targets(
            jnp.asarray(masks[i]), jnp.asarray(valid[i]),
            None if is_thing is None else jnp.asarray(is_thing[i]),
            None if is_crowd is None else jnp.asarray(is_crowd[i]), **kw)
        for key, tol in (("sem_seg", 0), ("sem_seg_weights", 0), ("center_weights", 0),
                         ("offset_weights", 0), ("center", 1e-5), ("offset", 1e-4),
                         ("areas", 0), ("centers", 1e-4)):
            _assert_field(key, tol, got[key][i].numpy(), np.asarray(want[key]))
    # a single frame gives the batch's first entry
    one = TE.panoptic_train_targets(torch.from_numpy(masks[0]), torch.from_numpy(valid[0]),
                                    None if is_thing is None else torch.from_numpy(is_thing[0]),
                                    None if is_crowd is None else torch.from_numpy(is_crowd[0]),
                                    **kw)
    for key in got:
        assert torch.equal(one[key], got[key][0]), key
    assert float(got["center"][2].max()) == 0.0 and float(got["sem_seg"][2].max()) == 0.0


def test_panoptic_targets_round_half_to_even_and_window():
    """A 2x2 square centred on (10.5, 20.5): the Gaussian peaks at the
    half-to-even rounded (10, 20) and stops outside 3 sigma + 1."""
    masks = np.zeros((1, 1, 40, 64), bool)
    masks[0, 0, 10:12, 20:22] = True
    got = TE.panoptic_train_targets(torch.from_numpy(masks), sigma=2)
    want = JE.panoptic_train_targets(jnp.asarray(masks[0]), sigma=2)
    np.testing.assert_allclose(got["center"][0].numpy(), np.asarray(want["center"]), atol=1e-6)
    assert float(got["center"][0, 10, 20]) == 1.0
    assert float(got["center"][0, 10, 27]) > 0 and float(got["center"][0, 10, 28]) == 0.0
    assert got["offset"][0, :, 10, 20].tolist() == [0.5, 0.5]


def _record_pair(h, w, seed, n=1):
    return (JSyn.synthetic_records(n, h, w, seed=seed), TSyn.synthetic_records(n, h, w, seed=seed))


@pytest.mark.parametrize("h,w,seed", [(64, 64, 0), (64, 96, 5), (128, 160, 3)])
def test_synthetic_records_scene_equal_to_jax(h, w, seed):
    """The renderer is pure numpy with the same draws: scene, depth and GT
    masks are equal bit for bit, and so is the number of perturbed masks."""
    jrecs, trecs = _record_pair(h, w, seed, n=3)
    for j, t in zip(jrecs, trecs):
        for key in ("rgb", "depth_mm", "gt_masks"):
            assert j[key].dtype == t[key].dtype
            np.testing.assert_array_equal(j[key], t[key], err_msg=key)
        assert (j["height"], j["width"]) == (t["height"], t["width"]) == (h, w)
        assert len(j["perturbed_segmentation"]) == len(t["perturbed_segmentation"])


def test_render_scene_options_equal_to_jax():
    for kw in (dict(shapes="convex"), dict(shapes="concave", n_objects=4),
               dict(dropout_frac=0.02, return_amodal=True)):
        want = JSyn.render_scene(np.random.RandomState(2), 64, 80, **kw)
        got = TSyn.render_scene(np.random.RandomState(2), 64, 80, **kw)
        assert len(want) == len(got)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(a, b)


def test_perturbed_masks_close_to_the_cv2_version():
    """The port perturbs with scipy.ndimage and its own copy of
    cv2.ellipse's rasterisation where the reference calls OpenCV: with the
    same seed every mask equals the reference's, false-positive blobs
    included."""
    jrecs, trecs = _record_pair(240, 320, 0, n=24)
    n_masks, n_exact, blobs = 0, 0, 0
    for j, t in zip(jrecs, trecs):
        assert len(j["perturbed_segmentation"]) == len(t["perturbed_segmentation"])
        for a, b in zip(j["perturbed_segmentation"], t["perturbed_segmentation"]):
            ma, mb = JRle.decode(a), TRle.decode(b)
            assert TP.mask_iou(ma, mb) == 1.0
            n_masks += 1
            n_exact += int(np.array_equal(ma, mb))
        blobs += len(t["perturbed_segmentation"]) > len(t["gt_masks"])
    assert n_masks > 100 and n_exact == n_masks
    assert blobs  # the sample does hold false-positive blobs


def test_perturb_helpers_exact_against_cv2():
    """Erode, dilate and close equal OpenCV's pixel for pixel (OpenCV's
    erosion does not erode from the array's border), the bicubic resize to
    float rounding, and the random regions of perturb_seg with them."""
    import cv2

    rng = np.random.RandomState(1)
    mask = (rng.rand(90, 120) > 0.35).astype(np.uint8)
    mask[:6] = 1  # foreground on the border
    kernel = np.ones((3, 3), np.uint8)
    for it in (1, 2, 5):
        np.testing.assert_array_equal(imgproc.erode_rect(mask, 3, it),
                                      cv2.erode(mask, kernel, iterations=it))
        np.testing.assert_array_equal(imgproc.dilate_rect(mask, 3, it),
                                      cv2.dilate(mask, kernel, iterations=it))
    sparse = (rng.rand(90, 120) > 0.97).astype(np.uint8)
    np.testing.assert_array_equal(TP.merge_masks(sparse, np.zeros_like(sparse)),
                                  JP.merge_masks(sparse, np.zeros_like(sparse)))
    noise = rng.rand(7, 9)
    np.testing.assert_allclose(imgproc.resize_cubic(noise, (96, 128)),
                               cv2.resize(noise, (128, 96), interpolation=cv2.INTER_CUBIC),
                               atol=1e-5)
    blob = TSyn._superellipse(*np.mgrid[:90, :120].astype(np.float32), 40, 60, 30, 18, 0.4, 2.0)
    for seed in range(5):
        np.testing.assert_array_equal(
            TP.perturb_seg(blob, np.random.RandomState(seed)),
            JP.perturb_seg(blob.astype(np.uint8), np.random.RandomState(seed)))
        np.testing.assert_array_equal(
            TP.modify_boundary(blob, np.random.RandomState(seed), (0.7, 0.95)),
            JP.modify_boundary(blob.astype(np.uint8), np.random.RandomState(seed), (0.7, 0.95)))
        for a, b in zip(TP.split_mask(blob, np.random.RandomState(seed)),
                        JP.split_mask(blob, np.random.RandomState(seed))):
            np.testing.assert_array_equal(a, b)
    assert TP.perturb_masks(np.zeros((0, 8, 8))).shape == (0, 480, 640)


def test_rle_round_trip_against_jax():
    rng = np.random.RandomState(2)
    masks = [_discs(rng, 1, 48, 64)[0].astype(np.uint8), np.zeros((48, 64), np.uint8),
             np.ones((5, 7), np.uint8), (rng.rand(33, 21) > 0.5).astype(np.uint8)]
    for m in masks:
        ours, ref = TRle.encode(m), JRle.encode(m)
        assert ours == ref
        np.testing.assert_array_equal(TRle.decode(ref), m)
        np.testing.assert_array_equal(JRle.decode(ours), m)
        assert ours["counts"] == JRle._string_from_counts(JRle._counts_from_mask(m))
    np.testing.assert_array_equal(TRle.decode({"size": [5, 7], "counts": TRle.encode(masks[2])
                                               ["counts"].encode("ascii")}), masks[2])
    assert TRle.decode_batch([]).shape == (0, 0, 0)
    assert TRle.decode_batch([TRle.encode(m) for m in masks[:2]]).shape == (2, 48, 64)


def test_normalize_depth_mm():
    d = np.random.RandomState(3).uniform(0, 20000, (16, 24)).astype(np.float32)
    for rng_mm in ((2500, 15000), (250, 1500)):
        np.testing.assert_array_equal(TMap.normalize_depth_mm(d, rng_mm),
                                      JMap.normalize_depth_mm(d, rng_mm))


def _packed_pair(h, w, n_slots, seed, n=2):
    """The reference's records packed by the reference and by the port."""
    recs = JSyn.synthetic_records(n, h, w, seed=seed)
    jcfg, tcfg = JConfig(height=h, width=w), MaskRefinerConfig(height=h, width=w)
    jmap = JDT.PackedMapper(JTrainConfig(), jcfg, n_slots=n_slots)
    tmap = TDT.PackedMapper(TrainConfig(), tcfg, n_slots=n_slots)
    return (np.stack([jmap(r)["packed"] for r in recs]),
            np.stack([tmap(r)["packed"] for r in recs]), recs)


@pytest.mark.parametrize("n_slots", [3, 8, 12])
def test_pack_and_unpack_match_jax(n_slots):
    """Packing is byte for byte the reference's (more masks than slots are
    truncated); unpacking returns its image, stacks and validity bits."""
    h, w = 40, 48
    jbufs, tbufs, recs = _packed_pair(h, w, n_slots, seed=4)
    np.testing.assert_array_equal(tbufs, jbufs)
    assert tbufs.shape[1] == TDT.sample_bytes(h, w, n_slots) == JDT.sample_bytes(h, w, n_slots)
    image, gt, gv, pert, pv = TDT.unpack_train_sample(torch.from_numpy(tbufs), h, w, n_slots)
    assert image.shape == (2, 6, h, w) and gt.shape == pert.shape == (2, n_slots, h, w)
    for i in range(2):
        want = JDT.unpack_train_sample(jnp.asarray(jbufs[i]), h, w, n_slots)
        np.testing.assert_array_equal(_first(image[i].numpy()), np.asarray(want[0]))
        for got, wnt in zip((gt, gv, pert, pv), want[1:]):
            assert got.dtype == torch.bool
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(wnt))
        count = min(len(recs[i]["gt_masks"]), n_slots)
        np.testing.assert_array_equal(gt[i, :count].numpy(), recs[i]["gt_masks"][:count] > 0)
        assert int(gv[i].sum()) == count
    one = TDT.unpack_train_sample(torch.from_numpy(tbufs[1]), h, w, n_slots)
    assert all(torch.equal(a, b[1]) for a, b in zip(one, (image, gt, gv, pert, pv)))


def test_pack_rejects_what_cannot_be_bitpacked(tmp_path):
    with pytest.raises(ValueError):
        TDT.pack_train_sample(np.zeros((5, 5, 3)), np.zeros((5, 5)), [], [], 4)
    with pytest.raises(ValueError):
        TDT.unpack_train_sample(torch.zeros(2, 100, dtype=torch.uint8), 8, 8, 4)
    # file records are read since the file-backed slice; a JPEG still waits
    jpeg = tmp_path / "a.jpg"
    jpeg.write_bytes(b"\xff\xd8\xff\xe0" + bytes(64))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TDT.PackedMapper(TrainConfig(), MaskRefinerConfig(), 4)({"file_name": str(jpeg)})


@pytest.mark.parametrize("error_type,h,w", [("e2", 64, 64), ("e3", 120, 160)])
def test_build_targets_matches_jax_field_by_field(error_type, h, w):
    n_slots = 8
    jbufs, tbufs, _ = _packed_pair(h, w, n_slots, seed=5)
    jcfg = JConfig(height=h, width=w, error_type=error_type)
    tcfg = MaskRefinerConfig(height=h, width=w, error_type=error_type)
    _, gt, gv, pert, pv = TDT.unpack_train_sample(torch.from_numpy(tbufs), h, w, n_slots)
    got = TDT.build_targets(gt, gv, pert, pv, tcfg, TrainConfig())
    for i in range(len(jbufs)):
        _, *stacks = JDT.unpack_train_sample(jnp.asarray(jbufs[i]), h, w, n_slots)
        want = JDT.build_targets(*stacks, jcfg, JTrainConfig())
        assert set(got) == set(want)
        for key, tol in TOLERANCES:
            g = got[key][i].numpy()
            _assert_field(key, tol, _first(g) if g.ndim == 3 else g, np.asarray(want[key]))


def test_device_pool_draws_every_scene_once_an_epoch():
    packed = np.arange(6, dtype=np.uint8)[:, None].repeat(4, axis=1)
    pool = TDT.DevicePool(packed, batch_size=4, seed=7, device="cpu")
    drawn = torch.cat([pool.next_batch()[:, 0] for _ in range(3)]).tolist()  # two epochs
    assert sorted(drawn[:6]) == sorted(drawn[6:]) == list(range(6))
    again = TDT.DevicePool(packed, batch_size=4, seed=7, device="cpu")
    assert torch.cat([again.next_batch()[:, 0] for _ in range(3)]).tolist() == drawn
    # the order is that of the reference's loop: RandomState(seed).shuffle per epoch
    order = np.arange(6)
    np.random.RandomState(7).shuffle(order)
    assert drawn[:6] == order.tolist()


def test_batch_iterator_matches_jax():
    recs = TSyn.synthetic_records(5, 32, 32, seed=6)
    mapper = TDT.PackedMapper(TrainConfig(), MaskRefinerConfig(height=32, width=32), 4)
    ours = TMap.batch_iterator(recs, mapper, 2, seed=3)
    ref = JMap.batch_iterator(recs, mapper, 2, seed=3)
    for _ in range(4):
        np.testing.assert_array_equal(next(ours)["packed"], next(ref)["packed"])

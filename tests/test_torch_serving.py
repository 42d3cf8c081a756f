"""Batched and streamed serving and the multi-scale predictor: the port
against quber_tpu.

Same seeded synthetic frames through quber_tpu's MaskRefinerPredictor (XLA
path on the CPU) and the port's (device="cpu"), with the depth-14, 64x96
random-init config and decisive heads of test_torch_predictor.py, and
fast_top_k = 45: the first batch of two holds a frame with 42 centre
survivors and one with 48, so it spills to K = top_k batch-wide, and the
second batch (42, padded with a copy of itself) takes the fast path.
Tolerances, as in test_torch_predictor.py: instance counts equal; panoptic
labels equal on >= 99.9% of pixels, since a pixel whose two nearest centres
are within float rounding of each other may go either way; scores rtol
1e-3 (float32 summation order through the network).
"""

import threading

import cv2
import jax
import numpy as np
import pytest
import torch

from quber_tpu.models.mask_refiner import MaskRefinerConfig as JConfig
from quber_tpu.predictor import MaskRefinerPredictor as JPredictor
from quber_tpu.predictor import MultiScalePredictor as JMultiScale
from quber_tpu_torch.data.mappers import resize
from quber_tpu_torch.data.synthetic import blob_scene
from quber_tpu_torch.models.mask_refiner import MaskRefinerConfig as TConfig
from quber_tpu_torch.ops import kernels as TK
from quber_tpu_torch.predictor import MaskRefinerPredictor as TPredictor
from quber_tpu_torch.predictor import MultiScalePredictor as TMultiScale
from quber_tpu_torch.predictor import _images

CFG = dict(height=64, width=96, resnet_depth=14, min_instance_area=64, stuff_area=256,
           fast_top_k=45)
# seeds of blob_scene frames whose centre survivors number 42, 48 and 36
SEEDS = (22, 20, 24)


def _frame(seed, h=64, w=96):
    rng = np.random.RandomState(seed)
    return blob_scene(rng, h, w, rng.randint(2, 6))


@pytest.fixture(scope="module")
def params():
    jp = JPredictor(JConfig(**CFG), seed=3)
    params = jax.tree.map(np.asarray, jp.params)
    head = params["params"]["ins_embed_head"]
    rng = np.random.RandomState(5)
    # decisive random heads: foreground on, and a centre map with peaks
    head["foreground_predictor"]["bias"] = head["foreground_predictor"]["bias"] + 4.0
    k = head["center_predictor"]["kernel"]
    head["center_predictor"]["kernel"] = (rng.randn(*k.shape) * 0.5).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def pair(params):
    return JPredictor(JConfig(**CFG), params), TPredictor(TConfig(**CFG), params, device="cpu")


@pytest.fixture(scope="module")
def frames():
    return [_frame(s) for s in SEEDS]


@pytest.fixture(scope="module")
def jax_stream(pair, frames):
    jp, _ = pair
    return list(jp.predict_batch_stream(iter(frames), batch_size=2, use_rle=False,
                                        input_rle=False, prefetch=0))


def _assert_same(got, want):
    assert len(got) == len(want)
    for i, ((gp, gc, gs), (wp, wc, ws)) in enumerate(zip(got, want)):
        assert gp.shape == wp.shape and gp.dtype == np.int32, i
        assert gs.shape == ws.shape and gs.dtype == np.float32, i
        assert gc == wc, i
        assert (gp == wp).mean() >= 0.999, i
        np.testing.assert_allclose(gs, ws, rtol=1e-3, atol=1e-6, err_msg=str(i))


def test_predict_batch_matches_jax(pair, frames):
    jp, tp = pair
    want = jp.predict_batch(frames[:2])
    TK.reset_launch_counts()
    got = tp.predict_batch(frames[:2])
    _assert_same(got, want)
    assert all(c > 0 for _, c, _ in got)
    assert TK.encode_initial_masks_batched.launches == 0  # the CPU runs no kernel


@pytest.mark.parametrize("path", ["stream_prefetch0", "stream_prefetch2", "staged"])
def test_batch_streams_match_jax(pair, frames, jax_stream, path):
    _, tp = pair
    if path == "staged":
        got = list(tp.predict_batch_stream_staged(tp.stage_frames(frames, batch_size=2)))
    else:
        prefetch = int(path[-1])
        got = list(tp.predict_batch_stream(iter(frames), batch_size=2, prefetch=prefetch))
    _assert_same(got, jax_stream)


def test_predict_stream_matches_jax(pair, frames, jax_stream):
    _, tp = pair
    _assert_same(list(tp.predict_stream(iter(frames))), jax_stream)


def test_batch_wide_spill_matches_jax(pair, frames, jax_stream):
    """One crowded frame sends its whole batch to K = top_k; the other batch
    groups at K = fast_top_k. Both give the reference's outputs."""
    _, tp = pair
    fk = tp.config.fast_top_k
    ks = []
    for batch in (frames[:2], frames[2:] * 2):
        (img4, masks, valid), _ = tp._assemble(batch, 2)
        with torch.inference_mode():
            pre = tp._pre_batch(_images(img4), masks, valid)
        survivors = pre["centers_valid"].sum(dim=1).tolist()
        ks.append((survivors, tp._batch_k(pre["centers_valid"])))
    (first, k_first), (second, k_second) = ks
    assert min(first) <= fk < max(first) and k_first == tp.config.top_k_instances
    assert max(second) <= fk and k_second == fk
    got = list(tp.predict_batch_stream(iter(frames), batch_size=2, prefetch=0))
    _assert_same(got, jax_stream)
    for _, count, scores in got:
        assert scores.shape == (tp.config.top_k_instances + 2,)
        assert not scores[count + 1:].any()


def test_stream_consumes_frames_lazily_on_a_producer_thread(pair, frames):
    _, tp = pair
    pulled = []

    def source():
        for f in frames:
            pulled.append(threading.get_ident())
            yield f

    out = list(tp.predict_batch_stream(source(), batch_size=2, prefetch=2))
    assert len(out) == len(frames)
    assert len(pulled) == len(frames)
    assert threading.get_ident() not in pulled


def test_producer_error_reaches_the_caller(pair, frames):
    _, tp = pair

    def source():
        yield frames[0]
        raise RuntimeError("unreadable frame")

    with pytest.raises(RuntimeError, match="unreadable frame"):
        list(tp.predict_batch_stream(source(), batch_size=1, prefetch=2))


def test_abandoned_stream_stops_its_producer(pair, frames):
    _, tp = pair
    before = threading.active_count()

    def endless():
        while True:
            yield frames[0]

    gen = tp.predict_batch_stream(endless(), batch_size=1, prefetch=2)
    next(gen)
    assert threading.active_count() == before + 1
    gen.close()
    assert threading.active_count() == before


def test_serving_rejects_a_frame_of_another_size(pair):
    _, tp = pair
    with pytest.raises(ValueError, match="64x96"):
        tp.predict_batch([_frame(1, 48, 96)])


@pytest.mark.parametrize("h0, w0", [(80, 120), (64, 96)])
def test_multiscale_predictor_matches_jax(params, h0, w0):
    base = dict(CFG, height=64, width=96)
    jms = JMultiScale(JConfig(**base), params=params, short=64, max_size=96, max_instances=8)
    tms = TMultiScale(TConfig(**base), params=params, short=64, max_size=96,
                      max_instances=8, device="cpu")
    rgb, depth, masks = _frame(40 + h0, h0, w0)
    want = jms.predict(rgb, depth, masks)[0]
    got = tms.predict(rgb, depth, masks)[0]
    assert got.keys() == want.keys()
    assert got["panoptic_seg"][0].shape == (h0, w0)
    assert (got["panoptic_seg"][0] == want["panoptic_seg"][0]).mean() >= 0.999
    for k in ("sem_seg", "eee_mask", "eee_boundary"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-3, err_msg=k)
    assert len(got["instances"]["scores"]) == len(want["instances"]["scores"]) > 0
    assert tms.num_buckets == 1  # both sizes land in the base bucket


def test_multiscale_buckets_share_one_module(params):
    tms = TMultiScale(TConfig(**CFG), params=params, short=64, max_size=96, device="cpu")
    a = tms._predictor_for(64, 96)
    b = tms._predictor_for(96, 64)
    assert tms.num_buckets == 2
    assert a.model is b.model
    assert (b.config.height, b.config.width) == (96, 64)


@pytest.mark.parametrize("interp", ["linear", "nearest"])
@pytest.mark.parametrize("src, dst, channels", [
    ((80, 120), (64, 96), 3), ((360, 480), (480, 640), 3), ((64, 96), (80, 120), 2),
    ((33, 41), (64, 96), None)])
def test_resize_matches_cv2(interp, src, dst, channels):
    """torch resize against cv2.resize on float32. Nearest is exact; linear
    within 1e-4 of the 0-255 value range (OpenCV rounds its interpolation
    weights otherwise than torch)."""
    rng = np.random.RandomState(sum(src) + sum(dst))
    shape = src if channels is None else (*src, channels)
    img = (rng.rand(*shape) * 255).astype(np.float32)
    flag = {"linear": cv2.INTER_LINEAR, "nearest": cv2.INTER_NEAREST}[interp]
    want = cv2.resize(img, (dst[1], dst[0]), interpolation=flag)
    got = resize(img, dst, interp)
    assert got.shape == want.shape and got.dtype == np.float32
    atol = 0.0 if interp == "nearest" else 255 * 1e-4
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)

"""Mesh serving of the port (predictor.predict_batch_stream(mesh=) and
predict_batch_stream_staged(mesh=)) with two CPU replicas, against the
port's predict_batch and against the JAX package's sharded stream
(predict_batch_stream(..., input_rle=False, use_rle=False, mesh=) over a
2-device virtual mesh).

tests/test_torch_serving.py's depth-14, 64x96 random-init config with
decisive heads and its three frames, in a batch of 4 (padded with the first
frame) over the two replicas. Against predict_batch on each replica's
sub-batch: panoptic maps, counts and scores exactly (the same
computation); against predict_batch on the whole batch, whose convolutions
run at another batch size: counts and maps exactly, scores rtol 1e-4
and atol 1e-5.
Against JAX: test_torch_serving.py's tolerances (counts equal, labels on
>= 99.9% of pixels, scores rtol 1e-3), with 1e-4 absolute beside it: on the
port's seeded weights a score of 0.0139 reads 2.1e-5 off (float32 through
the network), where the largest scores are ~3.
"""

import jax
import numpy as np
import pytest
import torch

from quber_tpu.models.mask_refiner import MaskRefinerConfig as JConfig
from quber_tpu.parallel.mesh import make_mesh as jax_mesh
from quber_tpu.predictor import MaskRefinerPredictor as JPredictor
from quber_tpu_torch.data.synthetic import blob_scene
from quber_tpu_torch.models.from_jax import state_dict_to_jax
from quber_tpu_torch.models.mask_refiner import MaskRefinerConfig as TConfig
from quber_tpu_torch.parallel.mesh import make_mesh
from quber_tpu_torch.predictor import MaskRefinerPredictor as TPredictor

CFG = dict(height=64, width=96, resnet_depth=14, min_instance_area=64, stuff_area=256,
           fast_top_k=45)
SEEDS = (22, 20, 24)  # tests/test_torch_serving.py's frames
BATCH = 4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _frame(seed, h=64, w=96):
    rng = np.random.RandomState(seed)
    return blob_scene(rng, h, w, rng.randint(2, 6))


@pytest.fixture(scope="module")
def setup():
    """The port's seeded predictor with decisive heads (foreground on, a
    centre map with peaks), the same weights in the JAX package's, the
    frames and predict_batch's outputs batch by batch."""
    tp = TPredictor(TConfig(**CFG), device="cpu", seed=3)
    rng = np.random.RandomState(5)
    head = tp.model.ins_embed_head
    with torch.no_grad():
        head.foreground_predictor.bias += 4.0
        w = head.center_predictor.weight
        w.copy_(torch.from_numpy((rng.randn(*w.shape) * 0.5).astype(np.float32)))
    frames = [_frame(s) for s in SEEDS]
    padded = frames + [frames[0]] * (BATCH - len(frames))
    half = BATCH // 2
    want = (tp.predict_batch(padded[:half]) + tp.predict_batch(padded[half:]))[:len(frames)]
    whole = tp.predict_batch(padded)[:len(frames)]
    assert all(c > 0 for _, c, _ in want)
    for (wp, wc, ws), (gp, gc, gs) in zip(want, whole):
        assert gc == wc and np.array_equal(gp, wp)
        np.testing.assert_allclose(gs, ws, rtol=1e-4, atol=1e-5)
    return tp, state_dict_to_jax(tp.model), frames, want


def _assert_equal(got, want):
    assert len(got) == len(want)
    for i, ((gp, gc, gs), (wp, wc, ws)) in enumerate(zip(got, want)):
        assert gc == wc and np.array_equal(gp, wp) and np.array_equal(gs, ws), i


@pytest.mark.parametrize("path", ["stream_prefetch0", "stream_prefetch2", "staged"])
def test_mesh_serving_equals_predict_batch(setup, path):
    tp, _, frames, want = setup
    mesh = make_mesh(["cpu", "cpu"])
    if path == "staged":
        staged = tp.stage_frames(frames, BATCH, mesh=mesh)
        assert [len(parts) for parts, _ in staged] == [2]
        assert [real for _, real in staged] == [3]
        got = list(tp.predict_batch_stream_staged(staged, mesh=mesh))
    else:
        got = list(tp.predict_batch_stream(iter(frames), BATCH, prefetch=int(path[-1]),
                                           mesh=mesh))
    _assert_equal(got, want)
    replicas = tp._replicas(mesh)
    assert len(replicas) == 2 and replicas[0].model is not replicas[1].model
    assert replicas[0].model is not tp.model


def test_mesh_serving_matches_jax_sharded_stream(setup):
    tp, params, frames, _ = setup
    jp = JPredictor(JConfig(**CFG), params)
    want = list(jp.predict_batch_stream(iter(frames), batch_size=BATCH, use_rle=False,
                                        input_rle=False, prefetch=0,
                                        mesh=jax_mesh(jax.devices()[:2])))
    got = list(tp.predict_batch_stream(iter(frames), BATCH, prefetch=0,
                                       mesh=make_mesh(["cpu", "cpu"])))
    assert len(got) == len(want)
    for i, ((gp, gc, gs), (wp, wc, ws)) in enumerate(zip(got, want)):
        assert gc == wc, i
        assert (gp == wp).mean() >= 0.999, i
        np.testing.assert_allclose(gs, ws, rtol=1e-3, atol=1e-4, err_msg=str(i))


def test_batch_size_must_divide_over_the_mesh(setup):
    tp, _, frames, _ = setup
    mesh = make_mesh(["cpu", "cpu"])
    with pytest.raises(ValueError, match="divide"):
        next(tp.predict_batch_stream(iter(frames), 3, mesh=mesh))
    tp.predict_batch_stream(iter(frames), 3, mesh=mesh).close()  # a generator not run
    staged = tp.stage_frames(frames, BATCH)  # staged without the mesh
    with pytest.raises(ValueError, match="staged for this mesh"):
        list(tp.predict_batch_stream_staged(staged, mesh=mesh))

"""The open-vocabulary evaluation wrappers of the port (DeticBaseModel and
GroundedSAMBaseModel in models/open_vocab.py, built by their names) against
the JAX package's on two written 480x640 frames.

`detic` is the port's seeded init (no $QUBER_DETIC_CKPT) with its RPN and
box deltas zeroed in both copies (the init's deltas clip every box to no
area, and a mask is pasted only inside its box); `grounded-sam`
a seeded init with a small SAM (64x64 frames, two blocks 32 wide) saved as
train_zoo_torch saves it and read through $QUBER_GSAM_CKPT with its
arch.json. The JAX wrappers take the same weights (state_dict_to_jax).
Both run float32 (the JAX wrappers' modules cloned to float32 before their
first call, the port's set by layers.set_compute_dtype): bfloat16 has no
single reference. The masks: the same count, at least half of them with a
pixel, and >= 99.5% of the pixels' labels equal; the JAX pipeline is jitted, which
fixes its bilinear resize's weights as layers.resize_bilinear computes
them. SAM's 512x512 frame (OpenCV's float32 bilinear of the RGB) equals
cv2's. The port reads the frames without OpenCV; the reference with it.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quber_tpu.models import open_vocab as JO
from quber_tpu_torch.evaluation import base_models as tbase
from quber_tpu_torch.evaluation.harness import masks_to_label_image
from quber_tpu_torch.models import open_vocab as TO
from quber_tpu_torch.models.from_jax import state_dict_to_jax
from quber_tpu_torch.models.layers import set_compute_dtype

AGREEMENT = 0.995
SAM_ARCH = dict(img_size=64, embed_dim=32, depth=2, num_heads=2, global_blocks=(1,),
                window_size=2)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    from quber_tpu_torch.data.make_synthetic_dataset import main as make_dataset
    from quber_tpu_torch.evaluation.datasets import build_file_lists

    root = str(tmp_path_factory.mktemp("osd"))
    make_dataset(["--out", root, "--n", "2", "--seed", "1003", "--depth-range", "250", "1500"])
    rgb, depth, _ = build_file_lists("OSD", root)
    return list(zip(rgb, depth))


def _labels(masks):
    return masks_to_label_image(np.asarray(masks), np.zeros((480, 640), np.int32))


def _agree(port, ref, frames):
    for rgb, depth in frames:
        want, got = ref.predict(rgb, depth), port.predict(rgb, depth)
        assert len(got[0]) == len(want[0]) and len(want[0]) > 0, (len(got[0]), len(want[0]))
        assert sum(m.any() for m in want[0]) >= len(want[0]) // 2
        agree = (_labels(got[0]) == _labels(want[0])).mean()
        assert agree >= AGREEMENT, (os.path.basename(rgb), agree)
        assert got[1] is None and got[2] > 0


def test_detic_by_name(frames, monkeypatch):
    monkeypatch.delenv("QUBER_DETIC_CKPT", raising=False)
    port = tbase.build_base_model("detic", "OSD", device="cpu")
    assert port.vocabulary == TO.VOCABULARIES["OSD"] and port.confidence_threshold == 0.5
    assert port.detector.dtype == torch.bfloat16
    seeded = TO.DeticBaseModel(device="cpu", seed=0)
    assert all(torch.equal(v, seeded.detector.state_dict()[k])
               for k, v in port.detector.state_dict().items())
    with torch.no_grad():  # boxes that are their anchors (see the docstring)
        for layer in (port.detector.rpn.deltas, port.detector.box_deltas):
            layer.weight.zero_()
            layer.bias.zero_()
    ref = JO.DeticBaseModel(params={"text": state_dict_to_jax(port.text_encoder),
                                    "detector": state_dict_to_jax(port.detector)})
    ref.detector = ref.detector.clone(dtype=jnp.float32)
    set_compute_dtype(port.detector, torch.float32)
    _agree(port, ref, frames)


def test_grounded_sam_by_name(frames, tmp_path, monkeypatch):
    from quber_tpu_torch.train.checkpoint import save_params

    made = TO.GroundedSAMBaseModel(device="cpu", seed=5, sam_arch=SAM_ARCH)
    tree = {"text": state_dict_to_jax(made.text_encoder),
            "grounder": state_dict_to_jax(made.grounder), "sam": state_dict_to_jax(made.sam)}
    save_params(str(tmp_path / "ckpt"), tree, step=3)
    arch = dict(SAM_ARCH, global_blocks=list(SAM_ARCH["global_blocks"]))
    (tmp_path / "arch.json").write_text(json.dumps(arch))
    monkeypatch.setenv("QUBER_GSAM_CKPT", str(tmp_path / "ckpt"))
    port = tbase.build_base_model("grounded-sam", "OSD", device="cpu")
    assert port.sam_size == 64 and port.box_threshold == 0.10
    assert port.grounder.max_detections == 16
    ref = JO.GroundedSAMBaseModel(params=tree, sam_arch=arch)
    ref.grounder = ref.grounder.clone(dtype=jnp.float32)
    ref.sam = ref.sam.clone(dtype=jnp.float32)
    set_compute_dtype(port.grounder, torch.float32)
    set_compute_dtype(port.sam, torch.float32)
    _agree(port, ref, frames)


def test_sam_frame_equals_cv2(frames):
    cv2 = pytest.importorskip("cv2")
    from quber_tpu.models.sam_refiner import SAM_PIXEL_MEAN, SAM_PIXEL_STD
    from quber_tpu_torch.models.sam_refiner import read_bgr

    for rgb, _ in frames:
        bgr = cv2.resize(cv2.imread(rgb), (640, 480)).astype(np.float32)
        np.testing.assert_array_equal(read_bgr(rgb), bgr.astype(np.uint8))
        want = (cv2.resize(bgr[..., ::-1], (512, 512)) - SAM_PIXEL_MEAN) / SAM_PIXEL_STD
        np.testing.assert_array_equal(TO.sam_frame(bgr, 512), want)


def test_low_res_masks_resize_as_the_jitted_reference():
    """GroundedSAM's 128x128 HQ logits (SAM at 512) to 480x640:
    layers.resize_bilinear against the jitted jax.image.resize, whose
    weights the compilation fixes."""
    import jax

    from quber_tpu_torch.models.layers import resize_bilinear

    logits = np.random.RandomState(2).randn(3, 128, 128).astype(np.float32) * 4
    want = np.asarray(jax.jit(lambda x: jax.image.resize(x, (3, 480, 640), "bilinear"))(logits))
    got = resize_bilinear(torch.from_numpy(logits), (480, 640)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    assert ((got > 0) == (want > 0)).mean() >= 0.99999

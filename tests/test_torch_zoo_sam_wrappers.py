"""The SAM wrappers of the port (models/sam_refiner.py) against the JAX
package's (quber_tpu/models/sam_refiner.py) on written 480x640 frames, and
the five evaluation names on the CPU.

Both sides share one tiny model's weights (init_sam_variables with every
leaf moved by seeded noise, carried over by models/from_jax) and run it in
float32: the JAX wrappers' model is cloned to float32 before its first
call, the port's set by layers.set_compute_dtype (bfloat16 has no single
reference; tests/test_torch_zoo_sam.py holds it). The port reads frames
without OpenCV: its uint8 and float32 bilinear resizes and nearest resize
equal cv2's here, so the labels must agree on >= 99.9% of the pixels
(a logit within float32 noise of 0 may flip) and the mask counts exactly;
the automatic generator keeps the same masks in the same order (at this
init 3 and 7 of its 64 points pass the 0.5 IoU threshold on the two
frames, so the threshold is exercised too). Every compared output holds a
pixel.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quber_tpu.models import sam_hq as J
from quber_tpu.models import sam_refiner as JR
from quber_tpu_torch.evaluation import base_models as tbase
from quber_tpu_torch.evaluation import refiner_models as tref
from quber_tpu_torch.evaluation.harness import masks_to_label_image
from quber_tpu_torch.models import sam_hq as T
from quber_tpu_torch.models import sam_refiner as TR
from quber_tpu_torch.models.from_jax import state_dict_from_jax, state_dict_to_jax
from quber_tpu_torch.models.layers import set_compute_dtype

AGREEMENT = 0.999
REFINER = dict(img_size=64, embed_dim=32, depth=3, num_heads=2, global_blocks=(1,),
               window_size=3)
AUTO = dict(img_size=64, embed_dim=32, depth=3, num_heads=2)  # its window 14 pads 4 to 14


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _variables(name, seed):
    """{"refiner": REFINER, "auto": AUTO}[name]'s init_sam_variables tree,
    every leaf moved by N(0, 0.05^2) (made once; the tests do not write to
    it)."""
    cfg = {"refiner": REFINER, "auto": AUTO}[name]
    v = jax.jit(lambda k: J.init_sam_variables(J.SAMHQ(**cfg), k))(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.randn(*a.shape)).astype(np.float32),
                        v)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    from quber_tpu_torch.data.make_synthetic_dataset import main as make_dataset
    from quber_tpu_torch.evaluation.base_models import GT
    from quber_tpu_torch.evaluation.datasets import build_file_lists

    root = str(tmp_path_factory.mktemp("osd"))
    make_dataset(["--out", root, "--n", "2", "--seed", "1001", "--depth-range", "250", "1500"])
    rgb, depth, _ = build_file_lists("OSD", root)
    return [(r, d, GT().predict(r, d)[0]) for r, d in zip(rgb, depth)]


def _labels(masks):
    return masks_to_label_image(np.asarray(masks), np.zeros((480, 640), np.int32))


def _same_masks(got, want, what):
    assert len(got) == len(want) and len(want) > 0, (what, len(got), len(want))
    assert all(m.any() for m in want), what
    agree = (_labels(got) == _labels(want)).mean()
    assert agree >= AGREEMENT, (what, agree)


@pytest.mark.parametrize("hq", [True, False])
def test_refiner_matches_jax_wrapper(frames, hq):
    v = _variables("refiner", 0)
    jw = JR.SAMHQRefiner(params=v, hq=hq, **REFINER)
    jw.model = jw.model.clone(dtype=jnp.float32)
    tw = TR.SAMHQRefiner(params=v, hq=hq, device="cpu", **REFINER)
    set_compute_dtype(tw.model, torch.float32)
    for rgb, depth, gt in frames:
        # more masks than the 16 slots: the 17th on is left out by both
        initial = np.concatenate([gt] * 3)
        want = jw.predict(rgb, depth, initial, None)
        got = tw.predict(rgb, depth, initial, None)
        _same_masks(got[0], want[0], f"hq={hq} {os.path.basename(rgb)}")
        assert got[1] is None and got[3] is None and got[2] > 0


@pytest.mark.parametrize("depth_input", [False, True])
def test_automatic_generator_matches_jax_wrapper(frames, depth_input):
    v = _variables("auto", 1)
    jw = JR.SAMAutomaticBaseModel(params=v, depth_input=depth_input, **AUTO)
    jw.model = jw.model.clone(dtype=jnp.float32)
    tw = TR.SAMAutomaticBaseModel(params=v, depth_input=depth_input, device="cpu", **AUTO)
    set_compute_dtype(tw.model, torch.float32)
    # the depth frame's Telea inpainting takes ~1 s a read: one frame
    for rgb, depth, _ in frames[:1] if depth_input else frames:
        want = jw.predict(rgb, depth)
        got = tw.predict(rgb, depth)
        _same_masks(got[0], want[0], f"depth_input={depth_input} {os.path.basename(rgb)}")
        assert len(want[0]) < 64  # some point failed the IoU threshold or NMS
        for a, b in zip(got[0], want[0]):  # the same order
            assert (a == b).mean() >= AGREEMENT
        assert got[1] is None and got[2] > 0


def test_the_five_names_build_their_models(monkeypatch):
    made = []

    class Recording(T.SAMHQ):
        @classmethod
        def preset(cls, name, img_size=1024):
            made.append((name, img_size))
            return cls(**REFINER)  # the ViT-H's 636M weights are not built here

    for name, hq in (("sam", False), ("hq-sam", True)):
        r = tref.build_refiner_model(name, "OSD", device="cpu")
        assert isinstance(r, TR.SAMHQRefiner) and r.hq is hq and r.img_size == 1024
        enc = r.model.image_encoder
        assert (enc.patch_embed.out_channels, enc.depth, enc.global_blocks) == \
            (768, 12, (2, 5, 8, 11))
        assert r.model.image_encoder.block_0.attn.num_heads == 12
        assert next(r.model.parameters()).dtype == torch.float32
        assert r.model.mask_decoder.up_0.compute_dtype == torch.bfloat16
    monkeypatch.setattr(TR, "SAMHQ", Recording)
    r = tref.build_refiner_model("hq-sam-pretrained", "OSD", device="cpu")
    assert made == [("vit_h", 1024)] and r.hq
    for name in ("sam", "sam-depth"):
        b = tbase.build_base_model(name, "OSD", device="cpu")
        assert isinstance(b, TR.SAMAutomaticBaseModel)
        assert b.depth_input is (name == "sam-depth") and b.img_size == 512
        assert b.points.shape == (64, 2)


def test_samhq_checkpoint_with_arch_json(tmp_path, monkeypatch):
    """$QUBER_SAMHQ_CKPT: a save_params directory and the arch.json beside
    it rebuild the trained architecture with its weights."""
    from quber_tpu_torch.train.checkpoint import save_params

    arch = dict(REFINER, global_blocks=list(REFINER["global_blocks"]))
    (tmp_path / "arch.json").write_text(json.dumps(arch))
    model = T.SAMHQ(**REFINER)
    model.reset_parameters(torch.Generator().manual_seed(3))
    save_params(str(tmp_path / "ckpt"), state_dict_to_jax(model), step=5)
    monkeypatch.setenv("QUBER_SAMHQ_CKPT", str(tmp_path / "ckpt"))
    r = tref.build_refiner_model("hq-sam", "OSD", device="cpu")
    assert r.hq and r.img_size == REFINER["img_size"]
    assert r.model.image_encoder.global_blocks == REFINER["global_blocks"]
    want = model.state_dict()
    got = r.model.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    # the checkpoint is for hq-sam; sam keeps its ViT-B init
    assert tref.build_refiner_model("sam", "OSD", device="cpu").img_size == 1024


def test_weights_in_both_layouts_load_alike():
    v = _variables("refiner", 0)
    a = TR.SAMHQRefiner(params=v, device="cpu", **REFINER).model.state_dict()
    b = TR.SAMHQRefiner(params=state_dict_from_jax(v), device="cpu", **REFINER).model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)

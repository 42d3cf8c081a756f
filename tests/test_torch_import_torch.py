"""The port's detectron2 MaskRefiner importer and exporter
(quber_tpu_torch/models/import_torch.py) against the JAX package's
(quber_tpu/models/import_torch.py).

The in-repo int8 flagship exported by the JAX package gives the exact key
and byte layout of a reference checkpoint; every config under configs/ is
checked from a seeded state dict (every tensor random, variances positive).
Tolerance: none, every tensor bit for bit. Where the JAX package refuses a
config (its exporter reads two trunks; the single-trunk ablation has one),
the port refuses it with the same error.
"""

import glob
import os

import numpy as np
import pytest
import torch

from quber_tpu.config import load_config as jax_load_config
from quber_tpu.models import import_torch as JIT
from quber_tpu.train.checkpoint import load_quantized_params as jax_load_quantized
from quber_tpu_torch.config import load_config
from quber_tpu_torch.models import import_torch as TIT
from quber_tpu_torch.models.from_jax import state_dict_from_jax, state_dict_to_jax
from quber_tpu_torch.models.mask_refiner import MaskRefiner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHIVE = os.path.join(ROOT, "weights", "flagship_synth_int8.npz")
CONFIGS = sorted(os.path.relpath(p, ROOT) for p in
                 glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"), recursive=True))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def archive():
    """(the archive's tree, its JAX export in the detectron2 layout)."""
    tree = jax_load_quantized(ARCHIVE)
    return tree, JIT.export_mask_refiner(tree)


def _equal_state_dicts(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else np.asarray(got[k])
        w = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        assert g.dtype == np.float32 and g.shape == w.shape, k
        assert np.array_equal(g, w), k


def test_import_of_the_flagship_export(archive):
    tree, sd = archive
    assert any(k.startswith("backbone.depth_backbone.depth_res2") for k in sd)
    assert "backbone.depth_backbone.stem.conv1.weight" in sd
    got = TIT.import_mask_refiner(sd)
    assert len(got) == 749
    _equal_state_dicts(got, state_dict_from_jax(tree))
    MaskRefiner().load_state_dict(got, strict=True)


def test_export_of_the_flagship_equals_jax(archive):
    tree, sd = archive
    _equal_state_dicts(TIT.export_mask_refiner(state_dict_from_jax(tree)), sd)


def _seeded_model(cfg, seed):
    model = MaskRefiner(cfg)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            t.copy_(0.5 + torch.rand(t.shape, generator=g) if name.endswith("running_var")
                    else torch.randn(t.shape, generator=g))
    return model


_MODELS: dict = {}


@pytest.mark.parametrize("path", CONFIGS)
def test_every_config_against_jax(path, archive):
    cfg = load_config(os.path.join(ROOT, path))[0]
    jcfg = jax_load_config(os.path.join(ROOT, path))[0]
    # configs that differ only outside the model (seeds, training) share one
    if repr(cfg) not in _MODELS:
        model = _seeded_model(cfg, seed=len(_MODELS))
        _MODELS[repr(cfg)] = model, state_dict_to_jax(model)
    model, tree = _MODELS[repr(cfg)]
    try:
        want = JIT.export_mask_refiner(tree, jcfg)
    except KeyError:
        with pytest.raises(KeyError):
            TIT.export_mask_refiner(model.state_dict(), cfg)
        assert not cfg.depth_on or not cfg.rgb_on  # refused only for a single trunk
        want = archive[1]  # import a two-trunk checkpoint with this config, as JAX does
    else:
        _equal_state_dicts(TIT.export_mask_refiner(model.state_dict(), cfg), want)
    _equal_state_dicts(TIT.import_mask_refiner(want, cfg),
                       state_dict_from_jax(JIT.import_mask_refiner(want, jcfg)))
    if cfg.rgb_on and cfg.depth_on:
        model.load_state_dict(TIT.import_mask_refiner(want, cfg), strict=True)


def test_extra_keys_are_ignored_and_missing_keys_raise(archive):
    _, sd = archive
    extra = dict(sd)
    extra["pixel_mean"] = np.zeros((6, 1, 1), np.float32)
    extra["pixel_std"] = np.ones((6, 1, 1), np.float32)
    extra["backbone.rgb_backbone.stem.conv1.norm.num_batches_tracked"] = np.zeros((), np.int64)
    _equal_state_dicts(TIT.import_mask_refiner(extra), TIT.import_mask_refiner(sd))
    for key in ("backbone.depth_backbone.depth_res5.2.conv2.norm.running_var",
                "ins_embed_head.fusion_layers_4.fusion_layers.3.bias",
                "ins_embed_head.decoder.res5.project_conv.convs.4.1.bias"):
        missing = {k: v for k, v in sd.items() if k != key}
        with pytest.raises(KeyError):
            JIT.import_mask_refiner(missing)
        with pytest.raises(KeyError):
            TIT.import_mask_refiner(missing)


@pytest.mark.parametrize("wrap", ["model", "state_dict", None])
def test_load_torch_checkpoint(tmp_path, wrap):
    g = torch.Generator().manual_seed(3)
    sd = {"a.weight": torch.randn(4, 3, 3, 3, generator=g), "b.bias": torch.randn(4, generator=g)}
    path = str(tmp_path / "ckpt.pth")
    torch.save({wrap: sd, "iteration": 7} if wrap else sd, path)
    got, want = TIT.load_torch_checkpoint(path), JIT.load_torch_checkpoint(path)
    assert set(got) == set(want) == set(sd)
    for k, v in sd.items():
        assert isinstance(got[k], np.ndarray) and np.array_equal(got[k], want[k])
        assert np.array_equal(got[k], v.numpy())

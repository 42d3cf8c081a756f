"""The port's config readers against quber_tpu/config.py: ablation-grid
names (those of tests/test_data.py) and a detectron2-format YAML decode to
the same dataclass values in both packages, and the CLIs take both.
Tolerance: equal fields.
"""

import dataclasses

import numpy as np
import pytest

from quber_tpu import config as JC
from quber_tpu_torch import config as TC

GRID_NAMES = [
    "mask_refiner_rgbd_concat_l2_gn_hf_m_b_f_c_o_l3_e2_b8",
    "mask-refiner-rgbd-concat-l2-gn-hf-fco-m-b-l3-e2-b8",
    "mask-refiner-rgbd-concat-l2-gn-hf-f-c-o-l3-e2-b8",
    "mask_refiner_rgbd_concat_l2_b2",
    "mask_refiner_rgbd_add_l3",
    "mask_refiner_rgb_only",
    "mask_refiner_depth_only",
    "mask-refiner-rgbd-add-l3-b2.yaml",
    "mask_refiner_rgbd_concat_l2_bn_hf_m_b_f_c_o_l3_e3_b4_augmented",
]

DETECTRON2_YAML = """\
_BASE_: base.yaml
INPUT:
  DEPTH_RANGE: [250, 1500]
  MIN_SIZE_TRAIN: [384, 416, 448, 480]
  MAX_SIZE_TRAIN: 640
  COLOR_AUG_SSD: false
MODEL:
  BACKBONE:
    FUSION_STRATEGY: add
    NUM_FUSION_LAYERS: 3
    FREEZE_AT: 2
  INS_EMBED_HEAD:
    HIERARCHY: [[foreground, center, offset], [eee_mask], [eee_boundary]]
    ERROR_TYPE: e3
    NUM_FUSION_LAYERS: 2
    CENTER_LOSS_WEIGHT: 100.0
  PANOPTIC_DEEPLAB:
    TOP_K_INSTANCE: 100
SOLVER:
  IMS_PER_BATCH: 4
  BASE_LR: 0.0002
  MAX_ITER: 1234
SEED: 11
"""
DETECTRON2_BASE = """\
MODEL:
  INS_EMBED_HEAD:
    ASPP_DROPOUT: 0.0
    NORM: BN
  RESNETS:
    NORM: FrozenBN
INPUT:
  PERLIN_DISTORTION_ON: false
"""


def _same(got, want):
    for g, w in zip(got, want):
        assert dataclasses.asdict(g) == dataclasses.asdict(w)


@pytest.mark.parametrize("name", GRID_NAMES)
def test_grid_names_decode_as_in_jax(name):
    _same(TC.load_config(name), JC.load_config(name))
    stem = name.removesuffix(".yaml").replace("-", "_")
    _same(TC.config_from_name(stem), JC.config_from_name(stem))


def test_unknown_paths_still_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        TC.load_config(str(tmp_path / "no_such_config.yaml"))
    with pytest.raises(ValueError):
        TC.config_from_name("mask_refiner_rgbd_bogus")


@pytest.fixture
def detectron2_yaml(tmp_path):
    (tmp_path / "base.yaml").write_text(DETECTRON2_BASE)
    path = tmp_path / "mask-refiner-custom.yaml"
    path.write_text(DETECTRON2_YAML)
    return str(path)


def test_detectron2_yaml_as_in_jax(detectron2_yaml, monkeypatch):
    # quber_tpu/config.py's from_detectron2_yaml calls np.atleast_1d without
    # importing numpy; the reference is run with the name supplied
    monkeypatch.setattr(JC, "np", np, raising=False)
    got = TC.from_detectron2_yaml(detectron2_yaml)
    _same(got, JC.from_detectron2_yaml(detectron2_yaml))
    _same(TC.load_any_config(detectron2_yaml), got)
    assert got[0].fusion_strategy == "add" and got[0].norm == "BN"
    assert got[1].min_size_train == (384, 416, 448, 480) and got[1].seed == 11


@pytest.mark.parametrize("which", ["grid", "detectron2"])
def test_the_clis_take_grid_names_and_detectron2_yaml(which, detectron2_yaml, monkeypatch,
                                                      tmp_path):
    import run_eval_torch
    import train_net_torch

    from quber_tpu_torch.evaluation import harness

    path = detectron2_yaml if which == "detectron2" else "mask_refiner_rgbd_add_l3_b2"
    want = TC.load_any_config(path)
    seen = {}

    def fake_run_eval(**kwargs):
        seen["config"] = kwargs["config"]
        return {"seconds": {}}

    monkeypatch.setattr(harness, "run_eval", fake_run_eval)
    run_eval_torch.main(["--config-file", path, "--device", "cpu", "--dataset-path",
                         str(tmp_path), "--csv", str(tmp_path / "x.csv")])
    assert seen["config"] == want[0]

    from quber_tpu_torch.train import loop

    def stop(model_cfg, train_cfg, device="cuda", **kw):
        seen["train"] = (model_cfg, train_cfg)
        raise SystemExit(0)

    monkeypatch.setattr(loop, "create_train_state", stop)
    with pytest.raises(SystemExit):
        train_net_torch.main(["--config-file", path, "--device", "cpu", "--synthetic",
                              "--synthetic-size", "1", "--height", "32", "--width", "32",
                              "--output-dir", str(tmp_path / "out")])
    model_cfg, train_cfg = seen["train"]
    assert dataclasses.replace(model_cfg, height=want[0].height,
                               width=want[0].width) == want[0]
    assert train_cfg == want[1]

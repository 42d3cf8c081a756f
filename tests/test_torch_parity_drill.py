"""The port's activation-parity tool and parity drill
(quber_tpu_torch/tools/activation_parity.py, parity_drill.py), on the CPU.

The tool's stages must all match (3e-4 of each stage's peak, the JAX tool's
float32 tolerance) on a seeded init at 64x64, and the port's activations at
those stages must match the JAX package's (tools/activation_parity.py's
flax_activations, the JAX MaskRefiner on the same weights) within the same
tolerance; a weight changed in the port's model alone must show from its
stage on. The drill runs end to end on a full-scale flagship checkpoint
(a seeded init of the port exported to the detectron2 layout: the layout a
real checkpoint has) at a small evaluation size with two rendered frames,
and fails when its tolerance is 0.
"""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from quber_tpu_torch.config import load_config
from quber_tpu_torch.models.import_torch import import_mask_refiner
from quber_tpu_torch.models.mask_refiner import MaskRefiner
from quber_tpu_torch.tools import FLAGSHIP_CONFIG
from quber_tpu_torch.tools import activation_parity as AP
from quber_tpu_torch.tools import parity_drill

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(h, w, seed=0):
    rng = np.random.RandomState(seed)
    return ((rng.rand(1, h, w, 6) * 255).astype(np.float32),
            rng.rand(1, h, w, 3).astype(np.float32))


def test_activation_parity_all_stages(tmp_path):
    out = tmp_path / "report.json"
    assert AP.main(["--random", "--height", "64", "--width", "64", "--device", "cpu",
                    "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["n_mismatched"] == 0, report["stages"]
    assert report["n_stages"] >= 20
    assert {"rgb_stem", "depth_res5", "fused_res2", "aspp", "decoder", "eee_mask_feat",
            "offset_logit"} <= set(report["stages"])


def test_port_stages_match_the_jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_activation_parity", os.path.join(ROOT, "tools", "activation_parity.py"))
    jap = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jap)
    from quber_tpu.config import load_config as jax_load_config
    from quber_tpu.models.import_torch import import_mask_refiner as jax_import

    cfg = dataclasses.replace(load_config(FLAGSHIP_CONFIG)[0], height=64, width=64)
    jcfg = dataclasses.replace(jax_load_config(FLAGSHIP_CONFIG)[0], height=64, width=64)
    sd = {k: v.numpy() for k, v in AP.random_state_dict(cfg, seed=4).items()}
    images, offset = _inputs(64, 64, seed=4)
    model = MaskRefiner(cfg)
    model.load_state_dict(import_mask_refiner(sd, cfg), strict=True)
    port = AP.port_activations(model, torch.from_numpy(images.transpose(0, 3, 1, 2)),
                               torch.from_numpy(offset.transpose(0, 3, 1, 2)))
    flax = jap.flax_activations(jax_import(sd, jcfg), jcfg, images, offset)
    report = jap.compare(port, flax, 3e-4)
    assert len(report) >= 20 and set(report) == set(flax)
    assert all(v["status"] == "ok" for v in report.values()), report


def test_a_changed_weight_shows_from_its_stage_on():
    cfg = dataclasses.replace(load_config(FLAGSHIP_CONFIG)[0], height=64, width=64)
    sd = AP.random_state_dict(cfg, seed=2)
    images, offset = _inputs(64, 64)
    x = torch.from_numpy(images.transpose(0, 3, 1, 2))
    enc = torch.from_numpy(offset.transpose(0, 3, 1, 2))
    ref = AP.TorchRef(sd, cfg)
    with torch.no_grad():
        ref.forward(x, enc)
    port = import_mask_refiner(sd, cfg)
    port["backbone.depth_trunk.res3_0.conv2.conv.weight"] *= 1.5
    model = MaskRefiner(cfg)
    model.load_state_dict(port, strict=True)
    report = AP.compare(ref.acts, AP.port_activations(model, x, enc), 3e-4)
    bad = {k for k, v in report.items() if v["status"] != "ok"}
    assert {"depth_res3", "depth_res4", "depth_res5", "fused_res3", "decoder"} <= bad
    assert not bad & {"rgb_stem", "rgb_res5", "depth_stem", "depth_res2", "fused_res2"}


@pytest.fixture(scope="module")
def flagship_pth(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("drill") / "model_final.pth")
    torch.save(AP.random_state_dict(load_config(FLAGSHIP_CONFIG)[0], seed=0), path)
    return path


@pytest.mark.parametrize("atol", [3e-4, 0.0])
def test_parity_drill_end_to_end(tmp_path, flagship_pth, atol):
    out = tmp_path / "report.json"
    rc = parity_drill.main(["--torch", flagship_pth, "--device", "cpu", "--parity-size", "64",
                            "64", "--eval-size", "120", "160", "--synthetic-n", "2", "--limit",
                            "2", "--workdir", str(tmp_path / "work"), "--out", str(out),
                            "--atol", str(atol)])
    report = json.loads(out.read_text())
    assert report["import"]["n_params"] > 50_000_000  # the full-scale flagship
    assert report["parity"]["n_stages"] >= 20
    if atol == 0.0:  # float32 sums in another order: some stage is off by a rounding
        assert rc == 1 and not report["ok"] and report["parity"]["n_mismatched"] > 0
        return
    assert rc == 0 and report["ok"] and report["parity"]["n_mismatched"] == 0
    assert report["eval"]["base_model"] == "perturbed-gt"
    for stage in ("initial", "refined"):
        assert 0.0 < report["eval"][stage]["Objects F-measure"] <= 100.0
    assert report["eval"]["avg_refine_ms"] > 0

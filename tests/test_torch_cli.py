"""The port's single-image and demo CLIs against the JAX package's, and the
assembly of bench_torch.py's JSON line, on the CPU.

predict_torch.py and demo_torch.py read one written 480x640 frame (OpenCV's
resizes and Telea inpainting, equal in the port), refine it with the same
weights at a small config, and must give predict.py's and demo.py's instance
count, the same overlay image, pixel for pixel, and the scores (centre
heatmap values) within 1e-5 of their largest magnitude: the two frameworks'
float32 convolutions sum in different orders.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from quber_tpu.models.mask_refiner import MaskRefinerConfig as JConfig
from quber_tpu.predictor import MaskRefinerPredictor as JPredictor
from quber_tpu_torch.data import png
from quber_tpu_torch.data.make_synthetic_dataset import main as make_dataset
from quber_tpu_torch.evaluation.base_models import PerturbedGT
from quber_tpu_torch.predictor import MaskRefinerPredictor as TPredictor
from quber_tpu_torch.train.checkpoint import save_quantized_params

torch.set_num_threads(2)

CFG = dict(height=96, width=128, resnet_depth=14, min_instance_area=64, stuff_area=256)
SCORES_SHARE = 1e-5


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """One OSD frame, its perturbed GT masks, a small config and random
    weights with decisive heads (as in test_torch_eval.py) in an
    unquantised .npz."""
    tmp = tmp_path_factory.mktemp("cli")
    root = str(tmp / "osd")
    make_dataset(["--out", root, "--n", "1", "--dropout-frac", "0.0005"])
    rgb = os.path.join(root, "image_color", sorted(os.listdir(os.path.join(root,
                                                                           "image_color")))[0])
    depth = rgb.replace("image_color", "disparity")
    np.save(tmp / "masks.npy", PerturbedGT("OSD").predict(rgb, depth)[0].astype(np.uint8))
    params = jax.tree.map(np.asarray, JPredictor(JConfig(**CFG), seed=3).params)
    head = params["params"]["ins_embed_head"]
    head["foreground_predictor"]["bias"] = head["foreground_predictor"]["bias"] + 4.0
    k = head["center_predictor"]["kernel"]
    head["center_predictor"]["kernel"] = (np.random.RandomState(5).randn(*k.shape) * 0.5
                                          ).astype(np.float32)
    save_quantized_params(str(tmp / "w.npz"), params, min_quant_size=1 << 40)
    cfg = tmp / "small.yaml"
    cfg.write_text("model:\n" + "".join(f"  {k}: {v}\n" for k, v in CFG.items()))
    return {"tmp": tmp, "root": root, "rgb": rgb, "depth": depth, "cfg": str(cfg),
            "weights": str(tmp / "w.npz")}


def _record(monkeypatch, cls, name, calls):
    original = getattr(cls, name)

    def recording(self, *args, **kwargs):
        out = original(self, *args, **kwargs)
        calls.append(out)
        return out

    monkeypatch.setattr(cls, name, recording)


def test_predict_torch_matches_predict(setup, monkeypatch, capsys):
    import predict
    import predict_torch
    import quber_tpu.profiling

    monkeypatch.setattr(quber_tpu.profiling, "enable_compilation_cache", lambda: None)
    common = ["--rgb", setup["rgb"], "--depth", setup["depth"],
              "--masks", str(setup["tmp"] / "masks.npy"), "--config-file", setup["cfg"],
              "--weights", setup["weights"]]
    jcalls, tcalls = [], []
    _record(monkeypatch, JPredictor, "predict_packed", jcalls)
    _record(monkeypatch, TPredictor, "predict", tcalls)
    monkeypatch.setattr("sys.argv", ["predict.py", *common, "--out",
                                     str(setup["tmp"] / "jax.png")])
    predict.main()
    want_out = capsys.readouterr().out
    assert predict_torch.main(common + ["--out", str(setup["tmp"] / "port.png"),
                                        "--device", "cpu"]) == 0
    got_out = capsys.readouterr().out
    _, count, scores = jcalls[0]
    got = tcalls[0][0]
    got_scores = got["instances"]["scores"] if "instances" in got else np.zeros(0)
    assert count > 0 and len(got_scores) == count
    want = scores[1:count + 1]
    np.testing.assert_allclose(got_scores, want, rtol=0,
                               atol=SCORES_SHARE * float(np.abs(want).max()))
    assert want_out.split(";")[0] == got_out.split(";")[0]  # "refined N -> C instances"
    assert np.array_equal(png.imread(str(setup["tmp"] / "port.png")),
                          png.imread(str(setup["tmp"] / "jax.png")))


def test_demo_torch_matches_demo(setup, monkeypatch, capsys):
    import demo
    import demo_torch
    import quber_tpu.profiling

    monkeypatch.setattr(quber_tpu.profiling, "enable_compilation_cache", lambda: None)
    common = ["--input", os.path.join(setup["root"], "image_color", "*.png"),
              "--depth-dir", os.path.join(setup["root"], "disparity"),
              "--config-file", setup["cfg"], "--weights", setup["weights"]]
    monkeypatch.setattr("sys.argv", ["demo.py", *common, "--output",
                                     str(setup["tmp"] / "jax_vis")])
    demo.main()
    want = capsys.readouterr().out.splitlines()
    assert demo_torch.main(common + ["--output", str(setup["tmp"] / "port_vis"),
                                     "--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    name = os.path.basename(setup["rgb"])
    assert len(got) == len(want) == 1 and got[0].split(" -> ")[0] == want[0].split(" -> ")[0]
    assert int(got[0].split(": ")[1].split()[0]) > 0
    assert np.array_equal(png.imread(str(setup["tmp"] / "port_vis" / name)),
                          png.imread(str(setup["tmp"] / "jax_vis" / name)))


def test_clis_refuse_without_a_card(setup):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    import bench_torch
    import demo_torch
    import predict_torch

    assert predict_torch.main(["--rgb", setup["rgb"], "--masks", "x.npy"]) == 2
    assert demo_torch.main(["--input", "*.png"]) == 2
    assert bench_torch.main([]) == 2


def test_bench_torch_json_line():
    """The JSON line from toy rates: every field bench_torch.py reports, the
    gaps, the bound and the bottleneck as the docstring defines them."""
    import bench_torch

    line = bench_torch.summarise(
        fps=50.0, fps_default=40.0, fps_k200_n24=45.0, fps_k24_n64=48.0, fps_float32=20.0,
        streaming=[30.0, 35.0, 32.0], pack_ms=10.0, h2d_ms=2.0, flops=400 * 10**9,
        weights="trained-int8", device="toy", power_limit_w=700.0, frames=4, batch_size=16,
        trials=[49.0, 50.0, 51.0], render_s=1.0)
    line = json.loads(json.dumps(line))
    for key in ("metric", "value", "unit", "weights", "device", "power_limit_w",
                "fps_default_config", "fps_k200_n24", "fps_k24_n64", "gap_topk_ms",
                "gap_slots_ms", "fps_float32", "flops_forward", "mfu_forward", "peak_tflops",
                "streaming_fps", "streaming_trials", "pack_ms", "h2d_ms_fenced",
                "compute_drain_ms", "pipeline_bound_fps", "pipeline_efficiency",
                "bottleneck"):
        assert key in line, key
    for key in ("wire_kb_per_frame", "link_mbps_fenced", "h2d_streams", "use_rle"):
        assert key not in line
    assert line["value"] == 50.0 and line["streaming_fps"] == 32.0
    assert line["gap_topk_ms"] == round(1e3 / 45 - 1e3 / 50, 3)
    assert line["compute_drain_ms"] == 20.0 and line["bottleneck"] == "compute_drain"
    assert line["pipeline_bound_fps"] == 50.0 and line["pipeline_efficiency"] == 0.7
    assert line["mfu_forward"] == round(400e9 * 50 / 989e12, 4)


def test_bench_torch_frames_and_flops():
    """The benchmark's scenes are bench.py's (the same renderer and seed),
    and the FLOP count is that of the configured forward, whatever its
    precision."""
    import bench_torch
    from quber_tpu.data.synthetic import render_scene
    from quber_tpu.ops.preprocess import normalize_depth
    from quber_tpu_torch.models.mask_refiner import MaskRefinerConfig

    frames = bench_torch.render_frames(2)
    rng = np.random.RandomState(7)
    for rgb, depth, masks in frames:
        want_rgb, depth_mm, want_masks = render_scene(rng, 480, 640, (250.0, 1500.0))
        assert np.array_equal(rgb, want_rgb) and len(masks) == len(want_masks)
        assert np.array_equal(depth, normalize_depth(depth_mm)[..., 0])
    counts = [bench_torch.forward_flops(TPredictor(MaskRefinerConfig(**CFG, dtype=dtype),
                                                   device="cpu"))
              for dtype in ("float32", "bfloat16")]
    assert counts[0] == counts[1] > 10**9

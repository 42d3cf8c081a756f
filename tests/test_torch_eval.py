"""The port's evaluation path against the JAX package's: dataset walkers and
writer, annotation loading, the GT and perturbed-GT base models, the QuBER
refiner wrapper (per image and streamed) and run_eval, on small temporary
datasets written by both packages' generators.

Tolerances: walkers, written arrays, annotations, GT and PerturbedGT masks
exact (the false-positive ellipse is cv2.ellipse's rasterisation); refined
frames the same instance count and >= 99.5% of the labels (the same inputs,
the bilinear resize to the model's size being OpenCV's bit for bit; the
two frameworks' float32 convolutions sum in different orders); run_eval's
initial-stage aggregates exact, the refined ones within 0.01.
"""

import csv
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from quber_tpu.evaluation import base_models as jbase
from quber_tpu.evaluation import datasets as jdata
from quber_tpu.evaluation import harness as jharness
from quber_tpu.evaluation import refiner_models as jref
from quber_tpu.models.mask_refiner import MaskRefinerConfig as JConfig
from quber_tpu.predictor import MaskRefinerPredictor as JPredictor
from quber_tpu_torch.data import png
from quber_tpu_torch.data.make_synthetic_dataset import main as make_dataset
from quber_tpu_torch.evaluation import base_models as tbase
from quber_tpu_torch.evaluation import datasets as tdata
from quber_tpu_torch.evaluation import harness as tharness
from quber_tpu_torch.evaluation import refiner_models as tref
from quber_tpu_torch.models.mask_refiner import MaskRefinerConfig as TConfig
from quber_tpu_torch.ops.preprocess import resize_nearest

torch.set_num_threads(2)

_TOOL = os.path.join(os.path.dirname(__file__), "..", "tools", "make_synthetic_dataset.py")
_spec = importlib.util.spec_from_file_location("jax_make_synthetic_dataset", _TOOL)
jtool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jtool)

LAYOUTS = {"osd": "OSD", "ocid": "OCID", "wisdom": "WISDOM", "hope": "HOPE", "dopose": "DoPose"}
# 96x128 is 480x640 cut by five: the bilinear resize to the model's size
# then picks source pixels exactly, in OpenCV and in the port
CFG = dict(height=96, width=128, resnet_depth=14, min_instance_area=64, stuff_area=256)


def _write(make, root, layout, n, h=48, w=64, *extra):
    make(["--out", root, "--layout", layout, "--n", str(n), "--height", str(h),
          "--width", str(w), *extra])
    return root


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Per layout: (tree written by the JAX tool, tree written by the port)."""
    base = tmp_path_factory.mktemp("layouts")
    return {layout: (_write(jtool.main, str(base / f"jax_{layout}"), layout, 3),
                     _write(make_dataset, str(base / f"port_{layout}"), layout, 3))
            for layout in LAYOUTS}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_walkers_match_jax(trees, layout):
    root = trees[layout][0]
    got = tdata.build_file_lists(LAYOUTS[layout], root)
    assert got == jdata.build_file_lists(LAYOUTS[layout], root)
    assert len(got[0]) == 3


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_dataset_writer_matches_jax_tool(trees, layout):
    import imageio.v2 as imageio

    jroot, troot = trees[layout]
    names = sorted(os.path.relpath(os.path.join(d, f), jroot)
                   for d, _, fs in os.walk(jroot) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(d, f), troot)
                           for d, _, fs in os.walk(troot) for f in fs)
    for name in names:
        a, b = os.path.join(jroot, name), os.path.join(troot, name)
        if name.endswith(".npy"):
            want, got = np.load(a), np.load(b)
        else:
            want, got = np.asarray(imageio.imread(a)), png.imread(b)
        assert got.dtype == want.dtype and np.array_equal(got, want), name


@pytest.mark.parametrize("layout", ["osd", "ocid", "wisdom"])
def test_annotations_and_gt_match_jax(trees, layout):
    dataset = LAYOUTS[layout]
    rgb, depth, anno = jdata.build_file_lists(dataset, trees[layout][0])
    for r, d, a in zip(rgb, depth, anno):
        want = jdata.load_annotation(a, dataset, r)
        got = tdata.load_annotation(a, dataset, r)
        assert got.shape == (480, 640) and np.array_equal(got, want)
        gm, _, _ = tbase.GT(dataset).predict(r, d)
        wm, _, _ = jbase.GT(dataset).predict(r, d)
        assert np.array_equal(gm, wm)


@pytest.fixture(scope="module")
def osd6(tmp_path_factory):
    """Six frames at the evaluation size (no resize before the model's), with
    a quarter of the protocol's depth dropout to keep the inpainting short."""
    return _write(jtool.main, str(tmp_path_factory.mktemp("osd6") / "osd"), "osd", 6,
                  480, 640, "--dropout-frac", "0.0005")


def test_perturbed_gt_matches_jax(osd6):
    rgb, depth, _ = jdata.build_file_lists("OSD", osd6)
    tb, jb = tbase.PerturbedGT("OSD"), jbase.PerturbedGT("OSD")
    for r, d in zip(rgb, depth):
        got, _, _ = tb.predict(r, d)
        want, _, _ = jb.predict(r, d)
        assert len(got) == len(want)
        assert np.array_equal(got > 0, want > 0)


@pytest.fixture(scope="module")
def params():
    """Random depth-14 weights with decisive heads (as in
    test_torch_predictor.py), so the refiner keeps instances."""
    jp = JPredictor(JConfig(**CFG), seed=3)
    params = jax.tree.map(np.asarray, jp.params)
    head = params["params"]["ins_embed_head"]
    rng = np.random.RandomState(5)
    head["foreground_predictor"]["bias"] = head["foreground_predictor"]["bias"] + 4.0
    k = head["center_predictor"]["kernel"]
    head["center_predictor"]["kernel"] = (rng.randn(*k.shape) * 0.5).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def refiners(params):
    return (jref.QuBERRefiner(JConfig(**CFG), params, use_fg_filter=False),
            tref.QuBERRefiner(TConfig(**CFG), params, use_fg_filter=False, device="cpu"))


def _labels(masks):
    return tharness.masks_to_label_image(masks, np.zeros((480, 640), np.int32))


def _items(root, dataset="OSD"):
    rgb, depth, _ = jdata.build_file_lists(dataset, root)
    base = jbase.PerturbedGT(dataset)
    return [(r, d, base.predict(r, d)[0], None) for r, d in zip(rgb, depth)]


def _same_frames(got, want):
    for (g, w) in zip(got, want):
        assert len(g) == len(w)
        assert (_labels(g) == _labels(w)).mean() >= 0.995


def test_quber_refiner_per_image_matches_jax(refiners, osd6):
    jr, tr = refiners
    items = _items(osd6)[:3]
    want = [jr.predict(*item)[0] for item in items]
    got = [tr.predict(*item)[0] for item in items]
    assert sum(len(g) for g in got) > 0
    _same_frames(got, want)
    assert tr.seconds["read"] > 0 and tr.seconds["refine"] > 0


def test_quber_refiner_streamed_matches_jax(refiners, osd6):
    jr, tr = refiners
    items = _items(osd6)
    want = [out[0] for out in jr.predict_stream(iter(items), batch_size=4)]
    got = [out[0] for out in tr.predict_stream(iter(items), batch_size=4)]
    assert len(got) == len(want) == 6
    _same_frames(got, want)


@pytest.mark.parametrize("fg_model", ["lmffnet", "cgnet"])
def test_quber_refiner_fg_filter_matches_jax(params, osd6, fg_model, monkeypatch):
    """With the foreground filter (JAX random-init nets carried across): the
    same foreground and refined masks as the JAX refiner; LMFFNet takes the
    frame the refiner read at 640x480, CGNet reads its own at 320x240."""
    from quber_tpu_torch.models import fg_predictor as tfg
    from quber_tpu_torch.ops import preprocess as tpre

    jr = jref.QuBERRefiner(JConfig(**CFG), params, fg_model=fg_model)
    tr = tref.QuBERRefiner(TConfig(**CFG), params, fg_params=jr.fg_predictor.variables,
                           fg_model=fg_model, device="cpu")
    sizes = []

    def counted(rgb_path, depth_path, size):
        sizes.append(size)
        return tpre.load_rgbd(rgb_path, depth_path, size)

    monkeypatch.setattr(tref, "load_rgbd", counted)
    monkeypatch.setattr(tfg, "load_rgbd", counted)
    items = _items(osd6)[:2]
    for item in items:
        got, want = tr.predict(*item), jr.predict(*item)
        assert got[3].shape == (480, 640) and got[3].dtype == bool
        assert (got[3] == want[3]).mean() >= 0.999
        _same_frames([got[0]], [want[0]])
    per_frame = [(480, 640)] if fg_model == "lmffnet" else [(480, 640), (240, 320)]
    assert sizes == per_frame * len(items)


def test_outputs_default_under_output_dir():
    """Run with its defaults from the repo root, the harness and the CLI
    write under the gitignored output/, never beside the committed
    time_*.json and eval_*.csv."""
    import inspect

    spec = importlib.util.spec_from_file_location(
        "run_eval_torch", os.path.join(os.path.dirname(__file__), "..", "run_eval_torch.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    parser_defaults = {a.dest: a.default for a in cli.build_parser()._actions}
    defaults = inspect.signature(tharness.run_eval).parameters
    for path in (defaults["csv_path"].default, defaults["vis_dir"].default,
                 parser_defaults["csv"], parser_defaults["vis_dir"]):
        assert path.split("/")[0] == "output", path


def test_quber_refiner_zeroes_ocid_zero_depth(params, tmp_path):
    """On OCID the refined masks lose the pixels of zero depth."""
    jr = jref.QuBERRefiner(JConfig(**CFG), params, dataset="OCID", use_fg_filter=False)
    tr = tref.QuBERRefiner(TConfig(**CFG), params, dataset="OCID", use_fg_filter=False,
                           device="cpu")
    root = _write(jtool.main, str(tmp_path / "ocid"), "ocid", 2, 480, 640,
                  "--dropout-frac", "0.0005")
    items = _items(root, "OCID")
    got = [tr.predict(*item)[0] for item in items]
    _same_frames(got, [jr.predict(*item)[0] for item in items])
    for (r, d, _, _), masks in zip(items, got):
        zero = resize_nearest(png.imread(d) == 0, (480, 640))
        assert not (masks & zero[None]).any()


def _run(harness, refiner, root, dataset, base, csv_path, batch=0):
    return harness.run_eval(base_model=base, refiner_model=refiner, test_dataset=dataset,
                            dataset_path=root, csv_path=csv_path, refine_batch=batch,
                            limit=3)


@pytest.mark.parametrize("case", ["osd-perturbed-maskrefiner", "osd-streamed",
                                  "ocid-gt-identity", "wisdom-structural-identity"])
def test_run_eval_matches_jax(case, refiners, osd6, trees, tmp_path):
    jr, tr = refiners
    if case.startswith("osd"):
        root, dataset, base = osd6, "OSD", "perturbed-gt"
    elif case.startswith("ocid"):
        root, dataset, base, jr, tr = trees["ocid"][0], "OCID", "gt", "identity", "identity"
    else:
        root, dataset, base = trees["wisdom"][0], "WISDOM", "perturbed-gt-structural"
        jr = tr = "identity"
    batch = 2 if case == "osd-streamed" else 0
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    want = _run(jharness, jr, root, dataset, base, str(tmp_path / "j" / "x.csv"), batch)
    got = _run(tharness, tr, root, dataset, base, str(tmp_path / "t" / "x.csv"), batch)
    for stage, tol in (("initial", 0.0), ("refined", 0.01)):
        assert got[stage].keys() == want[stage].keys()
        for k, v in want[stage].items():
            assert abs(got[stage][k] - v) <= tol, (stage, k, got[stage][k], v)
    rows = [list(csv.DictReader(open(tmp_path / d / "x.csv"))) for d in ("j", "t")]
    assert list(rows[0][0]) == list(rows[1][0]) and len(rows[1]) == 2
    assert [r["tag"] for r in rows[1]] == [r["tag"] for r in rows[0]]
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    assert set(got["seconds"]) >= {"annotation", "base", "metrics"}


def test_fg_weights_from_npz_and_port_checkpoints(tmp_path):
    from quber_tpu_torch.train.checkpoint import save_params, save_quantized_params

    tree = {"params": {"a": {"kernel": np.ones((3, 3, 4, 8), np.float32)}},
            "batch_stats": {"bn": {"mean": np.zeros(8, np.float32)}}}
    save_quantized_params(str(tmp_path / "w.npz"), tree, min_quant_size=16)
    got = tref.load_fg_params(str(tmp_path / "w.npz"))
    np.testing.assert_allclose(got["params"]["a"]["kernel"], 1.0, rtol=1e-6)
    save_params(str(tmp_path / "ckpt"), tree)
    assert np.array_equal(tref.load_fg_params(str(tmp_path / "ckpt"))["batch_stats"]["bn"]["mean"],
                          np.zeros(8))
    (tmp_path / "orbax").mkdir()
    with pytest.raises(NotImplementedError, match="orbax"):
        tref.load_fg_params(str(tmp_path / "orbax"))


def test_cli_runs_on_the_cpu_and_refuses_without_a_card(osd6, tmp_path):
    import run_eval_torch

    cfg = tmp_path / "small.yaml"
    cfg.write_text("model:\n" + "".join(f"  {k}: {v}\n" for k, v in CFG.items()))
    argv = ["--config-file", str(cfg), "--base-model", "perturbed-gt", "--refiner-model",
            "maskrefiner", "--dataset-path", osd6, "--limit", "1",
            "--csv", str(tmp_path / "out" / "x.csv")]
    (tmp_path / "out").mkdir()
    if not torch.cuda.is_available():
        assert run_eval_torch.main(argv) != 0
    assert run_eval_torch.main(argv + ["--device", "cpu"]) == 0
    rows = list(csv.DictReader(open(tmp_path / "out" / "x.csv")))
    assert [r["tag"] for r in rows] == ["random-init|per-image|limit1"] * 2
    assert rows[0]["refiner"] == "QuBERRefiner"
    assert os.path.exists(tmp_path / "out" / "time_OSD_random-init_per-image_limit1.json")


def test_visualization_matches_jax(osd6, tmp_path):
    """The tiles (colour, GT, initial, refined) as cv2.imwrite writes them."""
    import imageio.v2 as imageio

    for harness, sub in ((jharness, "j"), (tharness, "t")):
        harness.run_eval(base_model="gt", refiner_model="identity", test_dataset="OSD",
                         dataset_path=osd6, limit=2, visualize=True,
                         vis_dir=str(tmp_path / sub / "vis"), csv_path=str(tmp_path / sub / "x.csv"))
    names = sorted(os.listdir(tmp_path / "j" / "vis" / "OSD"))
    assert names == sorted(os.listdir(tmp_path / "t" / "vis" / "OSD")) and len(names) == 2
    for name in names:
        want = np.asarray(imageio.imread(tmp_path / "j" / "vis" / "OSD" / name))
        got = png.imread(str(tmp_path / "t" / "vis" / "OSD" / name))
        assert got.shape == want.shape == (480, 4 * 640, 3) and np.array_equal(got, want)

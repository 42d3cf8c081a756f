"""The offline tools that make a refiner training set: the port's
Felzenszwalb segmentation, reference perturbation flow and its copies of
tools/detection2panoptic.py, tools/perturbate_masks.py (panoptic format)
and tools/panoptic2eee.py against the JAX package's on the same inputs.

Tolerances: Felzenszwalb labels equal up to renumbering; the perturbed
stacks, the JSON files the tools write and the panoptic PNGs' decoded
arrays equal.
"""

import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from quber_tpu_torch.data import detection2panoptic, panoptic2eee, perturbate_masks, png
from quber_tpu_torch.data.felzenszwalb import felzenszwalb, felzenszwalb_proposals
from quber_tpu_torch.data.make_synthetic_dataset import main as make_dataset
from quber_tpu_torch.data.make_uoais_sim import write_instances
from quber_tpu_torch.data.perturb import perturb_masks_reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def osd(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tools") / "osd")
    make_dataset(["--out", root, "--n", "3", "--height", "96", "--width", "128", "--seed", "5"])
    return root


def _canonical(labels):
    """Labels renumbered by first appearance in raster order."""
    _, first, inverse = np.unique(labels.ravel(), return_index=True, return_inverse=True)
    rank = np.argsort(np.argsort(first))
    return rank[inverse].reshape(labels.shape)


def _frames(osd):
    names = sorted(os.listdir(os.path.join(osd, "image_color")))
    return [(cv2.imread(os.path.join(osd, "image_color", n)),
             png.imread(os.path.join(osd, "annotation", n))) for n in names]


def test_felzenszwalb_labels_match(osd):
    from quber_tpu.data.felzenszwalb import felzenszwalb as jax_fz
    from quber_tpu.data.felzenszwalb import felzenszwalb_proposals as jax_props

    rng = np.random.RandomState(0)
    images = [img for img, _ in _frames(osd)]
    images.append(rng.randint(0, 256, (33, 45, 3), np.uint8))  # odd row length
    for img in images:
        for sigma, k, min_size in ((0.2, 50, 50), (0.8, 200, 20)):
            got = felzenszwalb(img[:40, :60], sigma=sigma, k=k, min_size=min_size)
            want = jax_fz(img[:40, :60], sigma=sigma, k=k, min_size=min_size)
            assert got.dtype == want.dtype and np.array_equal(_canonical(got), _canonical(want))
    for img, _ in _frames(osd):
        got, want = felzenszwalb_proposals(img), jax_props(img)
        assert got.shape == want.shape and np.array_equal(got, want)


def test_perturb_masks_reference_matches(osd):
    from quber_tpu.data.perturb import perturb_masks_reference as jax_perturb

    for i, (img, label) in enumerate(_frames(osd)):
        gt = np.asarray([(label == k) for k in np.unique(label[label > 0])], np.uint8)
        for seed in (i, i + 10):
            r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
            got, want = perturb_masks_reference(gt, img, r1), jax_perturb(gt, img, r2)
            assert got.shape == want.shape and np.array_equal(got, want)
            assert r1.rand() == r2.rand()


def _run_tool(script, *args):
    out = subprocess.run([sys.executable, os.path.join(ROOT, "tools", script), *args],
                         capture_output=True, text=True, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-3000:]


def _load(path):
    with open(path) as f:
        return json.load(f)


def test_the_three_tools_match(osd, tmp_path):
    split = str(tmp_path / "train")
    instances = str(tmp_path / "instances.json")
    with open(instances, "w") as f:
        json.dump(write_instances(osd, split), f)

    outs = {}
    for who in ("port", "tools"):
        d = tmp_path / who
        pan_json, pan_dir = str(d / "panoptic.json"), str(d / "pngs")
        pert_json, eee_json = str(d / "perturbed.json"), str(d / "eee.json")
        steps = [
            ("detection2panoptic", ["--json", instances, "--out-json", pan_json,
                                    "--out-dir", pan_dir]),
            ("perturbate_masks", ["--json", pan_json, "--panoptic-root", pan_dir,
                                  "--image-root", split, "--out", pert_json, "--seed", "3"]),
            ("panoptic2eee", ["--json", pert_json, "--panoptic-root", pan_dir,
                              "--out", eee_json]),
        ]
        os.makedirs(d, exist_ok=True)
        for name, args in steps:
            if who == "port":
                {"detection2panoptic": detection2panoptic, "perturbate_masks": perturbate_masks,
                 "panoptic2eee": panoptic2eee}[name].main(args)
            else:
                _run_tool(name + ".py", *args)
        outs[who] = (pan_json, pan_dir, pert_json, eee_json)

    (pj, pd, pp, pe), (tj, td, tp, te) = outs["port"], outs["tools"]
    assert _load(pj) == _load(tj)
    names = sorted(os.listdir(td))
    assert names == sorted(os.listdir(pd)) and len(names) == 3
    for n in names:
        assert np.array_equal(png.imread(os.path.join(pd, n)),
                              cv2.imread(os.path.join(td, n))[..., ::-1])
    perturbed = _load(pp)
    assert perturbed == _load(tp)
    assert all(img["perturbed_segmentation"] for img in perturbed["images"])
    final = _load(pe)
    assert final == _load(te)
    assert all("fn_boundary" in img for img in final["images"])


def test_image_free_fallback_and_unported_formats(osd, tmp_path):
    split = str(tmp_path / "train")
    instances = str(tmp_path / "instances.json")
    with open(instances, "w") as f:
        json.dump(write_instances(osd, split), f)
    pan_json, pan_dir = str(tmp_path / "pan.json"), str(tmp_path / "pngs")
    detection2panoptic.main(["--json", instances, "--out-json", pan_json, "--out-dir", pan_dir])
    got, want = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    perturbate_masks.main(["--json", pan_json, "--panoptic-root", pan_dir, "--out", got])
    _run_tool("perturbate_masks.py", "--json", pan_json, "--panoptic-root", pan_dir,
              "--out", want)
    assert _load(got) == _load(want)
    with pytest.raises(SystemExit):
        perturbate_masks.main(["--format", "coco", "--json", instances])
    coco = _load(instances)
    coco["annotations"][0]["segmentation"] = [[0, 0, 10, 0, 10, 10]]
    with open(instances, "w") as f:
        json.dump(coco, f)
    with pytest.raises(NotImplementedError, match="item 11d"):
        detection2panoptic.main(["--json", instances, "--out-json", pan_json,
                                 "--out-dir", pan_dir])

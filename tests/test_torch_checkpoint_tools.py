"""The port's checkpoint CLIs (quber_tpu_torch/tools/import_checkpoint.py and
quantize_checkpoint.py) against the JAX package's (tools/import_checkpoint.py,
tools/quantize_checkpoint.py), and their output where the port reads it.

The import CLI (run on the CPU) must write the tree that the JAX CLI's
`import_variables` builds from the same state dict, leaf for leaf and bit for
bit: for the MaskRefiner (the in-repo int8 flagship exported to the
detectron2 layout), CGNet, LMFFNet and UCN (the twins of
tests/reference_twins.py), UOIS-Net-3D's DSN and MSMFormer at
test widths (tests/test_torch_zoo_pretrained.py's twins). Its output loads
through $QUBER_WEIGHTS, $QUBER_CGNET_CKPT, $QUBER_LMFFNET_CKPT,
$QUBER_UCN_CKPT and $QUBER_UOIS_DSN_CKPT into the modules the wrappers build,
exactly. The archive exported to a .pth, imported and quantized again must
give weights/flagship_synth_int8.npz array for array, from the import CLI's
directory and from a training directory of the MaskRefiner.
"""

import importlib.util
import os
import types

import numpy as np
import pytest
import torch

from quber_tpu.config import load_config as jax_load_config
from quber_tpu.models.import_torch import export_mask_refiner as jax_export
from quber_tpu.models.import_torch import load_torch_checkpoint as jax_load_torch
from quber_tpu.train.checkpoint import load_quantized_params as jax_load_quantized
from quber_tpu_torch.evaluation import base_models as tbase
from quber_tpu_torch.evaluation import refiner_models as tref
from quber_tpu_torch.models.from_jax import state_dict_from_jax
from quber_tpu_torch.models.mask_refiner import MaskRefiner, MaskRefinerConfig
from quber_tpu_torch.predictor import MaskRefinerPredictor
from quber_tpu_torch.tools import FLAGSHIP_CONFIG
from quber_tpu_torch.tools import import_checkpoint as tic
from quber_tpu_torch.tools import quantize_checkpoint as tqc
from quber_tpu_torch.train import checkpoint as ckpt
from reference_twins import cgnet_twin, lmffnet_twin, seeded_state as _seeded, ucn_twin
from test_torch_zoo_pretrained import reference_msmformer_state, reference_uois_cascade_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHIVE = os.path.join(ROOT, "weights", "flagship_synth_int8.npz")


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_import_checkpoint", os.path.join(ROOT, "tools", "import_checkpoint.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def flagship_pth(tmp_path_factory):
    """The int8 flagship exported by the JAX package to a detectron2 .pth."""
    path = str(tmp_path_factory.mktemp("flagship") / "model_final.pth")
    sd = jax_export(jax_load_quantized(ARCHIVE))
    torch.save({"model": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}},
               path)
    return path


def _reference_state(model):
    """A state dict in the reference layout of `model`."""
    if model == "cgnet":
        return _seeded(cgnet_twin(), seed=1)
    if model == "lmffnet":
        return _seeded(lmffnet_twin(), seed=2)
    if model == "ucn":
        return _seeded(ucn_twin(embed=64), seed=3)
    if model == "msmformer":
        return reference_msmformer_state(seed=4)
    return reference_uois_cascade_state(model, seed=5)[0]["model"]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def _same_tree(got, want):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32 and got[k].shape == v.shape, k
        assert np.array_equal(got[k], v), k


def _import(tmp_path, model, path):
    out = str(tmp_path / model)
    assert tic.main(["--model", model, "--torch", path, "--out", out, "--device", "cpu"]) == 0
    return os.path.join(out, "ckpt")


@pytest.mark.parametrize("model", ["mask_refiner", "cgnet", "lmffnet", "ucn", "uois_dsn",
                                   "msmformer"])
def test_import_cli_writes_the_jax_tree(model, tmp_path, flagship_pth):
    if model == "mask_refiner":
        path = flagship_pth
    else:
        path = str(tmp_path / f"{model}.pth")
        torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in
                    _reference_state(model).items()}, path)
    out = _import(tmp_path, model, path)
    cfg = jax_load_config(FLAGSHIP_CONFIG)[0]
    want = _jax_cli().import_variables(model, jax_load_torch(path), cfg)
    _same_tree(ckpt.restore_params(out), want)


def test_imported_weights_load_where_the_port_reads_them(tmp_path, monkeypatch):
    paths = {}
    for model in ("cgnet", "lmffnet", "ucn", "uois_dsn"):
        sd = _reference_state(model)
        path = str(tmp_path / f"{model}.pth")
        torch.save({"model": {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}}, path)
        paths[model] = (_import(tmp_path, model, path), tic.import_state_dict(model, sd))

    def same(module, want):
        got = module.state_dict()
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want)

    for env, model in (("QUBER_CGNET_CKPT", "cgnet"), ("QUBER_LMFFNET_CKPT", "lmffnet")):
        monkeypatch.delenv("QUBER_CGNET_CKPT", raising=False)
        monkeypatch.delenv("QUBER_LMFFNET_CKPT", raising=False)
        monkeypatch.setenv(env, paths[model][0])
        refiner = tref.build_refiner_model("maskrefiner", "OSD", device="cpu")
        same(refiner.fg_predictor.model, paths[model][1])
    monkeypatch.setenv("QUBER_UCN_CKPT", paths["ucn"][0])
    same(tbase.build_base_model("ucn", "OSD", device="cpu").model, paths["ucn"][1])
    monkeypatch.setenv("QUBER_UOIS_DSN_CKPT", paths["uois_dsn"][0])
    monkeypatch.setenv("QUBER_UOIS_RRN_CKPT", str(tmp_path / "missing"))
    dsn = tbase.build_base_model("uoisnet3d-pretrained", "OSD", device="cpu").dsn
    same(dsn.float(), paths["uois_dsn"][1])


def test_imported_flagship_serves_like_the_archive(tmp_path, flagship_pth, monkeypatch):
    from quber_tpu_torch.data.synthetic import blob_scene

    out = _import(tmp_path, "mask_refiner", flagship_pth)
    monkeypatch.setenv("QUBER_WEIGHTS", out)
    imported = ckpt.load_default_params()
    archive = ckpt.load_quantized_params(ARCHIVE)
    cfg = MaskRefinerConfig(height=96, width=128)
    rng = np.random.RandomState(3)
    rgb, depth, masks = blob_scene(rng, 96, 128, 4)
    got = MaskRefinerPredictor(cfg, imported, device="cpu").predict(rgb, depth, list(masks))[0]
    want = MaskRefinerPredictor(cfg, archive, device="cpu").predict(rgb, depth, list(masks))[0]
    assert np.array_equal(got["panoptic_seg"][0], want["panoptic_seg"][0])
    assert np.array_equal(got["sem_seg"], want["sem_seg"])
    assert len(got["instances"]["scores"]) == len(want["instances"]["scores"]) > 0


def _same_archive(path):
    with np.load(ARCHIVE) as want, np.load(path) as got:
        assert sorted(got.files) == sorted(want.files) and len(want.files) == 902
        for k in want.files:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_export_import_quantize_round_trip(tmp_path, capsys):
    pth = str(tmp_path / "exported.pth")
    assert tic.main(["--export", ARCHIVE, "--out", pth, "--device", "cpu"]) == 0
    sd = torch.load(pth)
    want = jax_export(jax_load_quantized(ARCHIVE))
    assert set(sd) == set(want) and len(sd) == 749
    assert all(np.array_equal(sd[k].numpy(), want[k]) for k in want)
    out = _import(tmp_path, "mask_refiner", pth)
    npz = str(tmp_path / "re" / "flagship_int8.npz")
    assert tqc.main([out, npz, "--check", "--device", "cpu"]) == 0
    _same_archive(npz)
    assert "worst leaf" in capsys.readouterr().out


def test_quantize_a_training_directory(tmp_path):
    """A train_net_torch.py directory holds the torch state dict: quantized
    through the flax layout it gives the archive; quantized in torch's OIHW
    layout it would not."""
    model = MaskRefiner()
    model.load_state_dict(state_dict_from_jax(ckpt.load_quantized_params(ARCHIVE)))
    state = types.SimpleNamespace(step=3, model=model, generator=torch.Generator(),
                                  optimizer=torch.optim.SGD(model.parameters(), lr=0.1))
    ckpt.save_state(str(tmp_path / "ckpt"), state)
    npz = str(tmp_path / "train_int8.npz")
    assert tqc.main([str(tmp_path / "ckpt"), npz, "--device", "cpu"]) == 0
    _same_archive(npz)
    # one conv kernel quantized as torch holds it (OIHW: a scale per kernel
    # column) no longer dequantizes to the weights the archive holds
    w = model.state_dict()["backbone.rgb_trunk.res2_0.conv2.conv.weight"].numpy()
    oihw = str(tmp_path / "oihw.npz")
    ckpt.save_quantized_params(oihw, {"w": w})
    assert not np.array_equal(ckpt.load_quantized_params(oihw)["w"], w)


def test_tools_default_to_the_card_and_name_the_import_route(tmp_path, flagship_pth):
    if torch.cuda.is_available():
        pytest.skip("the card is there")
    for main, argv in ((tic.main, ["--torch", flagship_pth, "--out", str(tmp_path / "x")]),
                       (tqc.main, [ARCHIVE, str(tmp_path / "x.npz")])):
        with pytest.raises(SystemExit, match="no CUDA device"):
            main(argv)
    step = tmp_path / "orbax" / "1000"
    step.mkdir(parents=True)
    (step / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(NotImplementedError, match="quber_tpu_torch.tools.import_checkpoint"):
        ckpt.load_eval_params(str(tmp_path / "orbax"))

"""Evaluating what the port trains: train.checkpoint.load_eval_params, the
--weights-file of run_eval_torch.py, and the periodic evaluation seam of
train_net_torch.py (--eval-dataset).

Tolerances: weights read back exactly; run_eval_torch.py on a training
checkpoint directory gives the CSV rows of the same state exported to an
unquantised .npz, exactly; a training run with --eval-dataset logs the same
losses at every step as one without it, exactly.
"""

import csv
import os

import numpy as np
import pytest
import torch

from quber_tpu_torch.config import TrainConfig
from quber_tpu_torch.models.from_jax import state_dict_from_jax, state_dict_to_jax
from quber_tpu_torch.models.mask_refiner import MaskRefinerConfig
from quber_tpu_torch.train import checkpoint as ckpt
from quber_tpu_torch.train.loop import create_train_state

torch.set_num_threads(2)

CFG = dict(height=96, width=128, resnet_depth=14, min_instance_area=64, stuff_area=256)


@pytest.fixture(scope="module")
def state():
    return create_train_state(MaskRefinerConfig(**CFG), TrainConfig(), device="cpu")


def _same_state_dict(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(torch.as_tensor(got[k]), want[k]), k


def test_load_eval_params_training_checkpoint(state, tmp_path):
    ckpt.save_state(str(tmp_path / "ckpt"), state, step=3)
    got = ckpt.load_eval_params(str(tmp_path / "ckpt"))
    _same_state_dict(got, state.model.state_dict())


def test_load_eval_params_npz_and_save_params(state, tmp_path):
    tree = state_dict_to_jax(state.model)
    want = state.model.state_dict()
    path = str(tmp_path / "w.npz")
    ckpt.save_quantized_params(path, tree, min_quant_size=1 << 40)  # nothing quantised
    _same_state_dict(state_dict_from_jax(ckpt.load_eval_params(path)), want)
    ckpt.save_params(str(tmp_path / "params"), tree)
    _same_state_dict(state_dict_from_jax(ckpt.load_eval_params(str(tmp_path / "params"))),
                     want)


def test_load_eval_params_refuses_orbax_and_empty(tmp_path):
    step = tmp_path / "orbax" / "1000"
    step.mkdir(parents=True)
    (step / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(NotImplementedError, match="save_quantized_params"):
        ckpt.load_eval_params(str(tmp_path / "orbax"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        ckpt.load_eval_params(str(tmp_path / "empty"))


def test_load_default_params_reads_a_checkpoint_directory(state, tmp_path, monkeypatch):
    ckpt.save_state(str(tmp_path / "ckpt"), state)
    monkeypatch.setenv("QUBER_WEIGHTS", str(tmp_path / "ckpt"))
    _same_state_dict(ckpt.load_default_params(), state.model.state_dict())


@pytest.fixture(scope="module")
def osd2(tmp_path_factory):
    from quber_tpu_torch.data.make_synthetic_dataset import main as make_dataset

    root = str(tmp_path_factory.mktemp("osd2") / "osd")
    make_dataset(["--out", root, "--n", "2", "--dropout-frac", "0.0005"])
    return root


def _tiny_config(tmp_path, eval_period=2):
    path = tmp_path / "tiny.yaml"
    path.write_text("model:\n" + "".join(f"  {k}: {v}\n" for k, v in CFG.items())
                    + f"train:\n  batch_size: 2\n  warmup_iters: 2\n  base_lr: 0.0005\n"
                      f"  eval_period: {eval_period}\n")
    return str(path)


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_run_eval_torch_on_a_training_checkpoint(osd2, tmp_path):
    """A model train_net_torch.py trained, evaluated from its checkpoint
    directory, equals its .npz export."""
    import run_eval_torch
    import train_net_torch

    cfg = _tiny_config(tmp_path)
    out = tmp_path / "train"
    train_net_torch.main(["--config-file", cfg, "--synthetic", "--synthetic-size", "4",
                          "--target-slots", "8", "--device", "cpu", "--max-iter", "2",
                          "--output-dir", str(out)])
    state = create_train_state(MaskRefinerConfig(**CFG), TrainConfig(), device="cpu")
    assert ckpt.restore_state(str(out / "ckpt"), state) is not None
    npz = str(tmp_path / "export.npz")
    ckpt.save_quantized_params(npz, state_dict_to_jax(state.model), min_quant_size=1 << 40)
    rows = {}
    for name, weights in (("dir", str(out / "ckpt")), ("npz", npz)):
        csv_path = str(tmp_path / name / "eval.csv")
        os.makedirs(os.path.dirname(csv_path))
        assert run_eval_torch.main([
            "--config-file", cfg, "--base-model", "perturbed-gt", "--dataset-path", osd2,
            "--weights-file", weights, "--device", "cpu", "--csv", csv_path,
            "--tag", "same"]) == 0
        rows[name] = [{k: v for k, v in r.items() if k != "avg_ms"} for r in _rows(csv_path)]
    assert len(rows["dir"]) == 2 and rows["dir"] == rows["npz"]


def test_train_net_eval_seam_leaves_the_losses(osd2, tmp_path, capsys):
    """--eval-dataset writes train-eval@<it> rows into <output-dir>/eval.csv
    every eval_period steps, and the steps after an evaluation take the same
    losses as without it (the trainer's module, BatchNorm statistics and
    dropout generator are left alone)."""
    import train_net_torch

    cfg = _tiny_config(tmp_path)
    logs = []
    for name, extra in (("plain", []), ("eval", ["--eval-dataset", "OSD",
                                                 "--eval-dataset-path", osd2,
                                                 "--eval-limit", "1"])):
        train_net_torch.main(["--config-file", cfg, "--synthetic", "--synthetic-size", "4",
                              "--target-slots", "8", "--device", "cpu", "--max-iter", "4",
                              "--log-period", "1", "--device-targets",
                              "--output-dir", str(tmp_path / name), *extra])
        logs.append([line.split(" (")[0] for line in capsys.readouterr().out.splitlines()
                     if line.startswith("iter ")])
    assert len(logs[0]) == 4 and logs[0] == logs[1]
    assert not os.path.exists(tmp_path / "plain" / "eval.csv")
    rows = _rows(tmp_path / "eval" / "eval.csv")
    assert [r["tag"] for r in rows] == ["train-eval@2"] * 2 + ["train-eval@4"] * 2
    assert [r["stage"] for r in rows] == ["initial", "refined"] * 2
    assert all(r["n_images"] == "1" and r["refiner"] == "QuBERRefiner" for r in rows)
    assert all(np.isfinite(float(r["Objects F-measure"])) for r in rows)

"""Checkpoints of the training loop, and the int8 release archive.

Port of quber_tpu/train/checkpoint.py with a format of the port's own: a
checkpoint directory holds one directory per step,
    <directory>/<step>/state.pt     torch.save of plain tensors and numbers
    <directory>/<step>/COMPLETE     written last: the save finished
Saving a step that exists replaces it; the newest `max_to_keep` finished
steps are kept; restoring takes the newest FINISHED step, so a step whose
save was cut is skipped. `save_state` keeps the module's state dict
(parameters, FrozenBN tensors, BatchNorm statistics), the optimizer's
moments, the step and the dropout generator's state.

The int8 archive (`save_quantized_params` / `load_quantized_params`) is the
reference's: one npz with large float leaves as `<key>::q` int8 values and
a `<key>::s` float32 scale per last axis, small leaves as they are, in the
flax variable layout.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import torch

_DONE = "COMPLETE"


def _finished_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(name) for name in os.listdir(directory)
                  if name.isdigit() and os.path.exists(os.path.join(directory, name, _DONE)))


def _save(directory: str, step: int, payload: dict, max_to_keep: int) -> None:
    step_dir = os.path.join(directory, str(step))
    shutil.rmtree(step_dir, ignore_errors=True)  # the same step again: overwrite
    os.makedirs(step_dir)
    torch.save(payload, os.path.join(step_dir, "state.pt"))
    with open(os.path.join(step_dir, _DONE), "w") as f:
        f.write(f"{step}\n")
    for old in _finished_steps(directory)[:-max_to_keep]:
        shutil.rmtree(os.path.join(directory, str(old)))


def _load_latest(directory: str, step: int | None):
    """The payload of `step`, or of the newest finished step; None if there
    is none."""
    if step is None:
        steps = _finished_steps(directory)
        if not steps:
            return None
        step = steps[-1]
    return torch.load(os.path.join(directory, str(step), "state.pt"), map_location="cpu",
                      weights_only=True)


def save_state(directory: str, state, step: int | None = None, max_to_keep: int = 5) -> None:
    """Write a train.loop.TrainState as step `step` (default: state.step)."""
    payload = {
        "step": int(state.step),
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "generator": state.generator.get_state(),
    }
    _save(directory, int(state.step) if step is None else step, payload, max_to_keep)


def restore_state(directory: str, state, step: int | None = None):
    """Load the newest finished checkpoint (or `step`) INTO `state`, which
    provides the module, the optimizer and the generator (the --resume flow:
    create_train_state, then restore), and return it; None when the
    directory holds no finished checkpoint."""
    payload = _load_latest(directory, step)
    if payload is None:
        return None
    state.model.load_state_dict(payload["model"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    state.generator.set_state(payload["generator"])
    state.step = int(payload["step"])
    return state


def save_params(directory: str, params: dict, step: int = 0) -> None:
    """Write a bare (possibly nested) dict of tensors or arrays as step `step`."""
    _save(directory, step, {"params": _map_leaves(params, torch.as_tensor)}, max_to_keep=5)


def restore_params(directory: str) -> dict:
    """The dict of the newest finished save_params step, as numpy arrays."""
    payload = _load_latest(directory, None)
    if payload is None:
        raise FileNotFoundError(f"no checkpoint found under {directory}")
    return _map_leaves(payload["params"], lambda t: t.numpy())


def _map_leaves(tree: dict, fn) -> dict:
    return {k: _map_leaves(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _flatten_dict(d: dict, prefix: str = ""):
    for k, v in d.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from _flatten_dict(v, key)
        else:
            yield key, v


def save_quantized_params(path: str, variables: dict, min_quant_size: int = 4096) -> None:
    """Write `variables` (nested dict of arrays, flax layout) as one npz,
    int8-quantising floating leaves with >= min_quant_size elements
    (symmetric, one scale per index of the last axis). Small leaves (norm
    scales and biases) stay float32."""
    out = {}
    for key, v in _flatten_dict(variables):
        a = np.asarray(v)
        if np.issubdtype(a.dtype, np.floating) and a.size >= min_quant_size:
            red = tuple(range(max(a.ndim - 1, 0)))
            s = np.abs(a).max(axis=red, keepdims=True).astype(np.float32) / 127.0
            s = np.where(s == 0, 1.0, s)
            out[key + "::q"] = np.clip(np.round(a.astype(np.float32) / s), -127, 127).astype(np.int8)
            out[key + "::s"] = s
        else:
            out[key] = a
    np.savez_compressed(path, **out)

_BUNDLED = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                        "weights", "flagship_synth_int8.npz")


def load_quantized_params(path: str) -> dict:
    """int8 npz -> nested dict of float32 (or original) arrays, dequantised
    as q * s, in the flax variable layout ({"params": ..., "batch_stats": ...})."""
    tree: dict = {}

    def insert(key, val):
        parts = key.split("/")
        d = tree
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = val

    with np.load(path) as data:
        for key in data.files:
            if key.endswith("::s"):
                continue
            if key.endswith("::q"):
                base = key[:-3]
                insert(base, data[key].astype(np.float32) * data[base + "::s"])
            else:
                insert(key, data[key])
    return tree


def load_eval_params(path: str):
    """Predictor-ready weights from any of the port's checkpoint flavours
    (the JAX package's `load_eval_params`):
      * a path ending in .npz: the int8 archive (`save_quantized_params`),
        as the flax-layout tree;
      * a training checkpoint directory (`save_state`): the module's state
        dict of its newest finished step;
      * a `save_params` directory: the dict it holds (a flax-layout tree).
    MaskRefinerPredictor takes either form. An orbax directory written by
    the JAX package cannot be read here (the card's machine has no orbax):
    import the reference .pth with the port's CLI
    (`python3 -m quber_tpu_torch.tools.import_checkpoint`), whose output is
    a save_params directory, or convert the orbax directory with the JAX
    package's `save_quantized_params`."""
    if path.endswith(".npz"):
        return load_quantized_params(path)
    payload = _load_latest(path, None)
    if payload is None:
        orbax = os.path.isdir(path) and any(
            os.path.exists(os.path.join(path, name, "_CHECKPOINT_METADATA"))
            for name in os.listdir(path))
        if orbax:
            raise NotImplementedError(
                f"{path} is an orbax checkpoint of the JAX package; import the reference "
                "checkpoint with `python3 -m quber_tpu_torch.tools.import_checkpoint --torch "
                "<.pth> --out <dir>` and pass <dir>/ckpt, or convert this directory to an int8 "
                "archive with quber_tpu.train.checkpoint.save_quantized_params (where orbax "
                "is installed) and pass the .npz")
        raise FileNotFoundError(f"no finished checkpoint under {path}")
    if "model" in payload:  # save_state
        return payload["model"]
    return _map_leaves(payload["params"], lambda t: t.numpy())


def load_default_params(path: str | None = None):
    """Resolve predictor weights as the CLIs do: an explicit path wins, then
    $QUBER_WEIGHTS (either through load_eval_params), then the in-repo int8
    artifact (weights/flagship_synth_int8.npz), else None (random init)."""
    path = path or os.environ.get("QUBER_WEIGHTS")
    if path:
        return load_eval_params(path)
    if os.path.exists(_BUNDLED):
        return load_quantized_params(_BUNDLED)
    return None

"""Quantize a checkpoint of the port into the int8 release archive.

    python3 -m quber_tpu_torch.tools.quantize_checkpoint output/flagship_synth/ckpt \\
        weights/flagship_synth_int8.npz [--check]

Port of tools/quantize_checkpoint.py. The input is any of the port's
checkpoint flavours (train/checkpoint.load_eval_params): a save_params
directory (import_checkpoint's output, the zoo trainers' checkpoints), whose
flax-layout tree is quantized as it is, or a training directory of
train_net_torch.py, whose MaskRefiner (at --config, built and loaded on
--device) is read back in the flax layout first: the archive quantizes per
index of the flax layout's last axis (a conv kernel's output channel in
HWIO), so a torch OIHW tensor quantized as it is would carry the wrong
scales. Symmetric int8 for large floating leaves, float32 for the rest
(train/checkpoint.save_quantized_params); --check reloads the archive and
prints the worst leaf's error relative to its peak.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from quber_tpu_torch.config import load_any_config
from quber_tpu_torch.tools import FLAGSHIP_CONFIG, resolve_device


def variable_tree(path: str, model_cfg, device) -> dict:
    """The flax-layout variable tree of the checkpoint at `path`."""
    from quber_tpu_torch.models.from_jax import state_dict_to_jax
    from quber_tpu_torch.models.mask_refiner import MaskRefiner
    from quber_tpu_torch.train.checkpoint import load_eval_params

    params = load_eval_params(path)
    if not all(isinstance(v, torch.Tensor) for v in params.values()):
        return params
    model = MaskRefiner(model_cfg).to(device)
    model.load_state_dict(params, strict=True)
    return state_dict_to_jax(model)


def worst_leaf(variables: dict, path: str) -> tuple[str, float]:
    """(key, max |archive - tree| / max |tree|) of the archive's worst leaf."""
    from quber_tpu_torch.train.checkpoint import _flatten_dict, load_quantized_params

    ref = dict(_flatten_dict(variables))
    worst = ("", 0.0)
    for key, v in _flatten_dict(load_quantized_params(path)):
        a = np.asarray(ref[key], np.float32)
        err = float(np.abs(a - np.asarray(v, np.float32)).max() / (np.abs(a).max() or 1.0))
        if err > worst[1]:
            worst = (key, err)
    return worst


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("ckpt_dir", help="a checkpoint directory of the port")
    parser.add_argument("out", help="output .npz path")
    parser.add_argument("--check", action="store_true",
                        help="reload and report the worst leaf's relative error")
    parser.add_argument("--config", default=FLAGSHIP_CONFIG,
                        help="the MaskRefiner's config (a training directory only)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from quber_tpu_torch.train.checkpoint import save_quantized_params

    variables = variable_tree(args.ckpt_dir, load_any_config(args.config)[0],
                              resolve_device(args.device))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    save_quantized_params(args.out, variables)
    print(f"wrote {args.out}: {os.path.getsize(args.out) / 1e6:.1f} MB")
    if args.check:
        key, err = worst_leaf(variables, args.out)
        print(f"worst leaf: {key} rel err {err:.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Carry a flax variable tree across to a torch state dict (the MaskRefiner
in every configuration, the Panoptic-DeepLab baseline, the UCN embedding
net, the foreground nets CGNet and LMFFNet, MSMFormer and UOAIS-Net,
UOIS-Net-3D's DSN and RRN in both variants, CascadePSP's PSPNetUOAIS,
RICE's NodeScorer, SAM-HQ, and the open-vocabulary models: the text
towers, DeticDetector and GroundedSAM's parts).

The port's modules are named after the flax scopes, so the map is a rename:
  * `<scope>/kernel` -> `<scope>.weight`, conv kernels HWIO -> OIHW and
    dense kernels [in, out] -> [out, in];
  * the norm scopes `GroupNorm_0`, `BatchNorm_0`, `FrozenBatchNorm_0` -> `norm`,
    with `scale` -> `weight`, `frozen_weight` / `frozen_bias` -> `weight` /
    `bias` and `frozen_mean` / `frozen_var` -> `running_mean` / `running_var`;
  * `batch_stats/.../BatchNorm_0/{mean,var}` -> `norm.running_{mean,var}`,
    and a named BatchNorm scope's (UCN's and PSPNetUOAIS's `bn1`,
    `downsample_bn`, ...) -> `<scope>.running_{mean,var}`; a named GroupNorm
    scope (the released UOIS-Net-3D's `gn`, `gn1`) keeps its name;
  * a PReLU's `alpha` -> the `weight` of its nn.PReLU;
  * a LayerNorm's `scale` -> `weight` (its scope keeps its name);
  * flax MultiHeadDotProductAttention's DenseGeneral kernels (`query`,
    `key`, `value` [dim, heads, head_dim], `out` [heads, head_dim, dim]) and
    biases -> the Dense layers of layers.MultiHeadDotProductAttention over
    the flattened heads;
  * a bare parameter (MSMFormer's `query_embed`; SAM-HQ's position, point
    and token embeddings and relative positions; the text towers'
    `pos_embed`, `token_embedding`, `positional_embedding` and
    `text_projection`, the detector's `logit_scale`) -> the module's
    parameter of that name, and SAM-HQ's LayerNorm2d `weight` keeps its
    name;
  * an nn.Embed's `embedding` -> the `weight` of its nn.Embedding (not
    transposed).
`state_dict_to_jax` is the inverse (it reads the norm scopes off the module
types), and `load_optax_adam_state` carries Adam moments kept in the flax
layout into a torch optimizer.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from quber_tpu_torch.models.layers import (
    BatchNorm, FrozenBatchNorm, GroupNorm, LayerNorm, MultiHeadDotProductAttention)
from quber_tpu_torch.models.sam_hq import LayerNorm2d, TokenLayerNorm
from quber_tpu_torch.models.ucn import RunningBatchNorm

_NORM_SCOPES = {"GroupNorm_0", "BatchNorm_0", "FrozenBatchNorm_0"}

_LEAF = {
    "kernel": "weight",
    "bias": "bias",
    "scale": "weight",
    "frozen_weight": "weight",
    "frozen_bias": "bias",
    "frozen_mean": "running_mean",
    "frozen_var": "running_var",
    "mean": "running_mean",
    "var": "running_var",
    "alpha": "weight",  # a PReLU's per-channel slope
    "prelu_alpha": "prelu_alpha",
    "query_embed": "query_embed",
    "weight": "weight",  # SAM-HQ's LayerNorm2d
    "embedding": "weight",  # nn.Embed
    **{name: name for name in (  # SAM-HQ's and the text towers' bare parameters
        "pos_embed", "rel_pos_h", "rel_pos_w", "pe_gaussian", "point_embeddings",
        "not_a_point_embed", "no_mask_embed", "iou_token", "mask_tokens", "hf_token",
        "token_embedding", "positional_embedding", "text_projection", "logit_scale")},
}


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flatten(v, key)
        else:
            yield key, v


def state_dict_from_jax(tree: dict) -> dict:
    """Nested {"params": ..., "batch_stats": ...} tree (as the int8 npz
    loader returns it) or flat "params/..." keys -> torch state dict.

    A tree without the collection level (a bare flax "params" dict) is read
    as params."""
    out = {}
    for key, value in _flatten(tree):
        parts = key.split("/")
        if parts[0] not in ("params", "batch_stats"):
            parts = ["params"] + parts
        collection, scopes, leaf = parts[0], parts[1:-1], parts[-1]
        if collection == "batch_stats" and leaf not in ("mean", "var"):
            raise KeyError(f"unexpected batch_stats leaf {key}")
        scopes = ["norm" if s in _NORM_SCOPES else s for s in scopes]
        arr = np.array(value, np.float32)  # a writable copy
        if leaf == "kernel" and arr.ndim == 4:
            arr = np.ascontiguousarray(arr.transpose(3, 2, 0, 1))
        elif leaf == "kernel" and arr.ndim == 2:
            arr = np.ascontiguousarray(arr.T)
        elif leaf == "kernel" and arr.ndim == 3:  # attention heads
            flat = arr.reshape(-1, arr.shape[-1]) if scopes[-1] == "out" else \
                arr.reshape(arr.shape[0], -1)
            arr = np.ascontiguousarray(flat.T)
        elif leaf == "bias" and arr.ndim == 2:
            arr = arr.reshape(-1)
        name = ".".join(scopes + [_LEAF[leaf]])
        if name in out:
            raise KeyError(f"two flax leaves map onto {name}")
        out[name] = torch.from_numpy(arr)
    return out


def as_state_dict(params: dict) -> dict:
    """Weights as train.checkpoint.load_eval_params returns them -> a torch
    state dict: a state dict (flat, tensor values) as it is, a flax-layout
    tree through state_dict_from_jax."""
    if params and all(isinstance(v, torch.Tensor) for v in params.values()):
        return params
    return state_dict_from_jax(params)


_TO_JAX = {
    GroupNorm: ("GroupNorm_0", {"weight": "scale", "bias": "bias"}),
    BatchNorm: ("BatchNorm_0", {"weight": "scale", "bias": "bias",
                                "running_mean": "mean", "running_var": "var"}),
    FrozenBatchNorm: ("FrozenBatchNorm_0", {
        "weight": "frozen_weight", "bias": "frozen_bias",
        "running_mean": "frozen_mean", "running_var": "frozen_var"}),
    RunningBatchNorm: ("BatchNorm_0", {"weight": "scale", "bias": "bias",
                                       "running_mean": "mean", "running_var": "var"}),
    LayerNorm: (None, {"weight": "scale", "bias": "bias"}),
    TokenLayerNorm: (None, {"weight": "scale", "bias": "bias"}),
    LayerNorm2d: (None, {"weight": "weight", "bias": "bias"}),
}


def state_dict_to_jax(model: nn.Module) -> dict:
    """The module's state as the nested flax variable tree {"params": ...,
    "batch_stats": ...} of float32 numpy arrays, conv kernels OIHW -> HWIO:
    what the JAX package's predictor and int8 archive take."""
    tree: dict = {"params": {}}
    for name, tensor in model.state_dict().items():
        *scopes, leaf = name.split(".")
        arr = tensor.detach().cpu().numpy().astype(np.float32)
        collection = "params"
        parent = model.get_submodule(".".join(scopes))
        if type(parent) in _TO_JAX:
            scope, leaves = _TO_JAX[type(parent)]
            if isinstance(parent, (BatchNorm, RunningBatchNorm)) and leaf.startswith("running_"):
                collection = "batch_stats"
            # a module's `norm` stands for flax's unnamed norm scope; a norm
            # with a name of its own (the foreground nets' `bn`) keeps it
            if scope and scopes[-1] == "norm":
                scopes = scopes[:-1] + [scope]
            leaf = leaves[leaf]
        elif len(scopes) > 1 and isinstance(model.get_submodule(".".join(scopes[:-1])),
                                            MultiHeadDotProductAttention):
            heads = model.get_submodule(".".join(scopes[:-1])).num_heads
            if leaf == "weight":
                leaf = "kernel"
                arr = arr.T.reshape((heads, -1, arr.shape[0]) if scopes[-1] == "out"
                                    else (arr.shape[1], heads, -1))
            elif scopes[-1] != "out":
                arr = arr.reshape(heads, -1)
            arr = np.ascontiguousarray(arr)
        elif isinstance(parent, nn.PReLU):
            leaf = "alpha"
        elif isinstance(parent, nn.Embedding):
            leaf = "embedding"
        elif leaf == "weight":
            leaf = "kernel"
            if arr.ndim == 4:
                arr = np.ascontiguousarray(arr.transpose(2, 3, 1, 0))
            elif arr.ndim == 2:
                arr = np.ascontiguousarray(arr.T)
        d = tree.setdefault(collection, {})
        for s in scopes:
            d = d.setdefault(s, {})
        d[leaf] = arr
    return tree


def load_optax_adam_state(optimizer: torch.optim.Adam, model: nn.Module, mu: dict, nu: dict,
                          count: int) -> None:
    """Give a torch Adam the moments of an optax Adam: `mu` and `nu` are flax
    `params`-shaped trees of numpy arrays holding (at least) the trainable
    leaves, `count` the number of updates taken."""
    first = state_dict_from_jax({"params": mu})
    second = state_dict_from_jax({"params": nu})
    names = {p: n for n, p in model.named_parameters()}
    for group in optimizer.param_groups:
        for p in group["params"]:
            name = names[p]
            optimizer.state[p] = {
                "step": torch.tensor(float(count)),
                "exp_avg": first[name].to(p.device),
                "exp_avg_sq": second[name].to(p.device),
            }

"""The reference's detectron2 MaskRefiner checkpoint <-> the port's MaskRefiner.

Port of quber_tpu/models/import_torch.py, written straight onto the port's
modules (which carry the flax port's names in torch's layouts, so that no
tensor is transposed):

  * `import_mask_refiner(state_dict, config)`: a detectron2 MaskRefiner state
    dict -> the port's MaskRefiner state dict. It reads only the keys it
    maps (detectron2's pixel_mean / pixel_std buffers and the BatchNorm
    counters are ignored) and raises KeyError on a missing one;
  * `export_mask_refiner(state_dict, config)`: the inverse, the port's state
    dict -> the detectron2 layout;
  * `load_torch_checkpoint(path)`: a .pth / .pkl -> a flat {key: array}
    dict (the `model` or `state_dict` entry where the file wraps it).

The map, in the reference's layout: two DeepLab-ResNet trunks whose depth
trunk prefixes its stages with `depth_` but not its stem, each
Conv2d with its norm fused as `.norm`; the per-stage fusion convs with
their GroupNorms beside them (`fusion_{f}.conv` / `.gn` for concat fusion,
`.conv{i}` / `.gn{i}` for the refine layers, none on res5); the
DeepLabV3+ decoder (ASPP `convs.0-3`, the pool conv `convs.4.1` with a bias
and no norm, `project`; `project_conv` and `fuse_conv.{0,1}` on the
shallower features); the prediction heads (`head.{0,1}`, or
`head.depthwise` / `head.pointwise`) and their 1x1 predictors; and the
hierarchical FusionLayers (`fusion_layers.{j}`, BatchNorm with running
statistics).
"""

from __future__ import annotations

import numpy as np
import torch

from quber_tpu_torch.models.import_zoo import _Builder
from quber_tpu_torch.models.mask_refiner import MaskRefinerConfig

_TRUNK_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
_NORM_LEAVES = {"GN": ("weight", "bias"),
                "FrozenBN": ("weight", "bias", "running_mean", "running_var"),
                "BN": ("weight", "bias", "running_mean", "running_var")}


def _conv(pairs, port, ref, norm=None, bias=False, gate=None):
    """The tensors of one detectron2 Conv2d (and its fused `.norm`) at `ref`
    onto the port's ConvNorm at `port`, as (port key, reference key, gate)
    triples. A gate (port key, reference key) names the tensor whose
    presence decides whether the triple is mapped; a conv bias that is not
    required is gated on itself."""
    pairs.append((f"{port}.conv.weight", f"{ref}.weight", gate))
    b = (f"{port}.conv.bias", f"{ref}.bias")
    pairs.append((*b, gate if bias else b))
    for leaf in _NORM_LEAVES.get(norm, ()):
        pairs.append((f"{port}.norm.{leaf}", f"{ref}.norm.{leaf}", gate))


def _gn_fusion(pairs, port, conv, gn):
    """A fusion conv with a bias and its GroupNorm held beside it."""
    for leaf in ("weight", "bias"):
        pairs.append((f"{port}.conv.{leaf}", f"{conv}.{leaf}", None))
    for leaf in ("weight", "bias"):
        pairs.append((f"{port}.norm.{leaf}", f"{gn}.{leaf}", None))


def _key_map(cfg: MaskRefinerConfig) -> list:
    """Every (port key, reference key, gate) of the configuration."""
    pairs: list = []
    norm = cfg.backbone_norm
    for trunk, ref_trunk, stage_prefix in (("rgb_trunk", "backbone.rgb_backbone", ""),
                                           ("depth_trunk", "backbone.depth_backbone", "depth_")):
        for i in (1, 2, 3):
            _conv(pairs, f"backbone.{trunk}.stem.conv{i}", f"{ref_trunk}.stem.conv{i}", norm)
        for s, n in zip(range(2, 6), _TRUNK_BLOCKS[cfg.resnet_depth]):
            for blk in range(n):
                port = f"backbone.{trunk}.res{s}_{blk}"
                ref = f"{ref_trunk}.{stage_prefix}res{s}.{blk}"
                for c in ("conv1", "conv2", "conv3"):
                    _conv(pairs, f"{port}.{c}", f"{ref}.{c}", norm)
                _conv(pairs, f"{port}.shortcut", f"{ref}.shortcut", norm,
                      gate=(f"{port}.shortcut.conv.weight", f"{ref}.shortcut.weight"))

    for f in cfg.in_features:
        t = f"backbone.fusion_{f}"
        if cfg.fusion_strategy == "concat":
            _gn_fusion(pairs, f"backbone.fusion_{f}_reduce", f"{t}.conv", f"{t}.gn")
        if f != "res5":
            for i in range(cfg.num_backbone_fusion_layers):
                _gn_fusion(pairs, f"backbone.fusion_{f}_conv{i}", f"{t}.conv{i}", f"{t}.gn{i}")

    head, hnorm = "ins_embed_head", cfg.norm
    deep = cfg.in_features[-1]
    aspp, ref_aspp = f"{head}.decoder.aspp_{deep}", f"{head}.decoder.{deep}.project_conv"
    _conv(pairs, f"{aspp}.conv1x1", f"{ref_aspp}.convs.0", hnorm)
    for i in range(len(cfg.aspp_dilations)):
        _conv(pairs, f"{aspp}.conv3x3_{i}", f"{ref_aspp}.convs.{i + 1}", hnorm)
    _conv(pairs, f"{aspp}.pool_conv", f"{ref_aspp}.convs.4.1", bias=True)
    _conv(pairs, f"{aspp}.project", f"{ref_aspp}.project", hnorm)
    for f in cfg.in_features[:-1]:
        ref = f"{head}.decoder.{f}"
        _conv(pairs, f"{head}.decoder.project_{f}", f"{ref}.project_conv", hnorm)
        for j in (0, 1):
            _conv(pairs, f"{head}.decoder.fuse_{f}_{j}", f"{ref}.fuse_conv.{j}", hnorm)

    names = ["foreground", "center", "offset"]
    names += ["eee_mask"] * cfg.eee_mask_on + ["eee_boundary"] * cfg.eee_boundary_on
    for name in names:
        port, ref = f"{head}.{name}_head", f"{head}.{name}_pred_head.head"
        if cfg.head_depthwise_separable:
            for part in ("depthwise", "pointwise"):
                _conv(pairs, f"{port}.dws.{part}", f"{ref}.{part}", hnorm)
        else:
            for j in (0, 1):
                _conv(pairs, f"{port}.conv{j}", f"{ref}.{j}", hnorm)
        for leaf in ("weight", "bias"):
            pairs.append((f"{head}.{name}_predictor.{leaf}",
                          f"{head}.{name}_predictor.predictor.{leaf}", None))

    if cfg.hierarchical_fusion_on:
        for i in range(1, len(cfg.hierarchy)):
            ref = f"{head}.fusion_layers_{i}.fusion_layers"
            _conv(pairs, f"{head}.fusion_{i}.reduce", f"{ref}.0", "BN", bias=True)
            for j in range(cfg.num_head_fusion_layers):
                _conv(pairs, f"{head}.fusion_{i}.conv{j}", f"{ref}.{j + 1}", "BN", bias=True)
    return pairs


def import_mask_refiner(state_dict: dict, config: MaskRefinerConfig | None = None) -> dict:
    """A detectron2 MaskRefiner state dict (tensors or arrays) -> the port's
    MaskRefiner state dict of float32 tensors, for `config` (the flagship's
    by default)."""
    b = _Builder(state_dict)
    for port, ref, gate in _key_map(config or MaskRefinerConfig()):
        if gate is None or gate[1] in b.sd:
            b.out[port] = b.take(ref)
    return b.out


def export_mask_refiner(state_dict: dict, config: MaskRefinerConfig | None = None) -> dict:
    """The port's MaskRefiner state dict -> the detectron2 layout (float32
    CPU tensors), the inverse of import_mask_refiner."""
    out = {}
    for port, ref, gate in _key_map(config or MaskRefinerConfig()):
        if gate is None or gate[0] in state_dict:
            out[ref] = state_dict[port].detach().to("cpu", torch.float32).contiguous()
    return out


def load_torch_checkpoint(path: str) -> dict:
    """A .pth / .pkl -> a flat {key: np.ndarray} dict."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.get("model", obj.get("state_dict", obj)) if isinstance(obj, dict) else obj
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in sd.items()}

"""Configs: native YAML with `_BASE_` inheritance, detectron2-format YAML,
and the reference's ablation-grid names (port of quber_tpu/config.py).

`load_config(path)` reads the repo's flat YAML (top-level `model` and
`train` keys with dataclass field names) into `MaskRefinerConfig` and
`TrainConfig` (solver, schedule and data settings); a path that does not
exist but reads as a grid name (mask_refiner_<modality>_<fusion>_l<N>_...)
is decoded by `config_from_name`. `from_detectron2_yaml(path)` maps a
reference-format (detectron2 CfgNode) YAML onto the same dataclasses, and
`load_any_config(path)` picks the reader for a path as the CLIs do. PyYAML
is imported inside the readers, so the rest of the port runs where it is
not installed.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

from quber_tpu_torch.models.mask_refiner import MaskRefinerConfig


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adam"
    base_lr: float = 0.000125
    weight_decay: float = 0.0
    max_iter: int = 90000
    lr_scheduler: str = "warmup_poly"  # WarmupPolyLR
    poly_power: float = 0.9
    warmup_iters: int = 1000
    warmup_factor: float = 1e-3
    batch_size: int = 8
    checkpoint_period: int = 10000
    eval_period: int = 30000
    seed: int = 7
    freeze_backbone_stages: int = 0  # detectron2 BACKBONE.FREEZE_AT
    # data
    gaussian_sigma: int = 10
    small_instance_area: int = 4096
    small_instance_weight: int = 3
    depth_range: tuple = (2500, 15000)  # mm
    perlin_distortion: bool = True
    color_aug_ssd: bool = True
    copy_paste_prob: float = 0.0
    max_instances: int = 64
    # ResizeShortestEdge grid; several entries mean multi-scale training
    min_size_train: tuple = (480,)
    max_size_train: int = 640
    size_divisibility: int = 32


def _deep_update(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_update(out[k], v)
        else:
            out[k] = v
    return out


def _load_yaml_with_base(path: str) -> dict:
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    base = data.pop("_BASE_", None)
    if base:
        base_path = os.path.join(os.path.dirname(path), base)
        data = _deep_update(_load_yaml_with_base(base_path), data)
    return data


def _coerce(cls, kwargs: dict) -> dict:
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = set(kwargs) - fields
    if unknown:
        raise ValueError(f"Unknown {cls.__name__} keys: {sorted(unknown)}")
    return {
        k: tuple(tuple(x) if isinstance(x, list) else x for x in v)
        if isinstance(v, list) else v
        for k, v in kwargs.items()
    }


def load_config(path: str) -> tuple[MaskRefinerConfig, TrainConfig]:
    """Native flat YAML with _BASE_ inheritance -> (MaskRefinerConfig,
    TrainConfig). A path that does not exist on disk but reads as an
    ablation-grid name is decoded by config_from_name."""
    if not os.path.exists(path):
        name = os.path.splitext(os.path.basename(path))[0].replace("-", "_")
        if name.startswith("mask_refiner"):
            return config_from_name(name)
        raise FileNotFoundError(path)
    data = _load_yaml_with_base(path)
    model = MaskRefinerConfig(**_coerce(MaskRefinerConfig, data.get("model", {})))
    return model, TrainConfig(**_coerce(TrainConfig, data.get("train", {})))


def load_any_config(path: str) -> tuple[MaskRefinerConfig, TrainConfig]:
    """A native YAML (under configs/ or with a `model:` key), a grid name, or
    else a detectron2-format YAML."""
    if not os.path.exists(path) or path.startswith("configs/"):
        return load_config(path)
    with open(path) as f:
        native = "model:" in f.read()
    return load_config(path) if native else from_detectron2_yaml(path)


# the reference encodes its ablation grid in config-file names: modality /
# fusion strategy / backbone-fusion layers / norm / hierarchical fusion /
# hierarchy order (single letters, grouped = same level) / head-fusion
# layers / error type / batch
_HIER_LETTERS = {"m": "eee_mask", "b": "eee_boundary", "f": "foreground",
                 "c": "center", "o": "offset"}


def config_from_name(name: str) -> tuple[MaskRefinerConfig, TrainConfig]:
    """Decode a reference-style grid name into configs, e.g.
    mask_refiner_rgbd_concat_l2_gn_hf_m_b_f_c_o_l3_e2_b8 (the flagship),
    mask_refiner_rgbd_add_l3, mask_refiner_rgb_only,
    mask_refiner_rgbd_concat_l2_gn_hf_fco_m_b_l3_e2_b8 (a grouped level).
    Axes the name leaves out take Base-Mask-Refiner.yaml's defaults (add,
    l3, GN, e2, b4, no hierarchical fusion)."""
    tokens = name.replace("-", "_").split("_")
    if tokens[:2] == ["mask", "refiner"]:
        tokens = tokens[2:]
    model: dict[str, Any] = {
        "fusion_strategy": "add",
        "num_backbone_fusion_layers": 3,
        "hierarchical_fusion_on": False,
    }
    train: dict[str, Any] = {"batch_size": 4}
    hierarchy: list[tuple[str, ...]] = []
    seen_hf = False
    for tok in tokens:
        if not tok or tok in ("only", "augmented", "yaml"):
            continue  # "only" goes with rgb / depth; "augmented" names a dataset
        if tok == "rgbd":
            model["rgb_on"] = model["depth_on"] = True
        elif tok == "rgb":
            model["rgb_on"], model["depth_on"] = True, False
        elif tok == "depth":
            model["rgb_on"], model["depth_on"] = False, True
        elif tok in ("concat", "add"):
            model["fusion_strategy"] = tok
        elif tok in ("gn", "bn", "syncbn"):
            model["norm"] = {"gn": "GN", "bn": "BN", "syncbn": "SyncBN"}[tok]
        elif tok == "hf":
            model["hierarchical_fusion_on"] = True
            seen_hf = True
        elif tok[0] == "l" and tok[1:].isdigit():
            key = "num_head_fusion_layers" if seen_hf else "num_backbone_fusion_layers"
            model[key] = int(tok[1:])
        elif tok[0] == "e" and tok[1:].isdigit():
            model["error_type"] = tok
        elif tok[0] == "b" and tok[1:].isdigit():
            train["batch_size"] = int(tok[1:])
        elif all(c in _HIER_LETTERS for c in tok):
            hierarchy.append(tuple(_HIER_LETTERS[c] for c in tok))
        else:
            raise ValueError(f"unrecognized grid token {tok!r} in {name!r}")
    if hierarchy:
        model["hierarchy"] = tuple(hierarchy)
        letters = [h for level in hierarchy for h in level]
        model["eee_mask_on"] = "eee_mask" in letters
        model["eee_boundary_on"] = "eee_boundary" in letters
    return MaskRefinerConfig(**model), TrainConfig(**train)


def _get(d: dict, dotted: str, default: Any = None) -> Any:
    cur = d
    for part in dotted.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return default
        cur = cur[part]
    return cur


def from_detectron2_yaml(path: str) -> tuple[MaskRefinerConfig, TrainConfig]:
    """Translate a reference-format (detectron2 CfgNode) YAML config: the
    keys of the MaskRefiner build path map onto the dataclasses; keys the
    port does not use are ignored."""
    d = _load_yaml_with_base(path)

    def g(key, default):
        v = _get(d, key, default)
        return v if v is not None else default

    mdefault = MaskRefinerConfig()
    tdefault = TrainConfig()
    hierarchy = g("MODEL.INS_EMBED_HEAD.HIERARCHY", [list(h) for h in mdefault.hierarchy])
    head = "MODEL.INS_EMBED_HEAD."
    model = MaskRefinerConfig(
        rgb_on=g("INPUT.RGB_ON", True),
        depth_on=g("INPUT.DEPTH_ON", True),
        offset_input_on=g("INPUT.OFFSET_INPUT_ON", True),
        pixel_mean=tuple(g("MODEL.PIXEL_MEAN", list(mdefault.pixel_mean))),
        pixel_std=tuple(g("MODEL.PIXEL_STD", list(mdefault.pixel_std))),
        fusion_strategy=g("MODEL.BACKBONE.FUSION_STRATEGY", "concat"),
        num_backbone_fusion_layers=g("MODEL.BACKBONE.NUM_FUSION_LAYERS", 2),
        backbone_norm=g("MODEL.RESNETS.NORM", "FrozenBN"),
        in_features=tuple(g(head + "IN_FEATURES", list(mdefault.in_features))),
        project_channels=tuple(g(head + "PROJECT_CHANNELS", list(mdefault.project_channels))),
        aspp_channels=g(head + "ASPP_CHANNELS", 256),
        aspp_dilations=tuple(g(head + "ASPP_DILATIONS", [6, 12, 18])),
        aspp_dropout=g(head + "ASPP_DROPOUT", 0.1),
        convs_dim=g(head + "CONVS_DIM", 128),
        head_channels=g(head + "HEAD_CHANNELS", 32),
        common_stride=g(head + "COMMON_STRIDE", 4),
        norm=g(head + "NORM", "GN"),
        use_depthwise_separable_conv=g("MODEL.SEM_SEG_HEAD.USE_DEPTHWISE_SEPARABLE_CONV",
                                       False),
        # the prediction heads follow the same SEM_SEG_HEAD flag
        head_depthwise_separable=g("MODEL.SEM_SEG_HEAD.USE_DEPTHWISE_SEPARABLE_CONV", False),
        eee_mask_on=g(head + "EEE_MASK_ON", True),
        eee_boundary_on=g(head + "EEE_BOUNDARY_ON", True),
        error_type=g(head + "ERROR_TYPE", "e2"),
        hierarchical_fusion_on=g(head + "HIERARCHICAL_FUSION_ON", True),
        hierarchy=tuple(tuple(h) for h in hierarchy),
        num_head_fusion_layers=g(head + "NUM_FUSION_LAYERS", 3),
        fusion_target=tuple(g(head + "FUSION_TARGET", ["feat", "pred"])),
        foreground_loss_type=g(head + "FOREGROUND_LOSS_TYPE", "hard_pixel_mining"),
        foreground_loss_top_k=g(head + "FOREGROUND_LOSS_TOP_K", 1.0),
        foreground_loss_weight=g(head + "FOREGROUND_LOSS_WEIGHT", 1.0),
        center_loss_weight=g(head + "CENTER_LOSS_WEIGHT", 200.0),
        offset_loss_weight=g(head + "OFFSET_LOSS_WEIGHT", 0.01),
        eee_mask_loss_weight=g(head + "EEE_MASK_LOSS_WEIGHT", 1.0),
        eee_boundary_loss_weight=g(head + "EEE_BOUNDARY_LOSS_WEIGHT", 1.0),
        center_threshold=g("MODEL.PANOPTIC_DEEPLAB.CENTER_THRESHOLD", 0.3),
        nms_kernel=g("MODEL.PANOPTIC_DEEPLAB.NMS_KERNEL", 7),
        top_k_instances=g("MODEL.PANOPTIC_DEEPLAB.TOP_K_INSTANCE", 200),
        stuff_area=g("MODEL.PANOPTIC_DEEPLAB.STUFF_AREA", 2048),
    )
    min_size = g("INPUT.MIN_SIZE_TRAIN", (480,))
    train = TrainConfig(
        optimizer=g("SOLVER.OPTIMIZER", "ADAM").lower(),
        base_lr=g("SOLVER.BASE_LR", tdefault.base_lr),
        weight_decay=g("SOLVER.WEIGHT_DECAY", 0.0),
        max_iter=g("SOLVER.MAX_ITER", 90000),
        batch_size=g("SOLVER.IMS_PER_BATCH", 8),
        checkpoint_period=g("SOLVER.CHECKPOINT_PERIOD", 10000),
        eval_period=g("TEST.EVAL_PERIOD", 30000),
        seed=g("SEED", 7),
        freeze_backbone_stages=g("MODEL.BACKBONE.FREEZE_AT", 0),
        gaussian_sigma=g("INPUT.GAUSSIAN_SIGMA", 10),
        small_instance_area=g("INPUT.SMALL_INSTANCE_AREA", 4096),
        small_instance_weight=g("INPUT.SMALL_INSTANCE_WEIGHT", 3),
        depth_range=tuple(g("INPUT.DEPTH_RANGE", [2500, 15000])),
        perlin_distortion=g("INPUT.PERLIN_DISTORTION_ON", True),
        color_aug_ssd=g("INPUT.COLOR_AUG_SSD", True),
        min_size_train=tuple(int(v) for v in (min_size if isinstance(min_size, (list, tuple))
                                              else [min_size])),
        max_size_train=g("INPUT.MAX_SIZE_TRAIN", 640),
    )
    return model, train

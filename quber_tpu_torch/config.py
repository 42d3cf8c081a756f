"""Native YAML configs with `_BASE_` inheritance (port of quber_tpu/config.py).

`load_config(path)` reads the repo's flat YAML (top-level `model` and
`train` keys with dataclass field names) into `MaskRefinerConfig` and
`TrainConfig` (solver, schedule and data settings). PyYAML is imported
inside the loader, so the rest of the port runs where it is not installed.
The detectron2-format loader and the grid-name decoder wait for a later
slice.
"""

from __future__ import annotations

import dataclasses
import os

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
    TrainConfig)."""
    data = _load_yaml_with_base(path)
    model = MaskRefinerConfig(**_coerce(MaskRefinerConfig, data.get("model", {})))
    return model, TrainConfig(**_coerce(TrainConfig, data.get("train", {})))

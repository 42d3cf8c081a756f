"""Activation parity: the port's MaskRefiner stage by stage against a plain
torch re-execution of the reference layer semantics.

    python3 -m quber_tpu_torch.tools.activation_parity --random --out parity_report.json
    python3 -m quber_tpu_torch.tools.activation_parity --torch model_final.pth \\
        --config configs/... --height 480 --width 640 --out parity_report.json

Port of tools/activation_parity.py. Given a state dict in the reference's
detectron2 layout (a checkpoint, or with --random a seeded init of the port
exported through models/import_torch.export_mask_refiner), it

  1. re-executes the reference forward in plain torch straight from the
     state dict's tensors (`TorchRef`, the JAX tool's, kept here as the
     port's own copy): the DeepLab stem and bottleneck stages with the stride
     in the 1x1 and res5's multi-grid, the per-stage RGB-D fusion, the
     DeepLabV3+ decoder with ASPP image pooling and the hierarchical
     five-head InsEmbedHead, the FusionLayers' BatchNorm in eval mode;
  2. runs the port's MaskRefiner (in eval mode) on the imported weights and
     takes its activations with forward hooks on the modules named after
     the flax scopes: each trunk's stem and the last block of each res stage,
     the backbone's fused features, the ASPP and decoder outputs, each head's
     feature and each upsampled logit (the offset scaled by the stride);
  3. compares them stage by stage: a stage matches when its max |difference|
     is within `atol` times max(1, its peak), and writes a JSON report.

Runs on --device (cuda unless cpu is given; no card: an error) in float32
with TF32 off. The exit status is 1 unless every stage matches.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch
import torch.nn.functional as F

from quber_tpu_torch.config import load_any_config
from quber_tpu_torch.tools import FLAGSHIP_CONFIG, resolve_device

_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


def _head_names(cfg) -> list[str]:
    return (["foreground", "center", "offset"] + ["eee_mask"] * cfg.eee_mask_on
            + ["eee_boundary"] * cfg.eee_boundary_on)


class TorchRef:
    """Executes the reference MaskRefiner forward from a state dict."""

    def __init__(self, sd, cfg, device="cpu"):
        self.sd = {k: torch.as_tensor(np.asarray(v)).float().to(device) for k, v in sd.items()}
        self.cfg = cfg
        self.device = device
        self.acts = {}

    # -- primitive layers ---------------------------------------------------
    def conv(self, x, key, stride=1, dilation=1, groups=1):
        w = self.sd[f"{key}.weight"]
        b = self.sd.get(f"{key}.bias")
        pad = dilation * (w.shape[-1] - 1) // 2
        return F.conv2d(x, w, b, stride=stride, padding=pad, dilation=dilation, groups=groups)

    def norm(self, x, key, kind):
        if kind == "GN":
            return F.group_norm(x, 32, self.sd[f"{key}.weight"], self.sd[f"{key}.bias"], eps=1e-5)
        # FrozenBN / eval BN: (x - mean) / sqrt(var + eps) * w + b
        w, b = self.sd[f"{key}.weight"], self.sd[f"{key}.bias"]
        m, v = self.sd[f"{key}.running_mean"], self.sd[f"{key}.running_var"]
        scale = w / (v + 1e-5).sqrt()
        return x * scale[None, :, None, None] + (b - m * scale)[None, :, None, None]

    def conv_norm_relu(self, x, key, kind, stride=1, dilation=1, groups=1, relu=True):
        x = self.conv(x, key, stride, dilation, groups)
        if kind:
            x = self.norm(x, f"{key}.norm", kind)
        return F.relu(x) if relu else x

    # -- backbone -----------------------------------------------------------
    def stem(self, x, pfx, norm):
        # DeepLabStem: three 3x3 convs (the first strided), then max-pool 3x3 s2
        x = self.conv_norm_relu(x, f"{pfx}.stem.conv1", norm, stride=2)
        x = self.conv_norm_relu(x, f"{pfx}.stem.conv2", norm)
        x = self.conv_norm_relu(x, f"{pfx}.stem.conv3", norm)
        return F.max_pool2d(x, 3, stride=2, padding=1)

    def bottleneck(self, x, key, norm, stride, dilation):
        # detectron2 BottleneckBlock with stride_in_1x1=True
        y = self.conv_norm_relu(x, f"{key}.conv1", norm, stride=stride)
        y = self.conv_norm_relu(y, f"{key}.conv2", norm, dilation=dilation)
        y = self.conv_norm_relu(y, f"{key}.conv3", norm, relu=False)
        if f"{key}.shortcut.weight" in self.sd:
            sc = self.conv_norm_relu(x, f"{key}.shortcut", norm, stride=stride, relu=False)
        else:
            sc = x
        return F.relu(y + sc)

    def trunk(self, x, pfx, stage_prefix, tag):
        cfg = self.cfg
        norm = cfg.backbone_norm
        x = self.stem(x, pfx, norm)
        self.acts[f"{tag}_stem"] = x
        out = {}
        for s, n in zip(range(2, 6), _BLOCKS[cfg.resnet_depth]):
            # res5: dilation 2 with multi-grid (1, 2, 4) and stride 1; res3
            # and res4 stride 2 in their first block
            if s == 5:
                dil_per_block = [2 * mg for mg in getattr(cfg, "res5_multi_grid", (1, 2, 4))]
                stride = 1
            else:
                dil_per_block = [1] * n
                stride = 1 if s == 2 else 2
            for b in range(n):
                x = self.bottleneck(x, f"{pfx}.{stage_prefix}res{s}.{b}", norm,
                                    stride if b == 0 else 1,
                                    dil_per_block[b % len(dil_per_block)])
            self.acts[f"{tag}_res{s}"] = x
            out[f"res{s}"] = x
        return out

    def backbone(self, images, offset_enc):
        cfg = self.cfg
        rgb = torch.cat([images[:, :3], offset_enc], dim=1)
        depth = torch.cat([images[:, 3:6], offset_enc], dim=1)
        rgb_out = self.trunk(rgb, "backbone.rgb_backbone", "", "rgb")
        depth_out = self.trunk(depth, "backbone.depth_backbone", "depth_", "depth")
        fused = {}
        for f in cfg.in_features:
            if cfg.fusion_strategy == "concat":
                y = torch.cat([rgb_out[f], depth_out[f]], dim=1)
                y = F.relu(F.group_norm(
                    self.conv(y, f"backbone.fusion_{f}.conv"), 32,
                    self.sd[f"backbone.fusion_{f}.gn.weight"],
                    self.sd[f"backbone.fusion_{f}.gn.bias"], eps=1e-5))
            else:
                y = rgb_out[f] + depth_out[f]
            if f != "res5":
                for i in range(cfg.num_backbone_fusion_layers):
                    y = F.relu(F.group_norm(
                        self.conv(y, f"backbone.fusion_{f}.conv{i}"), 32,
                        self.sd[f"backbone.fusion_{f}.gn{i}.weight"],
                        self.sd[f"backbone.fusion_{f}.gn{i}.bias"], eps=1e-5))
            fused[f] = y
            self.acts[f"fused_{f}"] = y
        return fused

    # -- head ---------------------------------------------------------------
    def aspp(self, x, key):
        norm = self.cfg.norm
        h, w = x.shape[2:]
        outs = [self.conv_norm_relu(x, f"{key}.convs.0", norm)]
        for i, d in enumerate(self.cfg.aspp_dilations):
            outs.append(self.conv_norm_relu(x, f"{key}.convs.{i + 1}", norm, dilation=d))
        # image pooling: AdaptiveAvgPool2d(1) + 1x1 conv + relu (no norm)
        p = F.relu(self.conv(x.mean(dim=(2, 3), keepdim=True), f"{key}.convs.4.1"))
        outs.append(F.interpolate(p, size=(h, w), mode="bilinear", align_corners=False))
        # (the ASPP dropout is inactive at inference)
        return self.conv_norm_relu(torch.cat(outs, dim=1), f"{key}.project", norm)

    def decoder(self, features):
        head, norm = "ins_embed_head", self.cfg.norm
        y = None
        for f in reversed(list(self.cfg.in_features)):
            x = features[f]
            if y is None:
                y = self.aspp(x, f"{head}.decoder.{f}.project_conv")
                self.acts["aspp"] = y
            else:
                proj = self.conv_norm_relu(x, f"{head}.decoder.{f}.project_conv", norm)
                y = F.interpolate(y, size=proj.shape[2:], mode="bilinear", align_corners=False)
                y = torch.cat([proj, y], dim=1)
                y = self.conv_norm_relu(y, f"{head}.decoder.{f}.fuse_conv.0", norm)
                y = self.conv_norm_relu(y, f"{head}.decoder.{f}.fuse_conv.1", norm)
        self.acts["decoder"] = y
        return y

    def pred_head(self, y, name):
        norm = self.cfg.norm
        k = f"ins_embed_head.{name}_pred_head.head"
        if self.cfg.head_depthwise_separable:
            y = self.conv_norm_relu(y, f"{k}.depthwise", norm, groups=y.shape[1])
            return self.conv_norm_relu(y, f"{k}.pointwise", norm)
        y = self.conv_norm_relu(y, f"{k}.0", norm)
        return self.conv_norm_relu(y, f"{k}.1", norm)

    def predictor(self, feat, name):
        return self.conv(feat, f"ins_embed_head.{name}_predictor.predictor")

    def head(self, y):
        cfg = self.cfg
        names = _head_names(cfg)
        feats, outs = {}, {}
        if not cfg.hierarchical_fusion_on:
            for name in names:
                feats[name] = self.pred_head(y, name)
                outs[name] = self.predictor(feats[name], name)
        else:
            for i, level in enumerate(cfg.hierarchy):
                src = y
                if i > 0:
                    if "feat" in cfg.fusion_target:
                        for prev in cfg.hierarchy[i - 1]:
                            src = torch.cat([src, feats[prev]], dim=1)
                    if "pred" in cfg.fusion_target:
                        for prev in cfg.hierarchy[i - 1]:
                            o = outs[prev]
                            o = o.softmax(dim=1) if "eee" in prev else o.sigmoid()
                            src = torch.cat([src, o], dim=1)
                    # FusionLayers: 1x1 + BN + relu, then N x (3x3 + BN + relu)
                    fk = f"ins_embed_head.fusion_layers_{i}.fusion_layers"
                    src = self.conv_norm_relu(src, f"{fk}.0", "FrozenBN")
                    for j in range(cfg.num_head_fusion_layers):
                        src = self.conv_norm_relu(src, f"{fk}.{j + 1}", "FrozenBN")
                for name in level:
                    feats[name] = self.pred_head(src, name)
                    outs[name] = self.predictor(feats[name], name)
        for name in names:
            self.acts[f"{name}_feat"] = feats[name]
        # the inference upsample; the offset scaled by the stride
        for name in names:
            o = F.interpolate(outs[name], scale_factor=cfg.common_stride, mode="bilinear",
                              align_corners=False)
            if name == "offset":
                o = o * cfg.common_stride
            outs[name] = o
            self.acts[f"{name}_logit"] = o
        return outs

    def forward(self, images, offset_enc):
        """images [B, 6, H, W] raw 0..255; offset_enc [B, 3, H, W]."""
        mean = torch.tensor(list(self.cfg.pixel_mean), dtype=torch.float32, device=self.device)
        std = torch.tensor(list(self.cfg.pixel_std), dtype=torch.float32, device=self.device)
        x = (images - mean[None, :, None, None]) / std[None, :, None, None]
        return self.head(self.decoder(self.backbone(x, offset_enc)))


# ---------------------------------------------------------------------------
# the port's side: forward hooks at the same points
# ---------------------------------------------------------------------------


def stage_modules(cfg) -> dict:
    """Stage name -> the port module (by name) whose output it is."""
    stages = {}
    for tag in ("rgb", "depth"):
        trunk = f"backbone.{tag}_trunk"
        stages[f"{tag}_stem"] = f"{trunk}.stem"
        for s, n in zip(range(2, 6), _BLOCKS[cfg.resnet_depth]):
            stages[f"{tag}_res{s}"] = f"{trunk}.res{s}_{n - 1}"
    stages["aspp"] = f"ins_embed_head.decoder.aspp_{cfg.in_features[-1]}"
    stages["decoder"] = "ins_embed_head.decoder"
    for name in _head_names(cfg):
        stages[f"{name}_feat"] = f"ins_embed_head.{name}_head"
    return stages


@torch.no_grad()
def port_activations(model, images, offset_enc) -> dict:
    """The port MaskRefiner's (in eval mode) activations, NCHW, at TorchRef's
    stages: module outputs through forward hooks, the fused features from
    the backbone's output dict and the logits from the model's output."""
    acts, hooks = {}, []

    def keep(name):
        def hook(_module, _inputs, output):
            acts[name] = output
        return hook

    for name, path in stage_modules(model.config).items():
        try:
            module = model.get_submodule(path)
        except AttributeError:
            continue  # reported as missing
        hooks.append(module.register_forward_hook(keep(name)))
    hooks.append(model.backbone.register_forward_hook(keep("fused")))
    try:
        outputs = model.eval()(images, offset_enc)
    finally:
        for h in hooks:
            h.remove()
    for f, v in acts.pop("fused").items():
        acts[f"fused_{f}"] = v
    for name in _head_names(model.config):
        acts[f"{name}_logit"] = outputs[name]
    return acts


def compare(ref_acts: dict, port_acts: dict, atol: float) -> dict:
    report = {}
    for key, rv in ref_acts.items():
        pv = port_acts.get(key)
        if pv is None:
            report[key] = {"status": "missing_in_port"}
            continue
        rv = rv.detach().float().cpu().numpy()
        pv = pv.detach().float().cpu().numpy()
        if rv.shape != pv.shape:
            report[key] = {"status": "shape_mismatch", "torch": list(rv.shape),
                           "port": list(pv.shape)}
            continue
        diff = np.abs(rv - pv)
        scale = max(1e-6, float(np.abs(rv).max()))
        report[key] = {
            "status": "ok" if diff.max() <= atol * max(1.0, scale) else "DIFF",
            "max_abs": float(diff.max()),
            "mean_abs": float(diff.mean()),
            "ref_max_abs": scale,
            "shape": list(rv.shape),
        }
    return report


def parity(sd: dict, cfg, images: np.ndarray, offset: np.ndarray, atol: float,
           device) -> dict:
    """The stage report of the reference state dict `sd` (detectron2
    layout) on one input: images [B, H, W, 6] raw, offset [B, H, W, 3]."""
    from quber_tpu_torch.models.import_torch import import_mask_refiner
    from quber_tpu_torch.models.mask_refiner import MaskRefiner

    model = MaskRefiner(cfg).to(device)
    model.load_state_dict(import_mask_refiner(sd, cfg), strict=True)
    x = torch.from_numpy(np.ascontiguousarray(images.transpose(0, 3, 1, 2))).to(device)
    enc = torch.from_numpy(np.ascontiguousarray(offset.transpose(0, 3, 1, 2))).to(device)
    ref = TorchRef(sd, cfg, device)
    with torch.no_grad():
        ref.forward(x, enc)
    return compare(ref.acts, port_activations(model, x, enc), atol)


def random_state_dict(cfg, seed: int) -> dict:
    """A seeded init of the port's MaskRefiner in the detectron2 layout."""
    from quber_tpu_torch.models.import_torch import export_mask_refiner
    from quber_tpu_torch.models.mask_refiner import MaskRefiner

    model = MaskRefiner(cfg)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return export_mask_refiner(model.state_dict(), cfg)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--torch", help=".pth state dict in the reference layout")
    parser.add_argument("--random", action="store_true",
                        help="a seeded init of the port exported to the reference layout instead")
    parser.add_argument("--config", default=FLAGSHIP_CONFIG)
    parser.add_argument("--height", type=int, default=128)
    parser.add_argument("--width", type=int, default=128)
    parser.add_argument("--atol", type=float, default=3e-4,
                        help="tolerance per stage, relative to its peak (float32)")
    parser.add_argument("--out", default="parity_report.json")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import dataclasses

    from quber_tpu_torch.models.import_torch import load_torch_checkpoint

    device = resolve_device(args.device)
    cfg = dataclasses.replace(load_any_config(args.config)[0], height=args.height,
                              width=args.width)
    if args.random or not args.torch:
        sd = random_state_dict(cfg, args.seed)
    else:
        sd = load_torch_checkpoint(args.torch)
    rng = np.random.RandomState(args.seed)
    images = (rng.rand(1, args.height, args.width, 6) * 255).astype(np.float32)
    offset = rng.rand(1, args.height, args.width, 3).astype(np.float32)
    report = parity(sd, cfg, images, offset, args.atol, device)

    n_bad = sum(1 for v in report.values() if v.get("status") != "ok")
    with open(args.out, "w") as f:
        json.dump({"config": args.config, "atol": args.atol, "device": str(device),
                   "stages": report, "n_stages": len(report), "n_mismatched": n_bad}, f, indent=1)
    width = max(len(k) for k in report)
    for k, v in report.items():
        line = f"{k:<{width}}  {v.get('status'):>6}"
        if "max_abs" in v:
            line += f"  max|d|={v['max_abs']:.3e} (peak {v['ref_max_abs']:.2e})"
        print(line)
    print(f"{len(report) - n_bad}/{len(report)} stages match -> {args.out}")
    return 1 if n_bad else 0


if __name__ == "__main__":
    sys.exit(main())

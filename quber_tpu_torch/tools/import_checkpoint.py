"""Convert a reference checkpoint (.pth) into a checkpoint directory of the port.

    python3 -m quber_tpu_torch.tools.import_checkpoint --model mask_refiner \\
        --torch model_final.pth --out output/imported
    python3 -m quber_tpu_torch.tools.import_checkpoint --model cgnet \\
        --torch rgbd_fg.pth --out output/fg
    python3 -m quber_tpu_torch.tools.import_checkpoint --model mask_refiner \\
        --export output/imported/ckpt --out model_final.pth

Port of tools/import_checkpoint.py, with the same model names. The state
dict goes through the model's importer (models/import_torch.py,
models/import_zoo.py) into the port's module, built at the widths the
weights carry, and the module's variable tree (the JAX CLI's, in the
flax layout) is written to `<out>/ckpt` with train/checkpoint.save_params.
That directory loads wherever the JAX CLI's output loads: $QUBER_WEIGHTS
and --weights / --weights-file (mask_refiner), $QUBER_BENCH_CKPT,
$QUBER_CGNET_CKPT, $QUBER_LMFFNET_CKPT and $QUBER_UCN_CKPT, and the zoo's
$QUBER_MSMFORMER_CKPT, $QUBER_UOAIS_CKPT, $QUBER_UOIS_{DSN,RRN}_CKPT,
$QUBER_CASCADEPSP_CKPT. --config names the MaskRefiner's configuration.

--export (mask_refiner only) goes the other way: any of the port's
checkpoint flavours (train/checkpoint.load_eval_params: the int8 .npz, a
training or a save_params directory) -> a .pth in the detectron2 layout.

The module is built and loaded on --device (cuda unless cpu is given).
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from quber_tpu_torch.config import load_any_config
from quber_tpu_torch.tools import FLAGSHIP_CONFIG, resolve_device

MODELS = ("mask_refiner", "cgnet", "lmffnet", "ucn", "cascadepsp", "sam_hq",
          "msmformer", "uoais_net", "uois_dsn", "uois_rrn")


def import_state_dict(model: str, sd: dict, model_cfg=None) -> dict:
    """A loaded reference state dict -> the port's state dict of `model`."""
    from quber_tpu_torch.models import import_zoo as IZ

    if model == "mask_refiner":
        from quber_tpu_torch.models.import_torch import import_mask_refiner

        return import_mask_refiner(sd, model_cfg)
    importers = {"cgnet": IZ.import_cgnet, "lmffnet": IZ.import_lmffnet, "ucn": IZ.import_ucn,
                 "cascadepsp": IZ.import_cascadepsp, "sam_hq": IZ.import_sam_hq,
                 "msmformer": IZ.import_msmformer, "uoais_net": IZ.import_uoais_net,
                 "uois_dsn": IZ.import_uois_dsn, "uois_rrn": IZ.import_uois_rrn}
    if model not in importers:
        raise ValueError(f"unknown model {model!r}; choose from {MODELS}")
    return importers[model](sd)


def _sam_hq(sd: dict):
    """SAMHQ at the size, width, depth, heads and attention windows its
    weights carry."""
    from quber_tpu_torch.models.sam_hq import SAMHQ

    enc = "image_encoder"
    embed_dim = sd[f"{enc}.patch_embed.weight"].shape[0]
    grid = sd[f"{enc}.pos_embed"].shape[1]
    depth = 1 + max(int(k.split(".")[1].split("_")[1]) for k in sd
                    if k.startswith(f"{enc}.block_"))
    rel = [sd[f"{enc}.block_{i}.attn.rel_pos_h"].shape for i in range(depth)]
    windows = {(n + 1) // 2 for n, _ in rel if n != 2 * grid - 1} or {14}
    return SAMHQ(img_size=16 * grid, embed_dim=embed_dim, depth=depth,
                 num_heads=embed_dim // rel[0][1],
                 global_blocks=tuple(i for i, (n, _) in enumerate(rel) if n == 2 * grid - 1),
                 window_size=windows.pop())


def _msmformer(sd: dict):
    """PretrainedMSMFormer at the widths its weights carry (the head count
    leaves no trace in the weights: the released model's 8)."""
    from quber_tpu_torch.models.msmformer_pretrained import PretrainedMSMFormer

    q, dim = sd["predictor.query_feat"].shape
    return PretrainedMSMFormer(
        embed_dim=sd["backbone.rgb_branch.fc.weight"].shape[0], hidden_dim=dim, num_queries=q,
        dim_feedforward=sd["predictor.ffn_0.linear1.weight"].shape[0],
        dec_layers=sum(k.startswith("predictor.ffn_") and k.endswith("linear1.weight")
                       for k in sd),
        num_classes=sd["predictor.class_embed.weight"].shape[0] - 1,
        mask_dim=sd["mask_features.weight"].shape[0])


def build_module(model: str, sd: dict, model_cfg=None) -> torch.nn.Module:
    """The port's module of `model` at the widths the port state dict `sd`
    carries (the MaskRefiner at `model_cfg`)."""
    if model == "mask_refiner":
        from quber_tpu_torch.models.mask_refiner import MaskRefiner

        return MaskRefiner(model_cfg)
    if model == "cgnet":
        from quber_tpu_torch.models.cgnet import CGNet

        return CGNet(classes=sd["classifier.weight"].shape[0],
                     in_channels=sd["level1_0.conv.weight"].shape[1])
    if model == "lmffnet":
        from quber_tpu_torch.models.lmffnet import LMFFNet

        return LMFFNet(classes=sd["mad.pw1.conv.weight"].shape[0],
                       in_channels=sd["init_0.conv.weight"].shape[1])
    if model == "ucn":
        from quber_tpu_torch.models.ucn import UCNEmbeddingNet

        return UCNEmbeddingNet(sd["rgb_branch.fc.weight"].shape[0])
    if model == "cascadepsp":
        from quber_tpu_torch.models.cascadepsp import PSPNetUOAIS

        return PSPNetUOAIS()
    if model == "sam_hq":
        return _sam_hq(sd)
    if model == "msmformer":
        return _msmformer(sd)
    if model == "uoais_net":
        from quber_tpu_torch.models.uoais_net_pretrained import UOAISNetPretrained

        return UOAISNetPretrained()
    from quber_tpu_torch.models.uois_net_pretrained import PretrainedDSN, PretrainedRRN

    cls = {"uois_dsn": PretrainedDSN, "uois_rrn": PretrainedRRN}[model]
    return cls(feature_dim=sd["encoder.layer1.layer1.conv1.weight"].shape[0])


def import_variables(model: str, sd: dict, model_cfg=None, device="cpu") -> dict:
    """A reference state dict -> the variable tree of the port's module
    ({"params": ..., "batch_stats": ...} of float32 numpy arrays, the
    layout of the JAX CLI's output): imported, loaded strictly into the
    module on `device` and read back."""
    from quber_tpu_torch.models.from_jax import state_dict_to_jax

    port = import_state_dict(model, sd, model_cfg)
    module = build_module(model, port, model_cfg).to(device)
    module.load_state_dict(port, strict=True)
    return state_dict_to_jax(module)


def export(path: str, model_cfg, device) -> dict:
    """A port checkpoint of the MaskRefiner (any load_eval_params flavour)
    -> its detectron2-layout state dict."""
    from quber_tpu_torch.models.from_jax import as_state_dict
    from quber_tpu_torch.models.import_torch import export_mask_refiner
    from quber_tpu_torch.models.mask_refiner import MaskRefiner
    from quber_tpu_torch.train.checkpoint import load_eval_params

    params = load_eval_params(path)
    model = MaskRefiner(model_cfg).to(device)
    model.load_state_dict(as_state_dict(params), strict=True)
    return export_mask_refiner(model.state_dict(), model_cfg)


def count(tree: dict) -> int:
    return sum(count(v) if isinstance(v, dict) else v.size for v in tree.values())


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--model", default="mask_refiner", choices=MODELS)
    parser.add_argument("--torch", help="input .pth / .pkl state dict")
    parser.add_argument("--config", default=FLAGSHIP_CONFIG,
                        help="model config (mask_refiner only)")
    parser.add_argument("--out", required=True,
                        help="output directory (import) or .pth path (--export)")
    parser.add_argument("--export", help="a port checkpoint to export to a torch .pth instead")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from quber_tpu_torch.models.import_torch import load_torch_checkpoint
    from quber_tpu_torch.train.checkpoint import save_params

    model_cfg = load_any_config(args.config)[0]
    if args.export:
        if args.model != "mask_refiner":
            parser.error("--export supports mask_refiner only")
        sd = export(args.export, model_cfg, resolve_device(args.device))
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        torch.save(sd, args.out)
        print(f"exported {len(sd)} tensors -> {args.out}")
        return 0
    if not args.torch:
        parser.error("--torch (import) or --export required")
    device = resolve_device(args.device)
    variables = import_variables(args.model, load_torch_checkpoint(args.torch), model_cfg,
                                 device)
    save_params(os.path.join(args.out, "ckpt"), variables)
    print(f"imported {args.model}: {count(variables) / 1e6:.1f}M params -> {args.out}/ckpt")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Importers of the reference's released checkpoints: a torch state dict of
the reference's module tree -> the state dict of the port's module.

Port of the MSMFormer, UOAIS-Net, UOIS-Net-3D and CascadePSP importers of
quber_tpu/models/import_zoo.py, with the same key maps, written straight
onto the port's modules (which carry the flax port's names, in torch's
layouts, so that no tensor is transposed): `import_msmformer` fills
models/msmformer_pretrained.PretrainedMSMFormer, `import_uoais_net`
models/uoais_net_pretrained.UOAISNetPretrained, `import_uois_dsn` and
`import_uois_rrn` models/uois_net_pretrained.PretrainedDSN and
PretrainedRRN, `import_cascadepsp` models/cascadepsp.PSPNetUOAIS and
`import_sam_hq` models/sam_hq.SAMHQ (its transposed convolutions' kernels
[in, out, 2, 2] -> [out, in, 2, 2], the one transpose),
`import_clip_text` models/clip_text.CLIPTextEncoder, `import_cgnet`
models/cgnet.CGNet, `import_lmffnet` models/lmffnet.LMFFNet and
`import_ucn` models/ucn.UCNEmbeddingNet. Every key of the checkpoint
must be mapped (or be a known buffer that carries no network state), else
KeyError names the ones left (strict, the default).
"""

from __future__ import annotations

import numpy as np
import torch


class _Builder:
    """Collects the port's state dict from inserts of reference keys and
    records which reference keys were read."""

    def __init__(self, sd: dict):
        self.sd = {k: torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
                   for k, v in sd.items()}
        self.out: dict = {}
        self.used: set = set()

    def take(self, key):
        self.used.add(key)
        return self.sd[key].detach().float().clone()

    def put(self, path, leaf, value):
        name = ".".join(list(path) + [leaf])
        if name in self.out:
            raise KeyError(f"two checkpoint keys map onto {name}")
        self.out[name] = value

    def param(self, path, leaf, tkey):
        self.put(path, leaf, self.take(tkey))

    def dense(self, path, tkey):
        """A torch Conv2d / Linear / ConvTranspose2d (weight and optional bias)."""
        self.param(path, "weight", f"{tkey}.weight")
        if f"{tkey}.bias" in self.sd:
            self.param(path, "bias", f"{tkey}.bias")

    def bn(self, path, tkey):
        """torch BatchNorm2d -> the four tensors of a BatchNorm of the port."""
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            self.param(path, leaf, f"{tkey}.{leaf}")
        self.used.add(f"{tkey}.num_batches_tracked")

    def layernorm(self, path, tkey):
        self.param(path, "weight", f"{tkey}.weight")
        self.param(path, "bias", f"{tkey}.bias")

    def result(self, strict: bool) -> dict:
        unused = sorted(k for k in set(self.sd) - self.used
                        if not k.endswith("num_batches_tracked"))
        if strict and unused:
            raise KeyError(f"{len(unused)} unmapped checkpoint keys, e.g. {unused[:5]}")
        return self.out


# ---------------------------------------------------------------------------
# UCN's ResNet-34-8s branches (UCN itself, and MSMFormer's backbone)
# ---------------------------------------------------------------------------

_RESNET34_BLOCKS = (3, 4, 6, 3)


def _ucn_trunk(b, path, pfx):
    b.dense(path + ["conv1"], f"{pfx}conv1")
    b.bn(path + ["bn1"], f"{pfx}bn1")
    for li, n in enumerate(_RESNET34_BLOCKS):
        for bi in range(n):
            t = f"{pfx}layer{li + 1}.{bi}"
            f = path + [f"layer{li + 1}_{bi}"]
            b.dense(f + ["conv1"], f"{t}.conv1")
            b.bn(f + ["bn1"], f"{t}.bn1")
            b.dense(f + ["conv2"], f"{t}.conv2")
            b.bn(f + ["bn2"], f"{t}.bn2")
            if f"{t}.downsample.0.weight" in b.sd:
                b.dense(f + ["downsample_conv"], f"{t}.downsample.0")
                b.bn(f + ["downsample_bn"], f"{t}.downsample.1")


def detect_ucn_prefixes(state_dict: dict) -> tuple[str, str]:
    """(rgb_prefix, depth_prefix) of the two ResNet-34-8s branches, found by
    their 7x7 stem convs; the prefixes end with a dot."""
    cands = sorted({k[:-len("conv1.weight")] for k, v in state_dict.items()
                    if k.endswith("conv1.weight") and tuple(np.shape(v))[2:] == (7, 7)
                    and len(np.shape(v)) == 4})
    if len(cands) != 2:
        raise KeyError(f"expected 2 stem convs, found prefixes {cands}")
    if any(h in cands[0].lower() for h in ("depth", "xyz", "d_")):
        return cands[1], cands[0]
    return cands[0], cands[1]


def import_ucn(state_dict: dict, strict: bool = True, rgb_prefix: str | None = None,
               depth_prefix: str | None = None) -> dict:
    """A UCN checkpoint (two torchvision-named ResNet-34-8s branches, each
    with its 1x1 `fc` embedding head; DataParallel's `module.` stripped) ->
    UCNEmbeddingNet's state dict. The branch prefixes are found from the
    keys unless both are given."""
    sd = {k.removeprefix("module."): v for k, v in state_dict.items()}
    if rgb_prefix is None or depth_prefix is None:
        rgb_prefix, depth_prefix = detect_ucn_prefixes(sd)
    b = _Builder(sd)
    for branch, pfx in (("rgb_branch", rgb_prefix), ("depth_branch", depth_prefix)):
        _ucn_trunk(b, [branch, "trunk"], pfx)
        b.dense([branch, "fc"], f"{pfx}fc")
    return b.result(strict)


# ---------------------------------------------------------------------------
# The foreground nets: CGNet (rgbd_fg.pth) and LMFFNet (rgbd_lmffnet.pth),
# each the `model` entry of its checkpoint
# ---------------------------------------------------------------------------


def _prelu(b, path, tkey):
    b.param(path, "weight", f"{tkey}.weight")


def _cg_bnprelu(b, path, tkey):
    b.bn(path + ["bn"], f"{tkey}.bn")
    _prelu(b, path + ["act"], f"{tkey}.act")


def _cg_convbnprelu(b, path, tkey):
    b.dense(path + ["conv"], f"{tkey}.conv")
    _cg_bnprelu(b, path, tkey)


def _cg_block(b, path, tkey, down: bool):
    _cg_convbnprelu(b, path + ["conv1x1"], f"{tkey}.conv1x1")
    b.dense(path + ["f_loc"], f"{tkey}.F_loc.conv")
    b.dense(path + ["f_sur"], f"{tkey}.F_sur.conv")
    if down:
        _cg_bnprelu(b, path, tkey)
        b.dense(path + ["reduce"], f"{tkey}.reduce.conv")
    else:
        _cg_bnprelu(b, path + ["bn_prelu"], f"{tkey}.bn_prelu")
    b.dense(path + ["f_glo", "fc1"], f"{tkey}.F_glo.fc.0")
    b.dense(path + ["f_glo", "fc2"], f"{tkey}.F_glo.fc.2")


def import_cgnet(state_dict: dict, m: int = 3, n: int = 21, strict: bool = True) -> dict:
    """A Context_Guided_Network state dict (level1_0-2, b1, level2_0 and the
    level2 ModuleList, bn_prelu_2, level3_0 and level3, bn_prelu_3, the
    classifier Sequential) -> CGNet(m=m, n=n)'s state dict."""
    b = _Builder(state_dict)
    for i in range(3):
        _cg_convbnprelu(b, [f"level1_{i}"], f"level1_{i}")
    _cg_bnprelu(b, ["b1"], "b1")
    _cg_block(b, ["level2_0"], "level2_0", down=True)
    for i in range(m - 1):
        _cg_block(b, [f"level2_{i + 1}"], f"level2.{i}", down=False)
    _cg_bnprelu(b, ["bn_prelu_2"], "bn_prelu_2")
    _cg_block(b, ["level3_0"], "level3_0", down=True)
    for i in range(n - 1):
        _cg_block(b, [f"level3_{i + 1}"], f"level3.{i}", down=False)
    _cg_bnprelu(b, ["bn_prelu_3"], "bn_prelu_3")
    b.dense(["classifier"], "classifier.0.conv")
    return b.result(strict)


def _lm_bnprelu(b, path, tkey):
    b.bn(path + ["bn"], f"{tkey}.bn")
    _prelu(b, path + ["act"], f"{tkey}.acti")


def _lm_conv(b, path, tkey, bn_acti: bool = False):
    b.dense(path + ["conv"], f"{tkey}.conv")
    if bn_acti:
        _lm_bnprelu(b, path + ["bn_prelu"], f"{tkey}.bn_prelu")


def _lm_semb(b, path, tkey):
    _lm_conv(b, path + ["conv3x3"], f"{tkey}.conv3x3", True)
    _lm_conv(b, path + ["dconv_left"], f"{tkey}.dconv_left", True)
    _lm_conv(b, path + ["dconv_right"], f"{tkey}.dconv_right", True)
    _lm_conv(b, path + ["resume_3x3"], f"{tkey}.conv3x3_resume.conv3x3", True)
    _lm_conv(b, path + ["resume_1x1"], f"{tkey}.conv3x3_resume.conv1x1_resume")
    _lm_bnprelu(b, path + ["bn_out"], f"{tkey}.bn_relu_1")


def _lm_ffmb(b, path, tkey):
    b.dense(path + ["pmca", "conv2x2"], f"{tkey}.PMCA.conv2x2.conv")
    b.dense(path + ["pmca", "se", "fc1"], f"{tkey}.PMCA.SE_Block.fc.0")
    b.param(path + ["pmca", "se"], "prelu_alpha", f"{tkey}.PMCA.SE_Block.fc.1.weight")
    b.dense(path + ["pmca", "se", "fc2"], f"{tkey}.PMCA.SE_Block.fc.2")
    _lm_bnprelu(b, path + ["bn_prelu"], f"{tkey}.bn_prelu")
    _lm_conv(b, path + ["conv1x1"], f"{tkey}.conv1x1")


def import_lmffnet(state_dict: dict, block_1: int = 3, block_2: int = 8,
                   strict: bool = True) -> dict:
    """An LMFFNet state dict (the Init_Block Sequential, FFM_A, downsample_1,
    SEM_B_Block1's SEM_Block_1{i}, FFM_B1, downsample_2, SEM_B_Block2,
    FFM_B2, MAD) -> LMFFNet(block_1=block_1, block_2=block_2)'s state dict."""
    b = _Builder(state_dict)
    for i in range(3):
        _lm_conv(b, [f"init_{i}"], f"Init_Block.init_conv.{i}", True)
    _lm_bnprelu(b, ["ffm_a", "bn_prelu"], "FFM_A.bn_prelu")
    _lm_conv(b, ["ffm_a", "conv1x1"], "FFM_A.conv1x1")
    for k, blocks in ((1, block_1), (2, block_2)):
        _lm_conv(b, [f"downsample_{k}", "conv3x3"], f"downsample_{k}.conv3x3")
        _lm_bnprelu(b, [f"downsample_{k}", "bn_prelu"], f"downsample_{k}.bn_prelu")
        for i in range(blocks):
            _lm_semb(b, [f"sem_b{k}_{i}"], f"SEM_B_Block{k}.SEM_B_Block.SEM_Block_{k}{i}")
        _lm_ffmb(b, [f"ffm_b{k}"], f"FFM_B{k}")
    for port, ref, bn_acti in (("mid_1x1", "mid_layer_1x1", False),
                               ("deep_1x1", "deep_layer_1x1", False),
                               ("dw1", "DwConv1", True), ("pw1", "PwConv1", False),
                               ("dw2", "DwConv2", True), ("pw2", "PwConv2", False)):
        _lm_conv(b, ["mad", port], f"MAD.{ref}", bn_acti)
    return b.result(strict)


# ---------------------------------------------------------------------------
# MSMFormer (the released "pretrained" meta-architecture)
# ---------------------------------------------------------------------------


def _mha(b, path, tkey):
    """nn.MultiheadAttention's packed in_proj + out_proj -> q / k / v / out."""
    w = b.take(f"{tkey}.in_proj_weight")
    bias = b.take(f"{tkey}.in_proj_bias")
    e = w.shape[0] // 3
    for i, name in enumerate(("q_proj", "k_proj", "v_proj")):
        b.put(path + [name], "weight", w[i * e:(i + 1) * e].clone())
        b.put(path + [name], "bias", bias[i * e:(i + 1) * e].clone())
    b.dense(path + ["out_proj"], f"{tkey}.out_proj")


def import_msmformer(state_dict: dict, strict: bool = True, dec_layers: int | None = None) -> dict:
    """A released MSMFormer state dict -> PretrainedMSMFormer's: the UCN
    backbone (`pretrained_backbone.*`, branch prefixes found from the keys),
    `sem_seg_head.pixel_decoder.mask_features` and the decoder
    `sem_seg_head.predictor.*`. The criterion's buffers and the pixel
    normalisers carry no network state."""
    sd = {k.removeprefix("module."): v for k, v in state_dict.items()}
    b = _Builder(sd)
    bb = {k[len("pretrained_backbone."):]: v for k, v in sd.items()
          if k.startswith("pretrained_backbone.")}
    rgb_pfx, depth_pfx = detect_ucn_prefixes(bb)
    for branch, pfx in (("rgb_branch", rgb_pfx), ("depth_branch", depth_pfx)):
        _ucn_trunk(b, ["backbone", branch, "trunk"], f"pretrained_backbone.{pfx}")
        b.dense(["backbone", branch, "fc"], f"pretrained_backbone.{pfx}fc")
    b.dense(["mask_features"], "sem_seg_head.pixel_decoder.mask_features")

    p, f = "sem_seg_head.predictor", ["predictor"]
    if dec_layers is None:
        dec_layers = 1 + max(int(k.split(".")[3]) for k in sd
                             if k.startswith(f"{p}.transformer_ffn_layers."))
    for i in range(dec_layers):
        _mha(b, f + [f"cross_attn_{i}"], f"{p}.transformer_cross_attention_layers.{i}.meanshift_attn")
        b.layernorm(f + [f"cross_norm_{i}"], f"{p}.transformer_cross_attention_layers.{i}.norm")
        _mha(b, f + [f"self_attn_{i}"], f"{p}.transformer_self_attention_layers.{i}.self_attn")
        b.layernorm(f + [f"self_norm_{i}"], f"{p}.transformer_self_attention_layers.{i}.norm")
        for name in ("linear1", "linear2"):
            b.dense(f + [f"ffn_{i}", name], f"{p}.transformer_ffn_layers.{i}.{name}")
        b.layernorm(f + [f"ffn_{i}", "norm"], f"{p}.transformer_ffn_layers.{i}.norm")
    b.layernorm(f + ["decoder_norm"], f"{p}.decoder_norm")
    for name in ("query_feat", "query_embed", "level_embed"):
        b.put(f, name, b.take(f"{p}.{name}.weight"))
    b.dense(f + ["input_proj_0"], f"{p}.input_proj.0")
    b.dense(f + ["class_embed"], f"{p}.class_embed")
    for i in range(3):
        b.dense(f + ["mask_embed", f"layers_{i}"], f"{p}.mask_embed.layers.{i}")
    for k in sd:
        if k.startswith("criterion.") or k in ("pixel_mean", "pixel_std"):
            b.used.add(k)
    return b.result(strict)


# ---------------------------------------------------------------------------
# UOAIS-Net (detectron2 GeneralizedRCNN, R50_rgbdconcat_mlc_occatmask_hom_concat)
# ---------------------------------------------------------------------------


def _d2conv(b, path, tkey, norm: bool = False):
    """detectron2 Conv2d (+ its fused FrozenBN `.norm`) -> a ConvNorm."""
    b.dense(path + ["conv"], tkey)
    if norm:
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            b.param(path + ["norm"], leaf, f"{tkey}.norm.{leaf}")


def _d2_r50_trunk(b, path, tprefix, stage_prefix="res"):
    """A standard detectron2 R50 trunk (BasicStem, res2-res5, FrozenBN); the
    depth trunk names its stages `res_2`..`res_5`."""
    _d2conv(b, path + ["stem", "conv1"], f"{tprefix}.stem.conv1", norm=True)
    for s, n in zip(range(2, 6), (3, 4, 6, 3)):
        for blk in range(n):
            t = f"{tprefix}.{stage_prefix}{s}.{blk}"
            f = path + [f"res{s}_{blk}"]
            for c in ("conv1", "conv2", "conv3"):
                _d2conv(b, f + [c], f"{t}.{c}", norm=True)
            if f"{t}.shortcut.weight" in b.sd:
                _d2conv(b, f + ["shortcut"], f"{t}.shortcut", norm=True)


def _hom_mask_head(b, head, prefix):
    t = f"roi_heads.{head}"
    for i in range(3):
        _d2conv(b, [head, f"{prefix}_guidance_layer{i}"], f"{t}.{prefix}_guidance_layer{i}")
    for k in range(1, 5):
        _d2conv(b, [head, f"{prefix}_mask_fcn{k}"], f"{t}.{prefix}_mask_fcn{k}")
    for i in range(3):
        _d2conv(b, [head, f"{prefix}_mlc_layer{i}"], f"{t}.{prefix}_mlc_layer{i}")
    b.dense([head, "deconv"], f"{t}.deconv")
    _d2conv(b, [head, "predictor"], f"{t}.predictor")


def import_uoais_net(state_dict: dict, strict: bool = True) -> dict:
    """A released UOAIS-Net state dict -> UOAISNetPretrained's. The pixel
    normalisers, the anchor tables and the occlusion head's trailing deconv
    (its output is used only when occlusion is not the last head) carry no
    state the deployed model reads."""
    b = _Builder(state_dict)
    _d2_r50_trunk(b, ["bottom_up_rgb"], "backbone.bottom_up_rgb", "res")
    _d2_r50_trunk(b, ["bottom_up_depth"], "backbone.bottom_up_depth", "res_")
    for s in range(2, 6):
        _d2conv(b, [f"fusion_layer_{s}"], f"backbone.fusion_layers.fusion_layer_{s}")
        _d2conv(b, [f"fpn_lateral{s}"], f"backbone.fpn_lateral{s}")
        _d2conv(b, [f"fpn_output{s}"], f"backbone.fpn_output{s}")
    rpn = "proposal_generator.rpn_head"
    _d2conv(b, ["rpn_conv"], f"{rpn}.conv")
    _d2conv(b, ["rpn_objectness"], f"{rpn}.objectness_logits")
    _d2conv(b, ["rpn_anchor_deltas"], f"{rpn}.anchor_deltas")
    for i in range(1, 5):
        _d2conv(b, [f"box_head_conv{i}"], f"roi_heads.box_head.conv{i}")
    b.dense(["cls_score"], "roi_heads.box_predictor.cls_score")
    b.dense(["bbox_pred"], "roi_heads.box_predictor.bbox_pred")
    b.dense(["extraction_mlc_layer0"], "roi_heads.extraction_mlc_layer0")
    _d2conv(b, ["extraction_mlc_layer1"], "roi_heads.extraction_mlc_layer1")
    _d2conv(b, ["extraction_mlc_layer2"], "roi_heads.extraction_mlc_layer2")
    _hom_mask_head(b, "visible_mask_head", "visible")
    _hom_mask_head(b, "amodal_mask_head", "amodal")
    t, f = "roi_heads.occ_cls_mask_head", ["occ_cls_mask_head"]
    for i in range(3):
        _d2conv(b, f + [f"occlusion_guidance_layer{i}"], f"{t}.occlusion_guidance_layer{i}")
    for k in range(1, 5):
        _d2conv(b, f + [f"_occ_cls_fcn{k}"], f"{t}._occ_cls_fcn{k}")
    for i in range(3):
        _d2conv(b, f + [f"occ_cls__mlc_layer{i}"], f"{t}.occ_cls__mlc_layer{i}")
    b.dense(f + ["predictor"], f"{t}.predictor")
    for k in b.sd:
        if (k in ("pixel_mean", "pixel_std") or k.startswith("proposal_generator.anchor_generator")
                or k.startswith("roi_heads.occ_cls_mask_head.deconv")):
            b.used.add(k)
    return b.result(strict)


# ---------------------------------------------------------------------------
# UOIS-Net-3D (DSN and RRN checkpoints: {"model": state dict}, DataParallel's
# "module." prefixes)
# ---------------------------------------------------------------------------


def _import_uois(state_dict: dict, strict: bool) -> dict:
    """The DSN / RRN map, by rule: the port's modules carry the reference's
    names, so every `<module>.weight` is a bias-free conv (`last_conv` has
    a bias) or, for a `gn` / `gn1` leaf, a GroupNorm's weight and bias."""
    if isinstance(state_dict.get("model"), dict):
        state_dict = state_dict["model"]
    b = _Builder({k.removeprefix("module."): v for k, v in state_dict.items()})
    for k in sorted(b.sd):
        if not k.endswith(".weight"):
            continue
        mod = k[:-len(".weight")]
        path = mod.split(".")
        if path[-1] in ("gn", "gn1"):
            b.layernorm(path, mod)
        else:
            b.dense(path, mod)
    return b.result(strict)


def import_uois_dsn(state_dict: dict, strict: bool = True) -> dict:
    """DepthSeedingNetwork_3D_TOD_checkpoint.pth -> PretrainedDSN's state dict."""
    return _import_uois(state_dict, strict)


def import_uois_rrn(state_dict: dict, strict: bool = True) -> dict:
    """RRN_OID_checkpoint.pth -> PretrainedRRN's state dict."""
    return _import_uois(state_dict, strict)


# ---------------------------------------------------------------------------
# CascadePSP-RGBD (PSPNet_UOAIS, torchvision trunk naming; SyncBN keys in
# BatchNorm's layout)
# ---------------------------------------------------------------------------


def import_cascadepsp(state_dict: dict, layers=(3, 4, 6, 3), strict: bool = True) -> dict:
    """A PSPNet_UOAIS state dict (model_40000) -> PSPNetUOAIS's."""
    b = _Builder({k.removeprefix("module."): v for k, v in state_dict.items()})
    b.dense(["feats", "conv1"], "feats.conv1")
    b.bn(["feats", "bn1"], "feats.bn1")
    for li, n in enumerate(layers):
        for bi in range(n):
            t, f = f"feats.layer{li + 1}.{bi}", ["feats", f"layer{li + 1}_{bi}"]
            for c in (1, 2, 3):
                b.dense(f + [f"conv{c}"], f"{t}.conv{c}")
                b.bn(f + [f"bn{c}"], f"{t}.bn{c}")
            if f"{t}.downsample.0.weight" in b.sd:
                b.dense(f + ["downsample_conv"], f"{t}.downsample.0")
                b.bn(f + ["downsample_bn"], f"{t}.downsample.1")
    for i in range(4):
        b.dense(["psp", f"stage_{i}"], f"psp.stages.{i}.1")
    b.dense(["psp", "bottleneck"], "psp.bottleneck")
    for k in (1, 2, 3):
        up = f"up_{k}"
        for seq in ("conv", "conv2"):
            b.bn([up, f"{seq}_bn0"], f"{up}.{seq}.0")
            b.dense([up, f"{seq}_conv0"], f"{up}.{seq}.2")
            b.bn([up, f"{seq}_bn1"], f"{up}.{seq}.3")
            b.dense([up, f"{seq}_conv1"], f"{up}.{seq}.5")
        b.dense([up, "shortcut"], f"{up}.shortcut")
    for name in ("final_28", "final_56"):
        b.dense([f"{name}_0"], f"{name}.0")
        b.dense([f"{name}_2"], f"{name}.2")
    b.dense(["final_11"], "final_11")
    b.dense(["final_21"], "final_21")
    return b.result(strict)


# ---------------------------------------------------------------------------
# SAM-HQ (the standard Sam layout with MaskDecoderHQ: sam_hq_vit_{b,l,h}.pth
# or the reference's fine-tuned checkpoints)
# ---------------------------------------------------------------------------


def _sam_convT(b, path, tkey):
    """torch ConvTranspose2d [in, out, 2, 2] -> SAMHQ's [out, in, 2, 2]."""
    b.put(path, "weight", b.take(f"{tkey}.weight").transpose(0, 1).contiguous())
    b.param(path, "bias", f"{tkey}.bias")


def _sam_mlp(b, path, tkey, n_layers=3):
    for i in range(n_layers):
        b.dense(path + [f"layers_{i}"], f"{tkey}.layers.{i}")


def _sam_attn(b, path, tkey):
    for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
        b.dense(path + [p], f"{tkey}.{p}")


def _sam_twoway(b, path, tkey, depth=2):
    for i in range(depth):
        t, f = f"{tkey}.layers.{i}", path + [f"layers_{i}"]
        for attn in ("self_attn", "cross_attn_token_to_image", "cross_attn_image_to_token"):
            _sam_attn(b, f + [attn], f"{t}.{attn}")
        for j in (1, 2, 3, 4):
            b.layernorm(f + [f"norm{j}"], f"{t}.norm{j}")
        b.dense(f + ["mlp", "lin1"], f"{t}.mlp.lin1")
        b.dense(f + ["mlp", "lin2"], f"{t}.mlp.lin2")
    _sam_attn(b, path + ["final_attn_token_to_image"], f"{tkey}.final_attn_token_to_image")
    b.layernorm(path + ["norm_final_attn"], f"{tkey}.norm_final_attn")


def import_sam_hq(state_dict: dict, depth: int | None = None, strict: bool = True) -> dict:
    """A SAM-HQ checkpoint (image_encoder / prompt_encoder / mask_decoder =
    MaskDecoderHQ) -> SAMHQ's state dict. The ViT depth is read off the
    block keys unless given (12 / 24 / 32 for ViT-B / L / H); the
    pixel_mean / pixel_std buffers carry no learnt state and are dropped."""
    b = _Builder({k.removeprefix("module."): v for k, v in state_dict.items()})
    enc = ["image_encoder"]
    if depth is None:
        depth = 1 + max(int(k.split(".")[2]) for k in b.sd
                        if k.startswith("image_encoder.blocks."))
    b.dense(enc + ["patch_embed"], "image_encoder.patch_embed.proj")
    b.param(enc, "pos_embed", "image_encoder.pos_embed")
    for i in range(depth):
        t, f = f"image_encoder.blocks.{i}", enc + [f"block_{i}"]
        b.layernorm(f + ["norm1"], f"{t}.norm1")
        b.layernorm(f + ["norm2"], f"{t}.norm2")
        b.dense(f + ["attn", "qkv"], f"{t}.attn.qkv")
        b.dense(f + ["attn", "proj"], f"{t}.attn.proj")
        b.param(f + ["attn"], "rel_pos_h", f"{t}.attn.rel_pos_h")
        b.param(f + ["attn"], "rel_pos_w", f"{t}.attn.rel_pos_w")
        b.dense(f + ["mlp", "lin1"], f"{t}.mlp.lin1")
        b.dense(f + ["mlp", "lin2"], f"{t}.mlp.lin2")
    b.dense(enc + ["neck_0"], "image_encoder.neck.0")
    b.layernorm(enc + ["neck_1"], "image_encoder.neck.1")
    b.dense(enc + ["neck_2"], "image_encoder.neck.2")
    b.layernorm(enc + ["neck_3"], "image_encoder.neck.3")

    pe, tpe = ["prompt_encoder"], "prompt_encoder"
    b.param(pe, "pe_gaussian", f"{tpe}.pe_layer.positional_encoding_gaussian_matrix")
    b.put(pe, "point_embeddings", torch.cat(
        [b.take(f"{tpe}.point_embeddings.{i}.weight") for i in range(4)]))
    b.put(pe, "not_a_point_embed", b.take(f"{tpe}.not_a_point_embed.weight")[0])
    b.put(pe, "no_mask_embed", b.take(f"{tpe}.no_mask_embed.weight")[0])
    b.dense(pe + ["mask_down_0"], f"{tpe}.mask_downscaling.0")
    b.layernorm(pe + ["mask_ln_1"], f"{tpe}.mask_downscaling.1")
    b.dense(pe + ["mask_down_2"], f"{tpe}.mask_downscaling.3")
    b.layernorm(pe + ["mask_ln_3"], f"{tpe}.mask_downscaling.4")
    b.dense(pe + ["mask_proj"], f"{tpe}.mask_downscaling.6")

    dec, tdec = ["mask_decoder"], "mask_decoder"
    for token in ("iou_token", "mask_tokens", "hf_token"):
        b.param(dec, token, f"{tdec}.{token}.weight")
    _sam_twoway(b, dec + ["transformer"], f"{tdec}.transformer")
    _sam_convT(b, dec + ["up_0"], f"{tdec}.output_upscaling.0")
    b.layernorm(dec + ["up_ln_1"], f"{tdec}.output_upscaling.1")
    _sam_convT(b, dec + ["up_3"], f"{tdec}.output_upscaling.3")
    for i in range(4):
        _sam_mlp(b, dec + [f"hyper_{i}"], f"{tdec}.output_hypernetworks_mlps.{i}")
    _sam_mlp(b, dec + ["iou_head"], f"{tdec}.iou_prediction_head")
    _sam_mlp(b, dec + ["hf_mlp"], f"{tdec}.hf_mlp")
    for name, tkey in (("compress_vit", "compress_vit_feat"), ("enc", "embedding_encoder")):
        _sam_convT(b, dec + [f"{name}_0"], f"{tdec}.{tkey}.0")
        b.layernorm(dec + [f"{name}_ln_1"], f"{tdec}.{tkey}.1")
        _sam_convT(b, dec + [f"{name}_3"], f"{tdec}.{tkey}.3")
    b.dense(dec + ["maskfeat_0"], f"{tdec}.embedding_maskfeature.0")
    b.layernorm(dec + ["maskfeat_ln_1"], f"{tdec}.embedding_maskfeature.1")
    b.dense(dec + ["maskfeat_3"], f"{tdec}.embedding_maskfeature.3")
    for k in ("pixel_mean", "pixel_std"):
        b.used.add(k)
    return b.result(strict)


# ---------------------------------------------------------------------------
# CLIP's text tower (the open-vocabulary wrappers' vocabulary embedding)
# ---------------------------------------------------------------------------


def import_clip_text(state_dict: dict, strict: bool = True) -> dict:
    """A CLIP state dict -> CLIPTextEncoder's state dict: a whole CLIP model
    (its visual tower and logit_scale are not read) or a text-only one; the
    layer count is read off the transformer.resblocks keys. The fused
    in_proj and text_projection ([width, embed_dim], applied as pooled @
    text_projection) keep their layouts."""
    b = _Builder({k.removeprefix("module."): v for k, v in state_dict.items()})
    layers = 1 + max(int(k.split(".")[2]) for k in b.sd
                     if k.startswith("transformer.resblocks."))
    b.param([], "token_embedding", "token_embedding.weight")
    b.param([], "positional_embedding", "positional_embedding")
    for i in range(layers):
        t, f = f"transformer.resblocks.{i}", [f"resblock_{i}"]
        b.layernorm(f + ["ln_1"], f"{t}.ln_1")
        b.param(f + ["in_proj"], "weight", f"{t}.attn.in_proj_weight")
        b.param(f + ["in_proj"], "bias", f"{t}.attn.in_proj_bias")
        b.dense(f + ["out_proj"], f"{t}.attn.out_proj")
        b.layernorm(f + ["ln_2"], f"{t}.ln_2")
        b.dense(f + ["c_fc"], f"{t}.mlp.c_fc")
        b.dense(f + ["c_proj"], f"{t}.mlp.c_proj")
    b.layernorm(["ln_final"], "ln_final")
    b.param([], "text_projection", "text_projection")
    b.used.update(k for k in b.sd if k.startswith("visual.") or k == "logit_scale")
    return b.result(strict)


def load_reference_checkpoint(path: str) -> dict:
    """A reference .pth -> its state dict (the `model` entry where the file
    wraps it, as detectron2 and the UCN trainer save)."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and isinstance(sd.get("model"), dict):
        sd = sd["model"]
    return {k: v for k, v in sd.items() if hasattr(v, "shape")}

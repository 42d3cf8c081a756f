"""SAM-HQ, the promptable mask refiner (torch, channel-last).

Port of quber_tpu/models/sam_hq.py:
  * a ViT image encoder (16x16 patches, windowed blocks zero-padded to a
    window multiple, global blocks, fused qkv with decomposed relative
    positions) and its neck; `encode` returns the neck [B, h, w, 256] and
    the output of the FIRST global block [B, h, w, embed_dim];
  * the prompt encoder: random-Fourier point encoding, learned point / box
    embeddings (label -1 pads), the strided-conv mask downscaler;
  * the two-way transformer mask decoder with the HQ output token, whose
    hypernetwork convolves a feature fused from the early and the final ViT
    features. `decode` takes mask prompts, `decode_points` points,
    `decode_box` boxes.

Tensors are channel-last, as in the flax module: images [B, S, S, 3],
embeddings [B, h, w, C], mask prompts [B, 4h, 4w, 1]; the masks come back
[B, k, 4h, 4w]. A decode may take one image's embedding (batch 1) for a
batch of prompts: it is broadcast, and the HQ feature is computed once.
Modules are named after the flax scopes, so models/from_jax carries a flax
variable tree across by renaming (`import_zoo.import_sam_hq` reads the
reference's checkpoints).

Compute type, as the flax module's: with `layers.set_compute_dtype(model,
torch.bfloat16)` every Dense, Conv, transposed conv and the ViT's LayerNorms
compute in bfloat16; the LayerNorm2d's, the GELUs around them and the mask
products run in float32, and so do the two-way transformer's LayerNorms
(flax's without a dtype) and its attention logits (its `q / np.sqrt(hd)`
promotes bfloat16 to float32). GELU is the exact (erf) form, rounded where
jitted XLA rounds it. Attention is plain tensor products and `layers.flax_softmax`,
as the reference computes it in XLA: `scaled_dot_product_attention` rounds
bfloat16 elsewhere.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from quber_tpu_torch.models import layers
from quber_tpu_torch.models.layers import Conv2d, Dense, LayerNorm, flax_layer_norm, flax_softmax

# ViT presets: (embed_dim, depth, num_heads, global_attn_indexes)
VIT_PRESETS = {
    "vit_b": (768, 12, 12, (2, 5, 8, 11)),
    "vit_l": (1024, 24, 16, (5, 11, 17, 23)),
    "vit_h": (1280, 32, 16, (7, 15, 23, 31)),
}

# SAM input normalisation (the reference's pixel_mean / pixel_std buffers)
SAM_PIXEL_MEAN = np.asarray([123.675, 116.28, 103.53], np.float32)
SAM_PIXEL_STD = np.asarray([58.395, 57.12, 57.375], np.float32)


def gelu_exact(x):
    """flax nn.gelu(approximate=False) as jitted XLA computes it: 0.5 * x *
    erfc(-x * sqrt(0.5)) in the input's type with the constant in that
    type, where in bfloat16 the product -x * c enters erfc unrounded (XLA's
    fusion keeps it in float32) and erfc and the other products round."""
    c = _rounded(math.sqrt(0.5), x.dtype)
    return (0.5 * x) * torch.special.erfc(-x.float() * c).to(x.dtype)


def _rounded(value: float, dtype: torch.dtype) -> float:
    """`value` rounded to `dtype`, as a Python float: a tensor of that type
    times it computes as JAX's does with the constant cast to its type."""
    return float(torch.tensor(value, dtype=dtype))


def layer_norm_2d(x, weight, bias, eps: float = 1e-6):
    """The reference's LayerNorm2d over the last (channel) axis: the
    variance as the mean of squared deviations, divided by its sqrt."""
    u = x.mean(dim=-1, keepdim=True)
    s = ((x - u) ** 2).mean(dim=-1, keepdim=True)
    return (x - u) / torch.sqrt(s + eps) * weight + bias


class LayerNorm2d(nn.Module):
    """layer_norm_2d with its `weight` and `bias`, in float32."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return layer_norm_2d(x.float(), self.weight, self.bias, self.eps)


class TokenLayerNorm(LayerNorm):
    """The two-way transformer's flax nn.LayerNorm(epsilon=1e-5), which has
    no dtype: float32 out whatever the input's or the model's type."""

    def forward(self, x):
        return flax_layer_norm(x, self.weight, self.bias, self.eps)


def _conv(conv: nn.Module, x):
    """A Conv2d on a channel-last tensor."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class MLPBlock(nn.Module):
    """lin1 -> exact GELU (or ReLU) -> lin2."""

    def __init__(self, dim: int, hidden: int, out: int, act: str = "gelu"):
        super().__init__()
        self.act = act
        self.lin1 = Dense(dim, hidden)
        self.lin2 = Dense(hidden, out)

    def forward(self, x):
        x = self.lin1(x)
        return self.lin2(gelu_exact(x) if self.act == "gelu" else F.relu(x))


class MLP(nn.Module):
    """`num_layers` Dense layers (`layers_{i}`) with ReLU between."""

    def __init__(self, dim: int, hidden: int, out: int, num_layers: int = 3):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layers_{i}", Dense(dim if i == 0 else hidden,
                                                 out if i == num_layers - 1 else hidden))

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"layers_{i}")(x)
            if i < self.num_layers - 1:
                x = F.relu(x)
        return x


def window_partition(x, ws: int):
    """[B, H, W, C] -> ([B * nH * nW, ws, ws, C], (Hp, Wp)), zero-padded to a
    window multiple first."""
    b, h, w, c = x.shape
    pad_h, pad_w = (-h) % ws, (-w) % ws
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c), (hp, wp)


def window_unpartition(windows, ws: int, pad_hw, hw):
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // ((hp // ws) * (wp // ws))
    x = windows.reshape(b, hp // ws, wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


def _rel_pos_table(size: int, rel_pos):
    """get_rel_pos for equal query and key sizes: [size, size, head_dim],
    entry (i, j) the row i - j + size - 1."""
    r = torch.arange(size, device=rel_pos.device)
    return rel_pos[r[:, None] - r[None, :] + size - 1]


class ViTAttention(nn.Module):
    """Multi-head self-attention over a [B, h, w, C] grid: fused qkv, logits
    q * hd^-0.5 . k plus the decomposed relative positions, softmax."""

    def __init__(self, dim: int, num_heads: int, input_size: int):
        super().__init__()
        self.num_heads = num_heads
        hd = dim // num_heads
        self.qkv = Dense(dim, dim * 3)
        self.proj = Dense(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size - 1, hd))

    def forward(self, x):
        b, h, w, c = x.shape
        nh = self.num_heads
        hd = c // nh
        dt = self.qkv.compute_dtype
        qkv = self.qkv(x).reshape(b, h * w, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, b * nh, h * w, hd).unbind(0)
        # a Python scalar in JAX: cast to the input's type first
        attn = (q * _rounded(hd ** -0.5, q.dtype)) @ k.transpose(-2, -1)
        rh = _rel_pos_table(h, self.rel_pos_h.to(dt))
        rw = _rel_pos_table(w, self.rel_pos_w.to(dt))
        r_q = q.reshape(b * nh, h, w, hd)
        rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh)
        rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw)
        attn = attn.view(b * nh, h, w, h, w)
        attn += rel_h[:, :, :, :, None]
        attn += rel_w[:, :, :, None, :]
        attn = flax_softmax(attn.view(b * nh, h * w, h * w))
        x = (attn @ v).view(b, nh, h, w, hd).permute(0, 2, 3, 1, 4).reshape(b, h, w, c)
        return self.proj(x)


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 0, grid_size: int = 64,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.window_size = window_size  # 0: global attention
        self.norm1 = LayerNorm(dim)
        self.attn = ViTAttention(dim, num_heads, window_size if window_size > 0 else grid_size)
        self.norm2 = LayerNorm(dim)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio), dim, "gelu")

    def forward(self, x):
        b, h, w, c = x.shape
        shortcut = x
        x = self.norm1(x)
        ws = self.window_size
        if ws > 0:
            x, pad_hw = window_partition(x, ws)
        x = self.attn(x)
        if ws > 0:
            x = window_unpartition(x, ws, pad_hw, (h, w))
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class ImageEncoderViT(nn.Module):
    """Patch embedding, position embedding, `depth` blocks (those in
    `global_blocks` global, the others windowed), the neck. Returns (neck
    [B, h, w, out_chans] float32, the first global block's output float32)."""

    def __init__(self, img_size: int = 1024, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, window_size: int = 14,
                 global_blocks: Sequence[int] = (2, 5, 8, 11), out_chans: int = 256):
        super().__init__()
        if img_size % patch_size:
            raise ValueError(f"img_size {img_size} is not a multiple of the patch {patch_size}")
        self.depth = depth
        self.global_blocks = tuple(global_blocks)
        grid = img_size // patch_size
        self.patch_embed = Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, embed_dim))
        for i in range(depth):
            ws = 0 if i in self.global_blocks else window_size
            self.add_module(f"block_{i}", ViTBlock(embed_dim, num_heads, ws, grid))
        self.neck_0 = Conv2d(embed_dim, out_chans, 1, bias=False)
        self.neck_1 = LayerNorm2d(out_chans)
        self.neck_2 = Conv2d(out_chans, out_chans, 3, padding=1, bias=False)
        self.neck_3 = LayerNorm2d(out_chans)

    def forward(self, x):
        x = _conv(self.patch_embed, x)
        x = x + self.pos_embed.to(x.dtype)
        interm = None
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x)
            if i in self.global_blocks and interm is None:
                interm = x
        if interm is None:  # no global block in range (tiny configs)
            interm = x
        neck = self.neck_1(_conv(self.neck_0, x))
        neck = self.neck_3(_conv(self.neck_2, neck))
        return neck, interm.float()


class PromptEncoder(nn.Module):
    """The reference's PromptEncoder (embed_dim 256, mask_in_chans 16)."""

    def __init__(self, embed_dim: int = 256, mask_in_chans: int = 16,
                 input_image_size: int = 1024, image_embedding_size: int = 64):
        super().__init__()
        e, c = embed_dim, mask_in_chans
        self.embed_dim = e
        self.input_image_size = input_image_size
        self.image_embedding_size = image_embedding_size
        self.pe_gaussian = nn.Parameter(torch.zeros(2, e // 2))
        self.point_embeddings = nn.Parameter(torch.zeros(4, e))
        self.not_a_point_embed = nn.Parameter(torch.zeros(e))
        self.no_mask_embed = nn.Parameter(torch.zeros(e))
        self.mask_down_0 = Conv2d(1, c // 4, 2, stride=2)
        self.mask_ln_1 = LayerNorm2d(c // 4)
        self.mask_down_2 = Conv2d(c // 4, c, 2, stride=2)
        self.mask_ln_3 = LayerNorm2d(c)
        self.mask_proj = Conv2d(c, e, 1)

    def _pe_encoding(self, coords):
        """coords in [0, 1]^2, any leading shape -> [..., embed_dim]."""
        proj = (2.0 * coords - 1.0) @ self.pe_gaussian
        proj = 2.0 * np.pi * proj
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)

    def dense_pe(self):
        """[s, s, C] encoding of the embedding grid's cell centres, (x, y)."""
        s = self.image_embedding_size
        r = torch.arange(s, device=self.pe_gaussian.device)
        ys, xs = torch.meshgrid(r, r, indexing="ij")
        coords = (torch.stack([xs, ys], dim=-1).float() + 0.5) / s
        return self._pe_encoding(coords)

    def embed_points(self, points, labels, pad: bool = True):
        """points [B, P, 2] pixel (x, y), labels [B, P]: -1 pad, 0 negative,
        1 positive, 2 / 3 box corners. `pad` appends a pad point."""
        if pad:
            b = points.shape[0]
            points = torch.cat([points, points.new_zeros(b, 1, 2)], dim=1)
            labels = torch.cat([labels, -labels.new_ones(b, 1)], dim=1)
        pe = self._pe_encoding((points + 0.5) / self.input_image_size)
        is_pad = (labels == -1)[..., None]
        pe = torch.where(is_pad, self.not_a_point_embed, pe)
        table = torch.cat([torch.zeros_like(self.point_embeddings[:1]), self.point_embeddings])
        add = table[torch.clamp(labels + 1, 0, 4).long()]
        return pe + torch.where(is_pad, torch.zeros_like(add), add)

    def embed_boxes(self, boxes):
        """boxes [B, 4] XYXY pixels -> [B, 2, C] corner tokens."""
        pe = self._pe_encoding((boxes.reshape(-1, 2, 2) + 0.5) / self.input_image_size)
        return pe + self.point_embeddings[2:4][None]

    def embed_masks(self, masks):
        """masks [B, 4h, 4w, 1] -> the dense embedding [B, h, w, C] float32."""
        x = gelu_exact(self.mask_ln_1(_conv(self.mask_down_0, masks)))
        x = gelu_exact(self.mask_ln_3(_conv(self.mask_down_2, x)))
        return _conv(self.mask_proj, x).float()

    def no_mask_dense(self, b: int):
        s = self.image_embedding_size
        return self.no_mask_embed[None, None, None].expand(b, s, s, self.embed_dim)


class DownsampledAttention(nn.Module):
    """The two-way transformer's attention: q / k / v projected to
    dim / downsample_rate, logits and softmax in float32."""

    def __init__(self, dim: int, num_heads: int, downsample_rate: int = 1):
        super().__init__()
        c_in = dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = Dense(dim, c_in)
        self.k_proj = Dense(dim, c_in)
        self.v_proj = Dense(dim, c_in)
        self.out_proj = Dense(c_in, dim)

    def forward(self, q, k, v):
        nh = self.num_heads

        def split(x):
            b, n, c = x.shape
            return x.reshape(b, n, nh, c // nh).transpose(1, 2)

        q, k, v = split(self.q_proj(q)), split(self.k_proj(k)), split(self.v_proj(v))
        # a numpy float64 scalar in JAX: float32 (strong), so bfloat16 promotes
        scale = float(np.float32(np.sqrt(q.shape[-1])))
        attn = flax_softmax((q.float() / scale) @ k.float().transpose(-2, -1))
        out = (attn @ v.float()).transpose(1, 2)
        return self.out_proj(out.reshape(out.shape[0], out.shape[1], -1))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, dim: int = 256, num_heads: int = 8, mlp_dim: int = 2048,
                 skip_first_layer_pe: bool = False):
        super().__init__()
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = DownsampledAttention(dim, num_heads, 1)
        self.norm1 = TokenLayerNorm(dim, eps=1e-5)
        self.cross_attn_token_to_image = DownsampledAttention(dim, num_heads, 2)
        self.norm2 = TokenLayerNorm(dim, eps=1e-5)
        self.mlp = MLPBlock(dim, mlp_dim, dim, "relu")
        self.norm3 = TokenLayerNorm(dim, eps=1e-5)
        self.norm4 = TokenLayerNorm(dim, eps=1e-5)
        self.cross_attn_image_to_token = DownsampledAttention(dim, num_heads, 2)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, depth: int = 2, dim: int = 256, num_heads: int = 8, mlp_dim: int = 2048):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"layers_{i}", TwoWayAttentionBlock(dim, num_heads, mlp_dim,
                                                                skip_first_layer_pe=(i == 0)))
        self.final_attn_token_to_image = DownsampledAttention(dim, num_heads, 2)
        self.norm_final_attn = TokenLayerNorm(dim, eps=1e-5)

    def forward(self, image_embedding, image_pe, point_embedding):
        """image_embedding / image_pe [B, h, w, C]; point_embedding [B, N, C]."""
        b, h, w, c = image_embedding.shape
        keys = image_embedding.reshape(b, h * w, c)
        key_pe = image_pe.reshape(b, h * w, c)
        queries = point_embedding
        for i in range(self.depth):
            queries, keys = getattr(self, f"layers_{i}")(queries, keys, point_embedding, key_pe)
        q, k = queries + point_embedding, keys + key_pe
        queries = self.norm_final_attn(queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


def conv_transpose_2x2(x, weight, bias):
    """torch's ConvTranspose2d(k=2, s=2) on [B, h, w, C]: out[2i + k, 2j + l]
    = x[i, j] . K[k, l], the kernel NOT flipped (flax's nn.ConvTranspose, and
    layers.ConvTranspose2x2, read K[1 - k, 1 - l]). `weight` is [out, in, 2,
    2], K[k, l] = weight[:, :, k, l]; one product, the bias added after."""
    b, h, w, c = x.shape
    o = weight.shape[0]
    y = x @ weight.permute(1, 2, 3, 0).reshape(c, 4 * o)
    y = y.view(b, h, w, 2, 2, o).permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, o)
    return y + bias


class ConvTranspose2x2(layers.ConvTranspose2x2):
    """SAM's 2x2 stride-2 transposed convolution (conv_transpose_2x2) on
    channel-last tensors, in `compute_dtype`."""

    def forward(self, x):
        dt = self.compute_dtype
        return conv_transpose_2x2(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class MaskDecoderHQ(nn.Module):
    """The reference's MaskDecoderHQ (three multimask outputs)."""

    def __init__(self, dim: int = 256, num_multimask: int = 3, vit_dim: int = 768):
        super().__init__()
        c = dim
        nm = self.nm = num_multimask + 1  # SAM mask tokens
        self.iou_token = nn.Parameter(torch.zeros(1, c))
        self.mask_tokens = nn.Parameter(torch.zeros(nm, c))
        self.hf_token = nn.Parameter(torch.zeros(1, c))
        self.transformer = TwoWayTransformer(2, c, 8, 2048)
        self.up_0 = ConvTranspose2x2(c, c // 4)
        self.up_ln_1 = LayerNorm2d(c // 4)
        self.up_3 = ConvTranspose2x2(c // 4, c // 8)
        for i in range(nm):
            self.add_module(f"hyper_{i}", MLP(c, c, c // 8, 3))
        # over the 4 SAM tokens only: the reference builds it before the HQ token
        self.iou_head = MLP(c, c, nm, 3)
        self.hf_mlp = MLP(c, c, c // 8, 3)
        self.compress_vit_0 = ConvTranspose2x2(vit_dim, c)
        self.compress_vit_ln_1 = LayerNorm2d(c)
        self.compress_vit_3 = ConvTranspose2x2(c, c // 8)
        self.enc_0 = ConvTranspose2x2(c, c // 4)
        self.enc_ln_1 = LayerNorm2d(c // 4)
        self.enc_3 = ConvTranspose2x2(c // 4, c // 8)
        self.maskfeat_0 = Conv2d(c // 8, c // 4, 3, padding=1)
        self.maskfeat_ln_1 = LayerNorm2d(c // 4)
        self.maskfeat_3 = Conv2d(c // 4, c // 8, 3, padding=1)

    def hq_features(self, image_embed, interm):
        """embedding_encoder(image_embed) + compress_vit_feat(interm)."""
        e = self.enc_3(gelu_exact(self.enc_ln_1(self.enc_0(image_embed))))
        v = self.compress_vit_3(gelu_exact(self.compress_vit_ln_1(self.compress_vit_0(interm))))
        return e + v

    def forward(self, image_embed, image_pe, sparse_prompt, dense_prompt, interm,
                multimask_output: bool = False, hq_token_only: bool = False):
        """image_embed [B or 1, h, w, C]; image_pe [h, w, C]; sparse_prompt
        [B, N, C]; dense_prompt [B, h, w, C]; interm [B or 1, h, w, vit_dim].
        Returns (masks [B, 1, 4h, 4w], iou [B, 1], all_masks [B, nm + 1, 4h,
        4w]), float32."""
        b, h, w, c = dense_prompt.shape
        nm = self.nm
        dt = self.up_0.compute_dtype
        hq_feat = self.hq_features(image_embed, interm)
        tokens = torch.cat([self.iou_token[None].expand(b, 1, c),
                            self.mask_tokens[None].expand(b, nm, c),
                            self.hf_token[None].expand(b, 1, c), sparse_prompt], dim=1).to(dt)
        src = (image_embed + dense_prompt).to(dt)
        pe = image_pe[None].expand(b, h, w, c).to(dt)
        hs, keys = self.transformer(src, pe, tokens)
        iou_token_out = hs[:, 0]
        mask_tokens_out = hs[:, 1:nm + 2]

        up = gelu_exact(self.up_ln_1(self.up_0(keys.reshape(b, h, w, c))))
        up_sam = gelu_exact(self.up_3(up).float())
        up_hq = gelu_exact(self.maskfeat_ln_1(_conv(self.maskfeat_0, up_sam)))
        up_hq = _conv(self.maskfeat_3, up_hq).float() + hq_feat

        hypers = [getattr(self, f"hyper_{i}")(mask_tokens_out[:, i]) for i in range(nm)]
        hypers.append(self.hf_mlp(mask_tokens_out[:, nm]))
        hyper_in = torch.stack(hypers, dim=1).float()  # [B, nm + 1, C / 8]
        masks_sam = torch.einsum("bkc,bhwc->bkhw", hyper_in[:, :nm], up_sam)
        masks_hq = torch.einsum("bkc,bhwc->bkhw", hyper_in[:, nm:], up_hq)
        all_masks = torch.cat([masks_sam, masks_hq], dim=1)
        iou_pred = self.iou_head(iou_token_out).float()

        if multimask_output:
            sel = torch.argmax(iou_pred[:, 1:nm], dim=1) + 1
            masks_out = all_masks[torch.arange(b, device=sel.device), sel][:, None]
            iou_out = iou_pred.gather(1, sel[:, None])
        else:
            masks_out, iou_out = all_masks[:, :1], iou_pred[:, :1]
        hq_mask = all_masks[:, nm:nm + 1]
        masks_out = hq_mask if hq_token_only else masks_out + hq_mask
        return masks_out, iou_out, all_masks


class SAMHQ(nn.Module):
    """The whole model: encode once, decode per prompt. VIT_PRESETS give
    the reference's ViT-B / L / H; smaller configs keep tests fast."""

    def __init__(self, img_size: int = 1024, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, global_blocks: Sequence[int] = (2, 5, 8, 11),
                 window_size: int = 14):
        super().__init__()
        self.img_size = img_size
        self.image_encoder = ImageEncoderViT(
            img_size=img_size, embed_dim=embed_dim, depth=depth, num_heads=num_heads,
            global_blocks=global_blocks, window_size=window_size)
        self.prompt_encoder = PromptEncoder(input_image_size=img_size,
                                            image_embedding_size=img_size // 16)
        self.mask_decoder = MaskDecoderHQ(vit_dim=embed_dim)

    @classmethod
    def preset(cls, name: str, img_size: int = 1024) -> "SAMHQ":
        e, d, h, g = VIT_PRESETS[name]
        return cls(img_size=img_size, embed_dim=e, depth=d, num_heads=h, global_blocks=g)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random init from `generator` after init_sam_variables' flax
        initialisers: LeCun-normal kernels, zero biases, unit norms,
        position embedding N(0, 0.02^2), zero relative positions, the
        Fourier matrix, point / pad / no-mask embeddings and the output
        tokens N(0, 1)."""
        from quber_tpu_torch.models.msmformer import reset_flax_init

        reset_flax_init(self, generator)
        for mod in self.modules():
            if isinstance(mod, LayerNorm2d):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, ViTAttention):
                mod.rel_pos_h.zero_()
                mod.rel_pos_w.zero_()
        pe, dec = self.prompt_encoder, self.mask_decoder
        self.image_encoder.pos_embed.copy_(
            torch.randn(self.image_encoder.pos_embed.shape, generator=generator) * 0.02)
        for p in (pe.pe_gaussian, pe.point_embeddings, pe.not_a_point_embed, pe.no_mask_embed,
                  dec.iou_token, dec.mask_tokens, dec.hf_token):
            p.copy_(torch.randn(p.shape, generator=generator))

    def encode(self, image):
        """image [B, S, S, 3], pixel-normalised -> (embed, interm)."""
        return self.image_encoder(image)

    def _decode(self, image_embed, interm, sparse, dense, multimask_output, hq_token_only):
        return self.mask_decoder(image_embed, self.prompt_encoder.dense_pe(), sparse, dense,
                                 interm, multimask_output, hq_token_only)

    def decode(self, image_embed, interm, mask_prompt, multimask_output: bool = False,
               hq_token_only: bool = False):
        """Mask prompts [B, 4h, 4w, 1] (the fine-tuned wrapper's)."""
        dense = self.prompt_encoder.embed_masks(mask_prompt)
        sparse = dense.new_zeros(dense.shape[0], 0, self.prompt_encoder.embed_dim)
        return self._decode(image_embed, interm, sparse, dense, multimask_output, hq_token_only)

    def decode_points(self, image_embed, interm, points, labels, multimask_output: bool = False,
                      hq_token_only: bool = False, pad: bool = True):
        """points [B, P, 2] pixel (x, y) in the img_size frame, labels [B, P];
        `pad` appends the not-a-point token (the reference pads point-only
        prompts, not box prompts)."""
        sparse = self.prompt_encoder.embed_points(points, labels, pad=pad)
        dense = self.prompt_encoder.no_mask_dense(points.shape[0])
        return self._decode(image_embed, interm, sparse, dense, multimask_output, hq_token_only)

    def decode_box(self, image_embed, interm, boxes, multimask_output: bool = False,
                   hq_token_only: bool = False):
        """boxes [B, 4] XYXY pixels."""
        sparse = self.prompt_encoder.embed_boxes(boxes)
        dense = self.prompt_encoder.no_mask_dense(boxes.shape[0])
        return self._decode(image_embed, interm, sparse, dense, multimask_output, hq_token_only)

    def forward(self, image, mask_prompt):
        return self.decode(*self.encode(image), mask_prompt)


def sam_hq_mask_loss(hq_logit, target, focal_weight: float = 20.0, dice_weight: float = 1.0):
    """Focal + dice mask loss of the reference's fine-tuning recipe (means
    over every element and every mask)."""
    p = torch.sigmoid(hq_logit)
    t = target.float()
    ce = torch.maximum(hq_logit, torch.zeros_like(hq_logit)) - hq_logit * t + \
        torch.log1p(torch.exp(-hq_logit.abs()))
    pt = p * t + (1 - p) * (1 - t)
    focal = (ce * (1 - pt) ** 2).mean()
    inter = (p * t).sum(dim=(-2, -1))
    denom = p.sum(dim=(-2, -1)) + t.sum(dim=(-2, -1))
    dice = (1 - (2 * inter + 1) / (denom + 1)).mean()
    return focal_weight * focal + dice_weight * dice

"""SAM-HQ in the port (models/sam_hq.py, import_zoo.import_sam_hq) against
the JAX package's (quber_tpu/models/sam_hq.py, import_zoo.import_sam_hq) on
the CPU.

Two tiny configs, both padding their windows: img 64 (a 4x4 grid) with
window 3 (padded to 6) and the first global block at 1, and window 3 with
block 0 global. The JAX variables are init_sam_variables' with every leaf
moved by seeded noise (relative positions and biases are zero at init),
carried over by models/from_jax. Tolerances: encode, decode, decode_points
(padded or not, single or multimask) and decode_box in float32 within 1e-5
of max |JAX| per output; both layer norms 1e-5; the transposed convolution within 1e-6 (an
asymmetric kernel, on which flax's kernel-flipping form of
layers.ConvTranspose2x2 is off by the kernel's scale); the loss rtol 1e-5
and its gradient within 1e-5 of max |JAX|; bfloat16 GELU at most 0.1% of
the elements one bfloat16 step off jitted JAX's (which keeps erfc's argument
in float32); the bfloat16 forward's mean
distance from float32 within 0.5-2x jitted JAX bfloat16's, and its mean
distance to JAX's bfloat16 below twice JAX's from float32; the ViT-B / L / H
parameter shapes (built on the meta device) equal to jax.eval_shape's;
import_sam_hq bit-equal to JAX's import carried over.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quber_tpu.models import import_zoo as JI
from quber_tpu.models import sam_hq as J
from quber_tpu_torch.models import import_zoo as TI
from quber_tpu_torch.models import sam_hq as T
from quber_tpu_torch.models.from_jax import state_dict_from_jax, state_dict_to_jax
from quber_tpu_torch.models.layers import ConvTranspose2x2 as FlaxConvTranspose
from quber_tpu_torch.models.layers import set_compute_dtype

F32_RTOL = 1e-5
OP_ATOL = 1e-6
BF16_LOW, BF16_HIGH = 0.5, 2.0
CONFIGS = {
    "global block 1": dict(img_size=64, embed_dim=32, depth=3, num_heads=2, global_blocks=(1,),
                           window_size=3),
    "global block 0": dict(img_size=64, embed_dim=32, depth=2, num_heads=2, global_blocks=(0,),
                           window_size=3),
}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_variables(name, seed):
    cfg = CONFIGS[name]
    v = jax.jit(lambda k: J.init_sam_variables(J.SAMHQ(**cfg), k))(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.randn(*a.shape)).astype(np.float32),
                        v)


def jax_variables(name, seed=0):
    """CONFIGS[name]'s init_sam_variables tree with every leaf moved by
    N(0, 0.05^2) (computed once; the tests do not write to it)."""
    return _jax_variables(name, seed)


def port(v, cfg, dtype=torch.float32):
    model = T.SAMHQ(**cfg).eval()
    model.load_state_dict(state_dict_from_jax(v), strict=True)
    set_compute_dtype(model, dtype)
    return model


def _inputs(seed=1):
    """A batch of 2: images, mask prompts, points (a pad label among them),
    boxes."""
    rng = np.random.RandomState(seed)
    return {"img": rng.randn(2, 64, 64, 3).astype(np.float32),
            "prompt": ((rng.rand(2, 16, 16, 1) > 0.5) * 20.0 - 10.0).astype(np.float32),
            "points": (rng.rand(2, 3, 2) * 64).astype(np.float32),
            "labels": np.array([[1, 0, -1], [1, 1, 2]], np.int32),
            "boxes": np.sort(rng.rand(2, 2, 2) * 64, axis=1).reshape(2, 4).astype(np.float32)}


PATHS = ["mask hq=False", "mask hq=True"] + [
    f"points pad={pad} multimask={mm}" for pad in (True, False) for mm in (False, True)] + [
    "box multimask", "one embedding, 2 mask prompts"]


def _jax_decodes(jm, v, e, i, x):
    """{path: outputs} of every decode path and its flags, in one jit."""
    @jax.jit
    def run(v, e, i, x):
        out = {f"mask hq={hq}": jm.apply(v, e, i, x["prompt"], False, hq, method=J.SAMHQ.decode)
               for hq in (False, True)}
        for pad in (True, False):
            for mm in (False, True):
                out[f"points pad={pad} multimask={mm}"] = jm.apply(
                    v, e, i, x["points"], x["labels"], mm, False, pad,
                    method=J.SAMHQ.decode_points)
        out["box multimask"] = jm.apply(v, e, i, x["boxes"], True, False,
                                        method=J.SAMHQ.decode_box)
        # the wrappers' form: one image's embedding, the prompts vmapped
        one = jax.vmap(lambda p: jm.apply(v, e[:1], i[:1], p[None], False, True,
                                          method=J.SAMHQ.decode))(x["prompt"])
        out["one embedding, 2 mask prompts"] = tuple(o[:, 0] for o in one)
        return out

    return run(v, e, i, x)


def _port_decode(model, path, e, i, x):
    if path.startswith("mask"):
        return model.decode(e, i, x["prompt"], False, path.endswith("True"))
    if path.startswith("points"):
        pad, mm = "pad=True" in path, "multimask=True" in path
        return model.decode_points(e, i, x["points"], x["labels"], mm, False, pad)
    if path.startswith("box"):
        return model.decode_box(e, i, x["boxes"], True, False)
    return model.decode(e[:1], i[:1], x["prompt"], False, True)


def _close(got, want, rtol=F32_RTOL, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_encode_and_every_decode_path_match_jax(name):
    """Every decode path on the first config; on the second (global block
    0, no interm from a later block) the encoder and the mask decode."""
    cfg = CONFIGS[name]
    v, x = jax_variables(name), _inputs()
    jm = J.SAMHQ(**cfg)
    je, ji = jax.jit(lambda v, img: jm.apply(v, img, method=J.SAMHQ.encode))(v, x["img"])
    paths = PATHS if name == "global block 1" else ["mask hq=True"]
    if name == "global block 1":
        want = _jax_decodes(jm, v, je, ji, {k: a for k, a in x.items() if k != "img"})
        assert sorted(want) == sorted(PATHS)
    else:
        want = {paths[0]: jax.jit(lambda v, e, i, p: jm.apply(
            v, e, i, p, False, True, method=J.SAMHQ.decode))(v, je, ji, x["prompt"])}
    model = port(v, cfg)
    tx = {k: torch.from_numpy(a) for k, a in x.items()}
    with torch.no_grad():
        te, ti = model.encode(tx["img"])
        _close(te, je, what="embed")
        _close(ti, ji, what="interm")
        for path in paths:
            got = _port_decode(model, path, te, ti, tx)
            assert len(got) == len(want[path]) == 3
            for k, (a, b) in enumerate(zip(got, want[path])):
                assert a.shape == b.shape, (path, k)
                _close(a, b, what=f"{path} output {k}")


def test_variables_round_trip():
    v = jax_variables("global block 1")
    back = state_dict_to_jax(port(v, CONFIGS["global block 1"]))
    flat = lambda t: dict(jax.tree_util.tree_leaves_with_path(t))  # noqa: E731
    assert set(flat(back)) == set(flat(v))
    for k, a in flat(v).items():
        np.testing.assert_array_equal(flat(back)[k], a)


def test_transposed_convolution_does_not_flip_its_kernel():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 5, 7, 6).astype(np.float32)
    kernel = rng.randn(2, 2, 6, 4).astype(np.float32) + np.arange(4).reshape(2, 2, 1, 1) * 3
    bias = rng.randn(4).astype(np.float32)
    want = np.asarray(J.conv_transpose_2x2(x, kernel, bias))
    weight = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())  # from_jax's kernel layout
    sam, flax_form = T.ConvTranspose2x2(6, 4), FlaxConvTranspose(6, 4)
    with torch.no_grad():
        for m in (sam, flax_form):
            m.weight.copy_(weight)
            m.bias.copy_(torch.from_numpy(bias))
        got = sam(torch.from_numpy(x)).numpy()
        flipped = flax_form(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=OP_ATOL * np.abs(want).max())
    assert np.abs(flipped - want).max() > 1.0


def test_both_layer_norms_match_their_flax_forms():
    import flax.linen as nn

    rng = np.random.RandomState(3)
    x = (rng.randn(4, 5, 16) + 3).astype(np.float32)
    w, b = rng.randn(16).astype(np.float32), rng.randn(16).astype(np.float32)
    want2d = np.asarray(J.layer_norm_2d(x, w, b))
    got2d = T.layer_norm_2d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    _close(got2d, want2d, what="LayerNorm2d")
    ln = nn.LayerNorm(epsilon=1e-5)
    variables = {"params": {"scale": w, "bias": b}}
    norm = T.TokenLayerNorm(16, eps=1e-5)
    set_compute_dtype(norm, torch.bfloat16)  # a model's type does not reach it
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(w))
        norm.bias.copy_(torch.from_numpy(b))
        for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
            want = ln.apply(variables, jnp.asarray(x, jdt))
            got = norm(torch.from_numpy(x).to(dt))
            assert got.dtype == torch.float32 and want.dtype == jnp.float32
            _close(got, want, what=str(dt))


def test_exact_gelu_matches_jax():
    import flax.linen as nn

    x = np.random.RandomState(4).randn(4, 64, 64).astype(np.float32) * 3
    gelu = jax.jit(lambda a: nn.gelu(a, approximate=False))
    got = T.gelu_exact(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(gelu(x)), rtol=0, atol=OP_ATOL)
    want = np.asarray(gelu(jnp.asarray(x, jnp.bfloat16)), np.float32)
    got = T.gelu_exact(torch.from_numpy(x).bfloat16()).float().numpy()
    off = got != want
    # erfc's float32 approximations differ by an ulp, rarely a bfloat16 step
    assert off.mean() <= 0.001
    # (below 1e-37 XLA's erfc flushes its subnormal products to zero)
    step = 2 ** -7 * np.abs(want)[off] * 1.01 + 1e-37
    assert np.all(np.abs(got - want)[off] <= step)
    # rounding -x * sqrt(0.5) before erfc, as JAX op by op does, is off on a third
    c = torch.tensor(np.sqrt(0.5), dtype=torch.bfloat16)
    t = torch.from_numpy(x).bfloat16()
    stepwise = ((0.5 * t) * torch.special.erfc(-t * c)).float().numpy()
    assert (stepwise != want).mean() > 0.2


def test_mask_loss_and_its_gradient_match_jax():
    rng = np.random.RandomState(5)
    logit = (rng.randn(3, 16, 16) * 4).astype(np.float32)
    target = (rng.rand(3, 16, 16) > 0.6).astype(np.float32)
    want, want_grad = jax.value_and_grad(J.sam_hq_mask_loss)(jnp.asarray(logit), target)
    t = torch.from_numpy(logit).requires_grad_(True)
    got = T.sam_hq_mask_loss(t, torch.from_numpy(target))
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=F32_RTOL)
    _close(t.grad, want_grad, what="gradient")


def test_bfloat16_follows_jitted_jax_bfloat16():
    """The wrappers' form (one embedding, a batch of 16 mask prompts), jitted
    as the JAX wrappers run it."""
    cfg = CONFIGS["global block 1"]
    v, x = jax_variables("global block 1"), _inputs()
    prompt = ((np.random.RandomState(7).rand(16, 16, 16, 1) > 0.5) * 20.0 - 10.0
              ).astype(np.float32)
    jm, jb = J.SAMHQ(**cfg), J.SAMHQ(**cfg, dtype=jnp.bfloat16)

    def run(m):
        @jax.jit
        def f(v, img, prompt):
            e, i = m.apply(v, img, method=J.SAMHQ.encode)
            out = jax.vmap(lambda p: m.apply(v, e[:1], i[:1], p[None], False, True,
                                             method=J.SAMHQ.decode))(prompt)
            return (e, i) + tuple(o[:, 0] for o in out)
        return [np.asarray(a, np.float32) for a in f(v, x["img"], prompt)]

    want32, want16 = run(jm), run(jb)
    with torch.no_grad():
        model = port(v, cfg, torch.bfloat16)
        e, i = model.encode(torch.from_numpy(x["img"]))
        got = [t.float().numpy() for t in
               (e, i) + model.decode(e[:1], i[:1], torch.from_numpy(prompt), False, True)]
    for k, (g, a, b) in enumerate(zip(got, want16, want32)):
        jax_err = np.abs(a - b).mean()
        err = np.abs(g - b).mean()
        assert jax_err > 0, k
        assert BF16_LOW * jax_err < err < BF16_HIGH * jax_err, (k, err, jax_err)
        assert np.abs(g - a).mean() < 2 * jax_err, (k, np.abs(g - a).mean(), jax_err)


@pytest.mark.parametrize("preset", ["vit_b", "vit_l", "vit_h"])
def test_preset_parameter_shapes_match_jax(preset):
    """The port built on the meta device (nothing allocated) against
    jax.eval_shape of init_sam_variables, through from_jax's layouts."""
    shapes = jax.eval_shape(lambda k: J.init_sam_variables(J.SAMHQ.preset(preset), k),
                            jax.random.PRNGKey(0))
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(shapes):
        keys = [p.key for p in path]
        shape = tuple(leaf.shape)
        if keys[-1] == "kernel":
            shape = (shape[3], shape[2], shape[0], shape[1]) if len(shape) == 4 else shape[::-1]
        leaf_name = {"kernel": "weight", "scale": "weight"}.get(keys[-1], keys[-1])
        want[".".join(keys[1:-1] + [leaf_name])] = shape
    with torch.device("meta"):
        model = T.SAMHQ.preset(preset)
    got = {k: tuple(p.shape) for k, p in model.state_dict().items()}
    assert got == want
    e, d, h, g = T.VIT_PRESETS[preset]
    assert (e, d, h, g) == J.VIT_PRESETS[preset]


def reference_state_dict(depth, embed, heads, img_size=64, window=3, global_blocks=(1,),
                         seed=6):
    """A seeded state dict in the reference's Sam layout (image_encoder,
    prompt_encoder, mask_decoder = MaskDecoderHQ, the pixel buffers), as
    torch's modules name and shape it."""
    rng = np.random.RandomState(seed)
    grid, c, hd = img_size // 16, 256, embed // heads
    shapes = {"image_encoder.patch_embed.proj.weight": (embed, 3, 16, 16),
              "image_encoder.patch_embed.proj.bias": (embed,),
              "image_encoder.pos_embed": (1, grid, grid, embed)}
    for i in range(depth):
        t, s = f"image_encoder.blocks.{i}", grid if i in global_blocks else window
        shapes.update({f"{t}.norm1.weight": (embed,), f"{t}.norm1.bias": (embed,),
                       f"{t}.norm2.weight": (embed,), f"{t}.norm2.bias": (embed,),
                       f"{t}.attn.qkv.weight": (3 * embed, embed), f"{t}.attn.qkv.bias": (3 * embed,),
                       f"{t}.attn.proj.weight": (embed, embed), f"{t}.attn.proj.bias": (embed,),
                       f"{t}.attn.rel_pos_h": (2 * s - 1, hd), f"{t}.attn.rel_pos_w": (2 * s - 1, hd),
                       f"{t}.mlp.lin1.weight": (4 * embed, embed), f"{t}.mlp.lin1.bias": (4 * embed,),
                       f"{t}.mlp.lin2.weight": (embed, 4 * embed), f"{t}.mlp.lin2.bias": (embed,)})
    shapes.update({"image_encoder.neck.0.weight": (c, embed, 1, 1),
                   "image_encoder.neck.1.weight": (c,), "image_encoder.neck.1.bias": (c,),
                   "image_encoder.neck.2.weight": (c, c, 3, 3),
                   "image_encoder.neck.3.weight": (c,), "image_encoder.neck.3.bias": (c,)})
    p = "prompt_encoder"
    shapes.update({f"{p}.pe_layer.positional_encoding_gaussian_matrix": (2, c // 2),
                   f"{p}.not_a_point_embed.weight": (1, c), f"{p}.no_mask_embed.weight": (1, c),
                   **{f"{p}.point_embeddings.{i}.weight": (1, c) for i in range(4)},
                   f"{p}.mask_downscaling.0.weight": (4, 1, 2, 2), f"{p}.mask_downscaling.0.bias": (4,),
                   f"{p}.mask_downscaling.1.weight": (4,), f"{p}.mask_downscaling.1.bias": (4,),
                   f"{p}.mask_downscaling.3.weight": (16, 4, 2, 2), f"{p}.mask_downscaling.3.bias": (16,),
                   f"{p}.mask_downscaling.4.weight": (16,), f"{p}.mask_downscaling.4.bias": (16,),
                   f"{p}.mask_downscaling.6.weight": (c, 16, 1, 1), f"{p}.mask_downscaling.6.bias": (c,)})
    d = "mask_decoder"

    def linear(key, n_in, n_out):
        shapes.update({f"{key}.weight": (n_out, n_in), f"{key}.bias": (n_out,)})

    def norm(key, n):
        shapes.update({f"{key}.weight": (n,), f"{key}.bias": (n,)})

    def attn(key, rate):
        for proj in ("q_proj", "k_proj", "v_proj"):
            linear(f"{key}.{proj}", c, c // rate)
        linear(f"{key}.out_proj", c // rate, c)

    def conv_t(key, n_in, n_out):  # torch ConvTranspose2d: [in, out, 2, 2]
        shapes.update({f"{key}.weight": (n_in, n_out, 2, 2), f"{key}.bias": (n_out,)})

    shapes.update({f"{d}.iou_token.weight": (1, c), f"{d}.mask_tokens.weight": (4, c),
                   f"{d}.hf_token.weight": (1, c)})
    for i in range(2):
        t = f"{d}.transformer.layers.{i}"
        attn(f"{t}.self_attn", 1)
        attn(f"{t}.cross_attn_token_to_image", 2)
        attn(f"{t}.cross_attn_image_to_token", 2)
        for j in range(1, 5):
            norm(f"{t}.norm{j}", c)
        linear(f"{t}.mlp.lin1", c, 2048)
        linear(f"{t}.mlp.lin2", 2048, c)
    attn(f"{d}.transformer.final_attn_token_to_image", 2)
    norm(f"{d}.transformer.norm_final_attn", c)
    conv_t(f"{d}.output_upscaling.0", c, c // 4)
    norm(f"{d}.output_upscaling.1", c // 4)
    conv_t(f"{d}.output_upscaling.3", c // 4, c // 8)
    for head, n_out in [(f"output_hypernetworks_mlps.{i}", c // 8) for i in range(4)] + [
            ("iou_prediction_head", 4), ("hf_mlp", c // 8)]:
        for j in range(3):
            linear(f"{d}.{head}.layers.{j}", c, n_out if j == 2 else c)
    conv_t(f"{d}.compress_vit_feat.0", embed, c)
    norm(f"{d}.compress_vit_feat.1", c)
    conv_t(f"{d}.compress_vit_feat.3", c, c // 8)
    conv_t(f"{d}.embedding_encoder.0", c, c // 4)
    norm(f"{d}.embedding_encoder.1", c // 4)
    conv_t(f"{d}.embedding_encoder.3", c // 4, c // 8)
    shapes.update({f"{d}.embedding_maskfeature.0.weight": (c // 4, c // 8, 3, 3),
                   f"{d}.embedding_maskfeature.0.bias": (c // 4,),
                   f"{d}.embedding_maskfeature.3.weight": (c // 8, c // 4, 3, 3),
                   f"{d}.embedding_maskfeature.3.bias": (c // 8,)})
    norm(f"{d}.embedding_maskfeature.1", c // 4)
    shapes.update({"pixel_mean": (3, 1, 1), "pixel_std": (3, 1, 1)})
    return {k: torch.from_numpy(rng.randn(*s).astype(np.float32)) for k, s in shapes.items()}


def test_import_sam_hq_matches_jax_import():
    cfg = CONFIGS["global block 1"]
    sd = reference_state_dict(cfg["depth"], cfg["embed_dim"], cfg["num_heads"])
    got = TI.import_sam_hq(sd)
    want = state_dict_from_jax(JI.import_sam_hq({k: v.numpy() for k, v in sd.items()}))
    assert set(got) == set(want)
    for k, w in want.items():
        assert torch.equal(got[k], w), k
    model = T.SAMHQ(**cfg)
    model.load_state_dict(got, strict=True)  # every tensor of the module, in its layout
    # the ViT depth read off the keys; a key left unmapped is refused
    assert set(TI.import_sam_hq(sd, depth=cfg["depth"])) == set(got)
    with pytest.raises(KeyError, match="unmapped"):
        TI.import_sam_hq(dict(sd, extra=torch.zeros(1)))

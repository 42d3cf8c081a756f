"""The port's bfloat16 forward against the JAX package's, on the CPU.

MaskRefinerConfig(dtype="bfloat16") runs every convolution in bfloat16 with
float32 parameters, and the norms return float32, in both packages. The two
frameworks round bfloat16 at different places (XLA's and oneDNN's kernels),
so the port's bf16 output is not held to JAX's bf16 output but to how far
either lies from float32. Tolerance, per output: max |port bf16 - JAX f32|
<= 2 * max |JAX bf16 - JAX f32| + FLOOR, with FLOOR = 0.02 times the output's
largest magnitude in float32 (one bfloat16 rounding of a value is up to 2^-8
of it; a floor covers outputs that JAX's bf16 happens to get almost exactly).
The float32 forward stays the float32 forward: within 1e-4, as in
tests/test_torch_layers.py.

Closer than that: the port rounds where flax rounds, so its bf16 output lies
nearer JAX's bf16 output than bf16 lies from float32 -- mean |port bf16 -
JAX bf16| below FOLLOW (0.8) times mean |JAX bf16 - JAX f32| on every output
(the port reads 0.51-0.65 here; accumulation order alone moves a few roundings
per layer). Three wrong forwards read >= 0.99 on every output and fail it: the
float32 forward, float16 convolutions, and FrozenBN run in float32 (the
trunks left in float32). Rounding the GroupNorm outputs to bf16 is no such
control: the ReLU and the next convolution's cast make it the same forward.
"""

import numpy as np
import pytest
import torch

from quber_tpu.models.mask_refiner import MaskRefiner as JMaskRefiner
from quber_tpu.models.mask_refiner import MaskRefinerConfig as JConfig
from quber_tpu_torch.models.mask_refiner import MaskRefiner as TMaskRefiner
from quber_tpu_torch.models.mask_refiner import MaskRefinerConfig as TConfig
from test_torch_layers import init_pair, nchw

torch.set_num_threads(2)

CFG = dict(height=64, width=96, resnet_depth=14)
FLOOR_SHARE = 0.02
F32_ATOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    """Seeded inputs and weights; the JAX forward in float32 and bfloat16."""
    rng = np.random.RandomState(21)
    image = (rng.rand(2, 64, 96, 6) * 255).astype(np.float32)
    enc = rng.randn(2, 64, 96, 3).astype(np.float32) * 0.2
    jmod = JMaskRefiner(JConfig(**CFG))
    variables, _ = init_pair(jmod, TMaskRefiner(TConfig(**CFG)), image, enc, seed=3)
    want32 = {k: np.asarray(v) for k, v in jmod.apply(variables, image, enc).items()}
    jbf16 = JMaskRefiner(JConfig(**CFG, dtype="bfloat16"))
    want16 = {k: np.asarray(v) for k, v in jbf16.apply(variables, image, enc).items()}
    return variables, image, enc, want32, want16


FOLLOW = 0.8


class _Float32FrozenBN(torch.nn.Module):
    """A wrong bf16 forward: FrozenBN that returns float32 (the trunks then run
    their additions in float32)."""

    def __init__(self, norm):
        super().__init__()
        self.norm = norm

    def forward(self, x):
        return self.norm(x.float())


def _port(variables, image, enc, dtype, variant="port"):
    from quber_tpu_torch.models import layers as TL
    from quber_tpu_torch.models.from_jax import state_dict_from_jax

    model = TMaskRefiner(TConfig(**CFG, dtype=dtype))
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    for parent in list(model.modules()):
        for name, child in parent.named_children():
            if variant == "float16" and isinstance(child, TL.Conv2d):
                child.compute_dtype = torch.float16
            if variant == "float32_frozen_bn" and isinstance(child, TL.FrozenBatchNorm):
                setattr(parent, name, _Float32FrozenBN(child))
    with torch.no_grad():
        out = model.eval()(nchw(image), nchw(enc))
    return {k: v.numpy().transpose(0, 2, 3, 1) for k, v in out.items()}


def test_bf16_forward_within_twice_the_jax_bf16_error(pair):
    variables, image, enc, want32, want16 = pair
    got = _port(variables, image, enc, "bfloat16")
    assert set(got) == set(want32)
    for k, ref in want32.items():
        assert got[k].dtype == np.float32 and got[k].shape == ref.shape
        jax_err = float(np.abs(want16[k] - ref).max())
        port_err = float(np.abs(got[k] - ref).max())
        limit = 2 * jax_err + FLOOR_SHARE * float(np.abs(ref).max())
        assert np.isfinite(got[k]).all()
        assert jax_err > 0, k  # the JAX forward did run in bfloat16
        assert port_err <= limit, (k, port_err, jax_err, limit)


@pytest.mark.parametrize("variant,dtype,follows", [
    ("port", "bfloat16", True),
    ("port", "float32", False),
    ("float16", "bfloat16", False),
    ("float32_frozen_bn", "bfloat16", False),
])
def test_bf16_forward_follows_jax_bf16(pair, variant, dtype, follows):
    variables, image, enc, want32, want16 = pair
    got = _port(variables, image, enc, dtype, variant)
    ratios = {k: float(np.abs(got[k] - want16[k]).mean() / np.abs(want16[k] - ref).mean())
              for k, ref in want32.items()}
    assert all(r < FOLLOW for r in ratios.values()) == follows, ratios
    if not follows:
        assert all(r >= FOLLOW for r in ratios.values()), ratios


def test_bf16_is_not_float32(pair):
    """The port's bf16 forward does compute in bfloat16: it moves every
    output off float32 by more than float32 summation order could."""
    variables, image, enc, want32, _ = pair
    got = _port(variables, image, enc, "bfloat16")
    for k, ref in want32.items():
        assert float(np.abs(got[k] - ref).max()) > 10 * F32_ATOL, k


def test_float32_forward_unchanged(pair):
    variables, image, enc, want32, _ = pair
    got = _port(variables, image, enc, "float32")
    for k, ref in want32.items():
        np.testing.assert_allclose(got[k], ref, rtol=F32_ATOL, atol=F32_ATOL, err_msg=k)


def test_bf16_layers_follow_flax_types():
    """Convolutions return the compute type, FrozenBN keeps its input's type,
    GroupNorm and BatchNorm return float32 (flax modules without a dtype)."""
    from quber_tpu_torch.models import layers as TL

    x = torch.randn(1, 32, 8, 8).to(torch.bfloat16)
    conv = TL.ConvNorm(32, 32, 3, norm="FrozenBN")
    conv.conv.compute_dtype = torch.bfloat16
    assert conv(x).dtype == torch.bfloat16
    assert conv.conv.weight.dtype == torch.float32
    for norm in ("GN", "BN"):
        assert TL.make_norm(norm, 32).eval()(x).dtype == torch.float32
    model = TMaskRefiner(TConfig(**CFG, dtype="bfloat16"))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert {m.compute_dtype for m in model.modules() if isinstance(m, TL.Conv2d)} == {
        torch.bfloat16}

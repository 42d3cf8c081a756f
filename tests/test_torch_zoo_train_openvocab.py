"""train_zoo_torch.py --model detic against tools/train_zoo.py's recipe
(train_detic) at a small size: 64x64 scenes of make_detic_scenes, the
recipe's text tower and detector at their widths, the detector in float32
(the recipe runs it in bfloat16, whose roundings the two frameworks place
differently). tests/test_torch_zoo_train_gsam.py holds --model gsam.

The pools: equal to the reference's, and gsam's SAM frames, boxes and 64x64
targets equal to the reference's OpenCV resizes. One step from the port's
seeded init carried to the reference with state_dict_to_jax (the same tree
the reference's Adam takes): the total loss and each part rtol 1e-3 (abs
1e-6 for a zero part), and every gradient with cosine >= 0.999 against
jax.value_and_grad's (a gradient below a thousandth of the largest only
held below that bound). Then the CLI: a CPU step writes the checkpoint
tree and vocab.json, which build_base_model loads by name.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quber_tpu.models import open_vocab as JO
from quber_tpu_torch.evaluation import base_models as tbase
from quber_tpu_torch.models.from_jax import state_dict_from_jax, state_dict_to_jax
from quber_tpu_torch.models.layers import set_compute_dtype

_TOOL = os.path.join(os.path.dirname(__file__), "..", "tools", "train_zoo.py")
_spec = importlib.util.spec_from_file_location("jax_train_zoo", _TOOL)
jzoo = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jzoo)

H = W = 64
LR = 1e-4
SEED = 7
LOSS_RTOL = 1e-3
GRAD_COSINE = 0.999


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pools():
    """(the reference's detic pool, the port's gsam pool: both from SEED)."""
    import train_zoo_torch

    return (jzoo.make_detic_scenes(2, H, W, SEED, (250, 1500)),
            train_zoo_torch.make_gsam_scenes(2, H, W, SEED, (250, 1500)))


def test_pools_match_the_reference(pools):
    cv2 = pytest.importorskip("cv2")
    import train_zoo_torch

    from quber_tpu.models.sam_refiner import SAM_PIXEL_MEAN, SAM_PIXEL_STD

    want, got = pools
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert train_zoo_torch.COLOR_VOCAB == jzoo.COLOR_VOCAB
    for rgb in ((200, 30, 30), (30, 30, 200), (128, 128, 130), (10, 250, 250), (0, 0, 0)):
        assert train_zoo_torch._color_class(rgb) == jzoo._color_class(rgb)
    s, q = jzoo.SAMHQ_SYNTH_ARCH["img_size"], jzoo.SAMHQ_SYNTH_ARCH["img_size"] // 4
    for i in range(2):
        img = (cv2.resize(want["bgr"][i][..., ::-1], (s, s)) - SAM_PIXEL_MEAN) / SAM_PIXEL_STD
        np.testing.assert_array_equal(got["sam_img"][i], img.astype(np.float32))
        boxes = want["boxes"][i] * np.asarray([s / W, s / H, s / W, s / H], np.float32)
        np.testing.assert_array_equal(got["sam_boxes"][i], boxes)
        tgt = np.stack([cv2.resize(m, (q, q)) for m in want["masks"][i]])
        np.testing.assert_array_equal(got["sam_tgt"][i], tgt)


def _cosines(model, want):
    """{parameter: cosine of its gradient with the reference's} over the
    gradients above a thousandth of the largest; the others must stay
    below that."""
    noise = 1e-3 * max(float(g.norm()) for g in want.values())
    out = {}
    for name, p in model.named_parameters():
        g = want[name].double()
        got = p.grad.double() if p.grad is not None else torch.zeros_like(g)
        if float(g.norm()) <= noise:
            assert float(got.norm()) <= noise, name
            continue
        out[name] = float(torch.nn.functional.cosine_similarity(got.flatten(), g.flatten(),
                                                                  dim=0))
    return out


def jax_recipe_step(model, key, vocab, pool, scene):
    """(loss, parts, gradients as the port's state dict names them) of the
    reference recipe's jstep on `scene` of `pool` (the reference's staged
    make_detic_scenes pool) at the port model's weights: its text tower and
    the float32 DeticDetector under `key`."""
    ids, mask = JO.hash_tokenize(vocab)
    params = {"text": state_dict_to_jax(model["text"]), "detector": state_dict_to_jax(model[key])}
    detector = JO.DeticDetector()
    staged = {k: jnp.asarray(v) for k, v in pool.items()}  # the recipe's _stage

    def loss_fn(p):
        embeds = JO.TextEncoder().apply(p["text"], ids, mask)
        out = detector.apply(p["detector"], staged["bgr"][scene][None], embeds,
                             gt_proposals=jnp.where(staged["valid"][scene][:, None],
                                                    staged["boxes"][scene], 0.0))
        losses = JO.detic_losses(out, staged["boxes"][scene], staged["classes"][scene],
                                 staged["masks"][scene], staged["valid"][scene])
        return sum(losses.values()), losses

    (loss, parts), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    want = {f"text.{k}": v for k, v in state_dict_from_jax(grads["text"]).items()}
    want.update({f"{key}.{k}": v for k, v in state_dict_from_jax(grads["detector"]).items()})
    return float(loss), {k: float(v) for k, v in parts.items()}, want


def check_step(model, got, want):
    """The port's step (loss, parts) and the gradients it left against the
    reference's."""
    (got_loss, got_parts), (loss, parts, grads) = got, want
    assert float(got_loss) == pytest.approx(loss, rel=LOSS_RTOL)
    assert set(got_parts) == set(parts)
    for k, v in parts.items():
        assert float(got_parts[k]) == pytest.approx(v, rel=LOSS_RTOL, abs=1e-6), k
    cos = _cosines(model, grads)
    worst = min(cos, key=cos.get)
    assert cos[worst] >= GRAD_COSINE, (worst, cos[worst])
    assert len(cos) > 100 and any(k.startswith("text.") for k in cos)
    assert any(".norm." in k for k in cos)  # the FrozenBN tensors are trained, as the reference's


def test_first_step_matches_the_jax_recipe(pools):
    import train_zoo_torch

    model, optimizer = train_zoo_torch.make_detic(SEED, LR, "cpu")
    set_compute_dtype(model["detector"], torch.float32)
    want = jax_recipe_step(model, "detector", train_zoo_torch.COLOR_VOCAB, pools[0], 1)
    step = train_zoo_torch.make_detic_step(model, optimizer)
    check_step(model, step(train_zoo_torch.stage(pools[1], "cpu"), 1), want)


def run_cli(tmp_path, recipe):
    """train_zoo_torch.main for `recipe`: refused without a card unless
    --device cpu, then one CPU step; returns the output directory."""
    import train_zoo_torch

    out = tmp_path / recipe
    argv = ["--model", recipe, "--size", "2", "--height", str(H), "--width", str(W),
            "--max-iter", "1", "--output-dir", str(out)]
    if not torch.cuda.is_available():
        assert train_zoo_torch.main(argv) == 2
    assert train_zoo_torch.main(argv + ["--device", "cpu"]) == 0
    assert os.listdir(out / "ckpt") == ["1"] and os.path.exists(out / f"{recipe}_int8.npz")
    return out


def check_loaded(tree, parts):
    """Each part of the wrapper holds its tree of the saved checkpoint."""
    assert set(tree) == set(parts)
    for name, module in parts.items():
        want = state_dict_from_jax(tree[name])
        assert set(module.state_dict()) == set(want), name
        assert all(torch.equal(v, want[k]) for k, v in module.state_dict().items()), name


def test_cli_checkpoint_loads_by_name(tmp_path, monkeypatch):
    import train_zoo_torch

    out = run_cli(tmp_path, "detic")
    assert json.load(open(out / "vocab.json")) == train_zoo_torch.COLOR_VOCAB
    monkeypatch.setenv("QUBER_DETIC_CKPT", str(out / "ckpt"))
    base = tbase.build_base_model("detic", "OSD", device="cpu")
    assert base.vocabulary == train_zoo_torch.COLOR_VOCAB
    check_loaded(tbase.load_eval_params(str(out / "ckpt")),
                 {"text": base.text_encoder, "detector": base.detector})

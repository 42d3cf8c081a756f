"""The ablation study's models of the port against the JAX package: the
MaskRefiner under every config of configs/ (without hierarchical fusion,
without the error heads, add fusion at three layers, RGB only, the
Panoptic-DeepLab config) and depth only, and the Panoptic-DeepLab module.

Configs are read by both packages' load_config and cut to a small size
(depth 14, 32x48, dropout 0); parameters are the JAX package's, randomised
from a seed and carried across with from_jax. Tolerances: configs and the
round trip JAX -> port -> JAX exact; forwards rtol 1e-4, atol 1e-4 (float32
summation order, as tests/test_torch_layers.py); losses rtol 1e-4; each
gradient of a training-mode step within 15% of its norm (the noise floor of
one ReLU flipping, tests/test_torch_train.py); the predictor as
tests/test_torch_predictor.py holds it (dense maps atol 2e-3, instance
counts equal, >= 99.9% of the panoptic labels).
"""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quber_tpu.config import load_config as jax_load_config
from quber_tpu.models import mask_refiner as JM
from quber_tpu.models import panoptic_deeplab as JP
from quber_tpu.predictor import MaskRefinerPredictor as JPredictor
from quber_tpu_torch.config import load_config
from quber_tpu_torch.data.synthetic import blob_scene
from quber_tpu_torch.models import mask_refiner as TM
from quber_tpu_torch.models import panoptic_deeplab as TP
from quber_tpu_torch.models.from_jax import state_dict_from_jax, state_dict_to_jax
from quber_tpu_torch.models.layers import BatchNorm, ConvNorm
from quber_tpu_torch.predictor import MaskRefinerPredictor as TPredictor

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")
# name -> (YAML under configs/, overrides)
VARIANTS = {
    "nohf": ("mask_refiner_nohf.yaml", {}),
    "noeee": ("mask_refiner_noeee.yaml", {}),
    "rgbd_add_l3": ("mask_refiner_rgbd_add_l3.yaml", {}),
    "rgb_only": ("mask_refiner_rgb_only.yaml", {}),
    # no YAML names it; the JAX package builds it all the same
    "depth_only": ("mask_refiner_rgb_only.yaml", {"rgb_on": False, "depth_on": True}),
    "panoptic_deeplab": ("panoptic_deeplab.yaml", {}),
}
H, W = 32, 48
SMALL = dict(height=H, width=W, resnet_depth=14, aspp_dropout=0.0)
RTOL = ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # the suite runs several workers side by side
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def nchw(x):
    return t(np.moveaxis(x, -1, 1))


def _randomize(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng)
            continue
        shape = np.shape(v)
        if k == "kernel":
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif k in ("scale", "frozen_weight"):
            a = 1.0 + 0.1 * rng.randn(*shape)
        elif k in ("var", "frozen_var"):
            a = rng.uniform(0.5, 1.5, shape)
        else:
            a = 0.1 * rng.randn(*shape)
        out[k] = a.astype(np.float32)
    return out


def _configs(name, **extra):
    path, overrides = VARIANTS[name]
    path = os.path.join(CONFIG_DIR, path)
    jcfg, tcfg = jax_load_config(path)[0], load_config(path)[0]
    kw = {**SMALL, **overrides, **extra}
    return dataclasses.replace(jcfg, **kw), dataclasses.replace(tcfg, **kw)


def _inputs(seed, b=2, h=H, w=W):
    rng = np.random.RandomState(seed)
    return (rng.uniform(0, 255, (b, h, w, 6)).astype(np.float32),
            rng.randn(b, h, w, 3).astype(np.float32))


_PAIRS = {}


def _pair(name):
    """(JAX config, port config, flax module, randomised variables, port
    module holding them), once per variant; "pd_module" is the
    PanopticDeepLab module."""
    if name not in _PAIRS:
        if name == "pd_module":
            jcfg = JP.PanopticDeepLabConfig(**SMALL)
            tcfg = TP.PanopticDeepLabConfig(**SMALL)
            jmod, tmod = JP.PanopticDeepLab(jcfg), TP.PanopticDeepLab(tcfg)
            init_args = (jnp.asarray(_inputs(0)[0]),)
        else:
            jcfg, tcfg = _configs(name)
            jmod, tmod = JM.MaskRefiner(jcfg), TM.MaskRefiner(tcfg)
            img, enc = _inputs(0)
            init_args = (jnp.asarray(img), jnp.asarray(enc) if jcfg.offset_input_on else None)
        variables = jmod.init(jax.random.PRNGKey(0), *init_args)
        variables = _randomize(jax.tree.map(np.asarray, dict(variables)),
                               np.random.RandomState(1))
        tmod.load_state_dict(state_dict_from_jax(variables), strict=True)
        _PAIRS[name] = (jcfg, tcfg, jmod, variables, tmod.eval())
    return _PAIRS[name]


def _assert_outputs(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].detach().numpy().transpose(0, 2, 3, 1), np.asarray(v),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


# --- configs and weights -----------------------------------------------------

@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(CONFIG_DIR, "*.yaml"))),
                         ids=os.path.basename)
def test_every_config_loads_as_in_jax(path):
    (jm, jt), (tm, tt) = jax_load_config(path), load_config(path)
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    assert dataclasses.asdict(tt) == dataclasses.asdict(jt)
    model = TM.MaskRefiner(dataclasses.replace(tm, resnet_depth=14))
    assert model.config.num_input_channels == jm.num_input_channels


@pytest.mark.parametrize("name", VARIANTS)
def test_chip_smoke_restates_the_configs(name):
    """chip_smoke.py reads no YAML: its variants equal the files'."""
    import chip_smoke

    path, overrides = VARIANTS[name]
    want = dataclasses.replace(load_config(os.path.join(CONFIG_DIR, path))[0], **overrides)
    assert dataclasses.replace(TM.MaskRefinerConfig(), **chip_smoke.ABLATION_CONFIGS[name]) == want


@pytest.mark.parametrize("name", [*VARIANTS, "pd_module"])
def test_from_jax_round_trip(name):
    """JAX -> port -> JAX gives the tree back, leaf for leaf."""
    _, _, _, variables, tmod = _pair(name)
    back = state_dict_to_jax(tmod)
    assert jax.tree.structure(back) == jax.tree.structure(variables)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(a, b)
    if name in ("rgb_only", "depth_only"):
        assert "trunk" in variables["params"]["backbone"]
        stem = tmod.backbone.trunk.stem.conv1.conv
        assert stem.in_channels == 6  # one modality + the offset encoding


# --- forwards ----------------------------------------------------------------

@pytest.mark.parametrize("name", VARIANTS)
def test_forward_matches_jax(name):
    jcfg, _, jmod, variables, tmod = _pair(name)
    img, enc = _inputs(2)
    want = jmod.apply(variables, jnp.asarray(img), jnp.asarray(enc))
    with torch.no_grad():
        got = tmod(nchw(img), nchw(enc))
    _assert_outputs(got, want)
    expect = {"foreground", "center", "offset"}
    if jcfg.eee_mask_on:
        expect |= {"eee_mask", "eee_boundary"}
    assert set(got) == expect
    with torch.no_grad():
        if name in ("rgb_only", "depth_only"):
            # a caller's frame of the model's own three channels passes through
            lo = 0 if jcfg.rgb_on else 3
            own = tmod(nchw(img[..., lo:lo + 3]), nchw(enc))
            _assert_outputs(own, jmod.apply(variables, jnp.asarray(img[..., lo:lo + 3]),
                                            jnp.asarray(enc)))
            _assert_outputs(own, {k: np.asarray(v) for k, v in want.items()})
        if not jcfg.offset_input_on:
            # offset_enc is not read: the same outputs without it
            alone = tmod(nchw(img))
            assert all(torch.equal(alone[k], got[k]) for k in got)


@pytest.mark.parametrize("full_res", [True, False])
def test_panoptic_deeplab_matches_jax(full_res):
    _, tcfg, jmod, variables, tmod = _pair("pd_module")
    img = _inputs(3)[0]
    want = jmod.apply(variables, jnp.asarray(img), full_res=full_res)
    with torch.no_grad():
        got = tmod(nchw(img), full_res=full_res)
    _assert_outputs(got, want)
    s = 1 if full_res else tcfg.common_stride
    assert got["foreground"].shape == (2, 1, H // s, W // s)
    assert tmod.sem_head.conv1.conv.out_channels == 256
    assert tmod.center_head.conv1.conv.out_channels == 32


# --- losses and a training step ----------------------------------------------

def _targets(rng, b, c):
    fg = (rng.rand(b, H, W) > 0.5).astype(np.float32)
    return {
        "sem_seg": fg,
        "sem_seg_weights": rng.choice([1.0, 3.0], size=(b, H, W)).astype(np.float32),
        "center": rng.rand(b, H, W).astype(np.float32),
        "center_weights": fg,
        "offset": rng.randn(b, H, W, 2).astype(np.float32) * 20,
        "offset_weights": fg,
        "eee_mask": np.eye(c, dtype=np.float32)[rng.randint(0, c, (b, H, W))],
        "eee_boundary": np.eye(c, dtype=np.float32)[rng.randint(0, c, (b, H, W))],
    }


def _channels_first(d):
    return {k: nchw(v) if v.ndim == 4 else t(v) for k, v in d.items()}


def _losses(name):
    """(JAX loss function of the outputs, the port's) for a variant."""
    jcfg, tcfg = _pair(name)[:2]
    if name == "pd_module":
        return (lambda o, tg: JP.compute_pd_losses(o, tg, jcfg),
                lambda o, tg: TP.compute_pd_losses(o, tg, tcfg))
    return (lambda o, tg: JM.compute_losses(o, tg, jcfg),
            lambda o, tg: TM.compute_losses(o, tg, tcfg))


@pytest.mark.parametrize("name", [*VARIANTS, "pd_module"])
def test_losses_match_jax(name):
    jcfg = _pair(name)[0]
    rng = np.random.RandomState(4)
    s = jcfg.common_stride
    outputs = {"foreground": rng.randn(2, H // s, W // s, 1), "center": rng.rand(2, H // s, W // s, 1),
               "offset": rng.randn(2, H // s, W // s, 2) * 5}
    if jcfg.eee_mask_on:
        outputs["eee_mask"] = rng.randn(2, H // s, W // s, jcfg.eee_channels)
        outputs["eee_boundary"] = rng.randn(2, H // s, W // s, jcfg.eee_channels)
    outputs = {k: v.astype(np.float32) for k, v in outputs.items()}
    targets = _targets(rng, 2, jcfg.eee_channels)
    jloss, tloss = _losses(name)
    want = jloss({k: jnp.asarray(v) for k, v in outputs.items()},
                 {k: jnp.asarray(v) for k, v in targets.items()})
    got = tloss(_channels_first(outputs), _channels_first(targets))
    assert set(got) == set(want)
    for k in want:
        assert float(got[k].detach()) == pytest.approx(float(want[k]), rel=1e-4), k


def _zero_grad_biases(model):
    """Conv biases ahead of a batch-statistics BatchNorm: their gradient is
    exactly zero, so what comes back is float noise."""
    return {f"{name}.conv.bias" for name, mod in model.named_modules()
            if isinstance(mod, ConvNorm) and isinstance(mod.norm, BatchNorm)
            and mod.conv.bias is not None}


def _rel_l2(got, want):
    return float((got.double() - want.double()).norm() / want.double().norm())


@pytest.mark.parametrize("name", [*VARIANTS, "pd_module"])
def test_train_step_gradients_match_jax(name):
    """A training-mode forward (batch-statistics BatchNorm), the losses and
    the gradient of their sum with respect to every trainable tensor."""
    jcfg, _, jmod, variables, tmod = _pair(name)
    img, enc = _inputs(5)
    targets = _targets(np.random.RandomState(6), 2, jcfg.eee_channels)
    jloss, tloss = _losses(name)
    jtrain = type(jmod)(jcfg, train=True)
    args = (jnp.asarray(img),) if name == "pd_module" else (jnp.asarray(img), jnp.asarray(enc))
    jtargets = {k: jnp.asarray(v) for k, v in targets.items()}

    def total(params):
        out, _ = jtrain.apply({**variables, "params": params}, *args, full_res=False,
                              mutable=["batch_stats"])
        losses = jloss(out, jtargets)
        return sum(losses.values()), losses

    (_, want), grads = jax.value_and_grad(total, has_aux=True)(variables["params"])
    tmod.train()
    try:
        targs = (nchw(img),) if name == "pd_module" else (nchw(img), nchw(enc))
        got = tloss(tmod(*targs, full_res=False), _channels_first(targets))
        tmod.zero_grad(set_to_none=True)
        sum(got.values()).backward()
    finally:
        tmod.load_state_dict(state_dict_from_jax(variables))  # the BatchNorm statistics
        tmod.eval()
    for k in want:
        assert float(got[k].detach()) == pytest.approx(float(want[k]), rel=1e-4), k
    want_grad = state_dict_from_jax({"params": jax.tree.map(np.asarray, grads)})
    skip = _zero_grad_biases(tmod)
    checked = 0
    for pname, p in tmod.named_parameters():
        if pname in skip:
            continue
        assert p.grad is not None, pname
        assert _rel_l2(p.grad, want_grad[pname]) <= 0.15, pname
        checked += 1
    assert checked == sum(1 for _ in tmod.parameters()) - len(skip)


# --- the predictor, the trainer and the evaluation CLI ------------------------

@pytest.mark.parametrize("name", ["rgb_only", "panoptic_deeplab"])
def test_predictor_matches_jax(name):
    """The whole single-frame path at 64x96 with decisive random heads: the
    encode still runs for a config without the offset input, as in the
    JAX predictor, and its output is not read."""
    extra = dict(height=64, width=96, min_instance_area=64, stuff_area=256)
    jcfg, tcfg = _configs(name, **extra)
    jp = JPredictor(jcfg, seed=3)
    params = jax.tree.map(np.asarray, jp.params)
    head = params["params"]["ins_embed_head"]
    rng = np.random.RandomState(5)
    head["foreground_predictor"]["bias"] = head["foreground_predictor"]["bias"] + 4.0
    k = head["center_predictor"]["kernel"]
    head["center_predictor"]["kernel"] = (rng.randn(*k.shape) * 0.5).astype(np.float32)
    jp = JPredictor(jcfg, params)
    tp = TPredictor(tcfg, params, device="cpu")
    rgb, depth, masks = blob_scene(np.random.RandomState(11), 64, 96, 4)
    want = {k: np.asarray(v) for k, v in jp.predict_raw(rgb, depth, list(masks)).items()}
    got = {k: v.numpy() for k, v in tp.predict_raw(rgb, depth, list(masks)).items()}
    assert set(got) == set(want)
    for key in ("sem_seg", "center", "offset"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=2e-3, err_msg=key)
    n = int(want["num_instances"])
    assert int(got["num_instances"]) == n > 0
    assert (got["panoptic_seg"] == want["panoptic_seg"]).mean() >= 0.999
    out = tp.predict(rgb, depth, list(masks))[0]
    assert out.keys() == jp.predict(rgb, depth, list(masks))[0].keys()


@pytest.mark.parametrize("yaml_model", ["  depth_on: false\n",
                                        "  offset_input_on: false\n  eee_mask_on: false\n"
                                        "  eee_boundary_on: false\n"
                                        "  hierarchical_fusion_on: false\n"])
def test_train_net_torch_runs_the_ablation_configs(tmp_path, capsys, yaml_model):
    """rgb-only and the Panoptic-DeepLab config through train_net_torch.py's
    device-target route: finite losses, a checkpoint."""
    import train_net_torch

    cfg = tmp_path / "tiny.yaml"
    cfg.write_text("model:\n  height: 32\n  width: 32\n  resnet_depth: 14\n" + yaml_model
                   + "train:\n  batch_size: 2\n  warmup_iters: 2\n  base_lr: 0.0005\n")
    out = str(tmp_path / "out")
    train_net_torch.main(["--config-file", str(cfg), "--synthetic", "--synthetic-size", "4",
                          "--target-slots", "8", "--device", "cpu", "--log-period", "1",
                          "--device-targets", "--output-dir", out, "--max-iter", "2"])
    text = capsys.readouterr().out
    losses = [float(line.split("total_loss=")[1].split()[0])
              for line in text.splitlines() if "total_loss=" in line]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert os.path.exists(os.path.join(out, "ckpt", "2", "COMPLETE"))
    assert ("loss_eee_mask" in text) == ("eee_mask_on: false" not in yaml_model)


def test_run_eval_torch_runs_rgb_only(tmp_path):
    """configs/mask_refiner_rgb_only.yaml, cut to depth 14 at 96x128, through
    run_eval_torch.py on one written frame."""
    import csv

    import run_eval_torch
    from quber_tpu_torch.data.make_synthetic_dataset import main as make_dataset

    root = str(tmp_path / "osd")
    make_dataset(["--out", root, "--n", "1", "--dropout-frac", "0.0005"])
    cfg = tmp_path / "rgb_only_small.yaml"
    cfg.write_text(f"_BASE_: {os.path.abspath(os.path.join(CONFIG_DIR, 'mask_refiner_rgb_only.yaml'))}\n"
                   "model:\n  height: 96\n  width: 128\n  resnet_depth: 14\n"
                   "  min_instance_area: 64\n  stuff_area: 256\n")
    (tmp_path / "out").mkdir()
    assert run_eval_torch.main(["--config-file", str(cfg), "--base-model", "perturbed-gt",
                                "--refiner-model", "maskrefiner", "--dataset-path", root,
                                "--limit", "1", "--device", "cpu",
                                "--csv", str(tmp_path / "out" / "x.csv")]) == 0
    rows = list(csv.DictReader(open(tmp_path / "out" / "x.csv")))
    assert [r["stage"] for r in rows] == ["initial", "refined"]

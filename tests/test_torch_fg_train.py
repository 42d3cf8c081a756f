"""Training of the foreground nets: the port's class-balanced weights and
cross-entropy, RAdam, train steps and train_fg_torch.py against
quber_tpu/train/fg_train.py, optax.radam and tools/train_fg.py.

Tolerances: weights and loss rtol 1e-6; RAdam against optax.radam over 8
steps on fixed gradients rtol 1e-6 (the rectification switches on at step
6); one step of a shallow CGNet and LMFFNet from the same flax init: loss
rtol 1e-5, each gradient's cosine >= 0.999, the new BatchNorm statistics
within 1e-5;
train_fg_torch's samples against tools/train_fg.load_sample: x within 1e-6,
y exact, the same draws consumed.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from quber_tpu.models.cgnet import CGNet as JCGNet
from quber_tpu.models.lmffnet import LMFFNet as JLMFFNet
from quber_tpu.train import fg_train as JF
from quber_tpu_torch.data.make_synthetic_dataset import main as make_dataset
from quber_tpu_torch.models.cgnet import CGNet
from quber_tpu_torch.models.from_jax import state_dict_from_jax
from quber_tpu_torch.models.lmffnet import LMFFNet
from quber_tpu_torch.train import fg_train as TF
from quber_tpu_torch.train.optim import RAdam

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _labels(rng, b, h, w, classes):
    y = np.zeros((b, h, w), np.int32)
    for i in range(b):
        for c in range(1, classes):
            y0, x0 = rng.randint(0, h - 8), rng.randint(0, w - 8)
            y[i, y0:y0 + rng.randint(4, h // 2), x0:x0 + rng.randint(4, w // 2)] = c
    y[-1] = 0  # an image with one class only: the absent ones weigh 0
    return y


def test_class_balanced_weights_and_loss():
    rng = np.random.RandomState(0)
    for classes in (2, 3):
        labels = _labels(rng, 3, 20, 24, classes)
        logits = rng.randn(3, 20, 24, classes).astype(np.float32)
        want_w = np.asarray(JF.class_balanced_weights(jnp.asarray(labels), classes))
        got_w = TF.class_balanced_weights(torch.from_numpy(labels), classes).numpy()
        np.testing.assert_allclose(got_w, want_w, rtol=1e-6)
        want = float(JF.weighted_ce_loss(jnp.asarray(logits), jnp.asarray(labels)))
        got = float(TF.weighted_ce_loss(torch.from_numpy(logits).permute(0, 3, 1, 2),
                                        torch.from_numpy(labels)))
        assert abs(got - want) <= 1e-6 * abs(want)


def test_radam_matches_optax():
    rng = np.random.RandomState(1)
    params = {"a": rng.randn(5, 4).astype(np.float32), "b": rng.randn(7).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(8)]
    tx = optax.radam(1e-2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = RAdam(list(tp.values()), lr=1e-2)
    for step, g in enumerate(grads, start=1):
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"step {step} {k}")


# shallow nets at a small size: one flax compile each
NETS = {
    "cgnet": (lambda: JCGNet(classes=2, in_channels=4, m=2, n=3, train=True),
              lambda: CGNet(2, 4, m=2, n=3), (2, 40, 56, 4), 2),
    "lmffnet": (lambda: JLMFFNet(classes=3, block_1=2, block_2=2, train=True),
                lambda: LMFFNet(3, block_1=2, block_2=2), (2, 64, 96, 6), 3),
}


@pytest.mark.parametrize("name", sorted(NETS))
def test_train_step_matches_jax(name):
    """One step of the reference (make_fg_train_step) and of the port from the
    same flax init. At step 1 RAdam is not rectified and moves each leaf by
    -lr * g, so with lr = 1 the parameters' change is the gradient."""
    jmodel, tmodel, shape, classes = NETS[name]
    jnet = jmodel()
    state, tx = JF.create_fg_train_state(jnet, shape, lr=1.0, seed=3)
    rng = np.random.RandomState(2)
    x = rng.randn(*shape).astype(np.float32)
    y = _labels(rng, shape[0], shape[1], shape[2], classes)
    new_state, metrics = JF.make_fg_train_step(jnet, tx)(state, jnp.asarray(x), jnp.asarray(y))
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731

    net = tmodel()
    net.load_state_dict(state_dict_from_jax(to_np({"params": state.params,
                                                   "batch_stats": state.batch_stats})),
                        strict=True)
    before = {n: p.detach().clone() for n, p in net.named_parameters()}
    tstate = TF.create_fg_train_state(net, lr=1.0, device="cpu", init=False)
    got = TF.fg_train_step(tstate, torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(y))
    want = float(metrics["loss"])
    assert abs(float(got["loss"]) - want) <= 1e-5 * abs(want)

    old = state_dict_from_jax({"params": to_np(state.params)})
    new = state_dict_from_jax({"params": to_np(new_state.params)})
    worst = 1.0
    for n, p in net.named_parameters():
        g = (before[n] - p.detach()).flatten().double()
        w = (old[n] - new[n]).flatten().double()
        worst = min(worst, float(torch.nn.functional.cosine_similarity(g, w, dim=0)))
    assert worst >= 0.999
    want_stats = state_dict_from_jax({"batch_stats": to_np(new_state.batch_stats)})
    sd = net.state_dict()
    assert want_stats and set(want_stats) <= set(sd)
    for k, v in want_stats.items():
        assert torch.abs(sd[k] - v).max() <= 1e-5, k


def _train_fg_tool():
    spec = importlib.util.spec_from_file_location("train_fg_tool",
                                                  os.path.join(ROOT, "tools", "train_fg.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def osd(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fgtrain") / "osd")
    make_dataset(["--out", root, "--n", "3", "--height", "60", "--width", "80"])
    return root


@pytest.mark.parametrize("model", ["cgnet", "lmffnet"])
def test_samples_match_the_tool(osd, model):
    import train_fg_torch

    tool = _train_fg_tool()
    samples = train_fg_torch.list_samples(osd)
    assert samples == tool.list_samples(osd) and len(samples) == 3
    load = train_fg_torch.SampleCache(model)
    r1, r2 = np.random.default_rng(7), np.random.default_rng(7)
    for paths in samples * 2:  # the second pass reads the kept part
        x, y = load(paths, r1)
        want_x, want_y = tool.load_sample(paths, model, r2)
        assert x.shape == want_x.shape and x.dtype == want_x.dtype
        assert np.abs(x - want_x).max() <= 1e-6
        assert y.dtype == want_y.dtype and np.array_equal(y, want_y)
    assert r1.random() == r2.random()


def test_cli_checkpoint_loads_into_the_filter(osd, tmp_path, monkeypatch):
    import train_fg_torch

    from quber_tpu_torch.evaluation.refiner_models import build_refiner_model
    from quber_tpu_torch.models.from_jax import state_dict_to_jax
    from quber_tpu_torch.models.mask_refiner import MaskRefinerConfig

    out = str(tmp_path / "fg")
    assert train_fg_torch.main(["--model", "cgnet", "--dataset-path", osd, "--max-iter", "3",
                                "--batch", "2", "--log-period", "1", "--checkpoint-period", "2",
                                "--output-dir", out, "--device", "cpu"]) == 0
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == ["2", "3"]
    monkeypatch.setenv("QUBER_CGNET_CKPT", os.path.join(out, "ckpt"))
    monkeypatch.delenv("QUBER_LMFFNET_CKPT", raising=False)
    refiner = build_refiner_model("maskrefiner", "OSD",
                                  config=MaskRefinerConfig(height=96, width=128, resnet_depth=14),
                                  device="cpu")
    from quber_tpu_torch.train.checkpoint import restore_params

    saved = restore_params(os.path.join(out, "ckpt"))
    assert set(saved) == {"params", "batch_stats"}
    loaded = state_dict_to_jax(refiner.fg_predictor.model)
    flat = lambda t, p="": {f"{p}/{k}": v for k, s in t.items()  # noqa: E731
                            for k, v in (flat(s, k) if isinstance(s, dict) else {k: s}).items()}
    assert flat(loaded).keys() == flat(saved).keys()
    assert all(np.array_equal(flat(loaded)[k], flat(saved)[k]) for k in flat(saved))
    rgb = sorted(os.listdir(os.path.join(osd, "image_color")))[0]
    fg = refiner.fg_predictor.predict(os.path.join(osd, "image_color", rgb),
                                      os.path.join(osd, "disparity", rgb))
    assert fg.shape == (480, 640) and fg.dtype == bool

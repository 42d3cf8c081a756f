"""train_zoo_torch.py --model uoisnet3d | cascadepsp | rice against
tools/train_zoo.py's recipes at small sizes (64x96 scenes, 64x64 crops).

Each recipe's first step from the port's seeded init carried to the JAX
package's layout, on the pool the JAX recipe renders (the port's own pool
held against it first), with the JAX step's random draws handed over:
uoisnet3d's instance, jitter and the cluster loss's samples (the indices
jax.random draws from the step's key), cascadepsp's batch (numpy's
default_rng(seed + 1), drawn the same way in both). Tolerances: the total
loss and each part rtol 1e-4; each parameter's gradient within 15% of the
norm of jax.value_and_grad's (the port's rule since its first trainer), a
gradient below a thousandth of the largest held to that bound alone; the
pools equal (the crops' resizes within 1e-5: cv2.resize's float32
arithmetic against the port's float64 copy). Then the CLI: two CPU steps
(one for cascadepsp) write the checkpoint directories that the evaluation
names read and int8 archives that the JAX package's modules apply.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quber_tpu.models import cascadepsp as JC
from quber_tpu.models import rice as JR
from quber_tpu.models import uois_net as JU
from quber_tpu.ops import morphology as jmorph
from quber_tpu.train.checkpoint import load_quantized_params as jax_load_quantized
from quber_tpu_torch.models.from_jax import state_dict_from_jax, state_dict_to_jax
from quber_tpu_torch.train.checkpoint import load_eval_params

_TOOL = os.path.join(os.path.dirname(__file__), "..", "tools", "train_zoo.py")
_spec = importlib.util.spec_from_file_location("jax_train_zoo", _TOOL)
jzoo = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jzoo)

H, W = 64, 96
CROP = 64
LR = 1e-4
SEED = 7
LOSS_RTOL = 1e-4
GRAD_SHARE = 0.15
CROP_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _check(got_loss, got_parts, loss, parts):
    assert float(got_loss) == pytest.approx(float(loss), rel=LOSS_RTOL)
    assert set(got_parts) == set(parts)
    for k in parts:
        assert float(got_parts[k]) == pytest.approx(float(parts[k]), rel=LOSS_RTOL, abs=1e-7), k


def _check_gradients(model, want, min_compared):
    """Each parameter's gradient (left by the step) within GRAD_SHARE of the
    norm of the reference's; one below a thousandth of the largest only
    held below that."""
    noise = 1e-3 * max(float(g.norm()) for g in want.values())
    compared = 0
    for name, p in model.named_parameters():
        g = want[name].double()
        if float(g.norm()) <= noise:
            assert float(p.grad.norm()) <= noise, name
            continue
        assert float((p.grad.double() - g).norm()) <= GRAD_SHARE * float(g.norm()), name
        compared += 1
    assert compared >= min_compared, compared


def _grads(tree):
    return state_dict_from_jax(jax.tree.map(np.asarray, tree))


def test_uoisnet3d_first_step_matches_jax():
    import train_zoo_torch as zoo

    want_pool = jzoo.make_labeled_scenes(2, H, W, SEED, (250, 1500))
    got_pool = zoo.make_labeled_scenes(2, H, W, SEED, (250, 1500))
    for k, v in want_pool.items():
        np.testing.assert_array_equal(got_pool[k], v, err_msg=k)
    model, optimizer = zoo.make_uoisnet3d(SEED, LR, "cpu")
    params = {"dsn": state_dict_to_jax(model.dsn), "rrn": state_dict_to_jax(model.rrn)}
    dsn, rrn = JU.DepthSeedingNetwork(), JU.RegionRefinementNetwork()
    scene, it = 1, 1
    p = {k: v[scene] for k, v in want_pool.items()}
    # the JAX step's draws from its key
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), it)
    k_cl, k_inst, k_jit = jax.random.split(key, 3)
    probs = p["valid"] / max(p["valid"].sum(), 1)
    inst = int(jax.random.choice(k_inst, zoo.SLOTS, (), p=jnp.asarray(probs)))
    jitter = int(jax.random.randint(k_jit, (), 0, 3))
    fg = (p["labels"].reshape(-1) >= 1).astype(np.float32)
    k1, k2 = jax.random.split(k_cl)
    samples = np.array(jax.random.choice(k1, fg.shape[0], (256,), replace=True,
                                         p=jnp.asarray(fg / fg.sum())))
    seeds = np.array(jax.random.choice(k2, 256, (32,), replace=True))
    gt_mask = (p["labels"] == 1 + inst).astype(np.float32)
    perturbed = [gt_mask, np.asarray(jmorph.dilate(gt_mask[None], 2)[0]),
                 np.asarray(jmorph.erode(gt_mask[None], 2)[0])][jitter]

    p = {k: jnp.asarray(v) for k, v in p.items()}  # staged, as the recipe's pool

    def loss_fn(v):
        fg_logits, offsets = dsn.apply(v["dsn"], p["xyz"][None])
        dl = JU.dsn_train_losses(fg_logits[0], offsets[0], p["xyz"], p["offsets"], p["labels"],
                                 p["centers"], p["valid"], k_cl, object_label=1, sigma=0.02,
                                 delta=0.1)
        rin = jnp.concatenate([p["rgb"], perturbed[..., None]], axis=-1)
        losses = dict(dl, loss_rrn=JU.rrn_loss(rrn.apply(v["rrn"], rin[None])[0, ..., 0], gt_mask))
        return sum(losses.values()), losses

    (loss, parts), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    step = zoo.make_uoisnet3d_step(model, optimizer)
    draws = {"samples": torch.from_numpy(samples).long(), "seeds": torch.from_numpy(seeds).long(),
             "inst": inst, "jitter": jitter}
    got_loss, got_parts = step(zoo.stage(got_pool, "cpu"), scene, draws)
    _check(got_loss, got_parts, loss, parts)
    want = {f"{net}.{k}": v for net in ("dsn", "rrn") for k, v in _grads(grads[net]).items()}
    _check_gradients(model, want, min_compared=50)  # of 58 tensors


def test_uoisnet3d_draws_follow_the_reference():
    import train_zoo_torch as zoo

    pool = zoo.stage(zoo.make_labeled_scenes(1, H, W, SEED, (250, 1500)), "cpu")
    g = torch.Generator().manual_seed(0)
    seen = set()
    for _ in range(30):
        d = zoo.draw_uoisnet3d(pool["labels"][0], pool["valid"][0], g)
        assert bool(pool["valid"][0][d["inst"]]) and d["jitter"] in (0, 1, 2)
        assert bool((pool["labels"][0].reshape(-1)[d["samples"]] >= 1).all())
        seen.add(d["jitter"])
    assert seen == {0, 1, 2}


def test_cascadepsp_first_step_matches_jax():
    import train_zoo_torch as zoo

    want_pool = jzoo.make_refine_crops(6, H, W, SEED, (250, 1500), crop=CROP)
    got_pool = zoo.make_refine_crops(6, H, W, SEED, (250, 1500), crop=CROP)
    for k, v in want_pool.items():
        assert got_pool[k].shape == v.shape
        assert np.abs(got_pool[k] - v).max() <= CROP_ATOL, k
    model, optimizer = zoo.make_cascadepsp(SEED, LR, "cpu")
    stats = [n for n, _ in model.named_parameters() if n.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 65  # the BatchNorm statistics are trained, as the reference's
    variables = state_dict_to_jax(model)
    assert set(variables) == {"params", "batch_stats"}
    # the JAX recipe's batch: 3 crops from default_rng(seed + 1), then the step's
    index = 2
    batch = np.random.default_rng(SEED + 1).integers(0, 6, 3).tolist() + [index]
    psp = JC.PSPNetUOAIS()
    rgbd, seg, tgt = (want_pool[k][batch] for k in ("rgbd", "seg", "tgt"))

    def loss_fn(v):
        images = psp.apply(v, rgbd[..., :3], rgbd[..., 3:4], ((seg - 0.5) / 0.5)[..., None])
        losses = JC.cascadepsp_refine_loss(images, tgt)
        return sum(losses.values()), losses

    (loss, parts), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables)
    step = zoo.make_cascadepsp_step(model, optimizer, size=6, seed=SEED)
    got_loss, got_parts = step(zoo.stage(want_pool, "cpu"), index)  # its own default draw
    _check(got_loss, got_parts, loss, parts)
    _check_gradients(model, _grads(grads), min_compared=300)


def test_rice_first_step_matches_jax():
    import train_zoo_torch as zoo

    slots = JR.RICERefiner.MAX_INST
    want_pool = jzoo.make_rice_scenes(2, H, W, SEED, (250, 1500), slots)
    got_pool = zoo.make_rice_scenes(2, H, W, SEED, (250, 1500))
    for k, v in want_pool.items():
        np.testing.assert_array_equal(got_pool[k], v, err_msg=k)
    assert want_pool["gvalid"].any() and want_pool["bvalid"].any()
    model, optimizer = zoo.make_rice(SEED, LR, "cpu")
    variables = state_dict_to_jax(model)
    scorer, crop, scene = JR.NodeScorer(), JR.RICERefiner.CROP, 1
    p = {k: v[scene] for k, v in want_pool.items()}
    gc, g_ok = JR.hypothesis_node_crops(p["image6"], p["good"], p["gvalid"], crop=crop)
    bc, b_ok = JR.hypothesis_node_crops(p["image6"], p["bad"], p["bvalid"], crop=crop)

    def loss_fn(v):
        losses = JR.node_scorer_loss(scorer.apply(v, gc), g_ok, scorer.apply(v, bc), b_ok)
        return sum(losses.values()), losses

    (loss, parts), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables)
    step = zoo.make_rice_step(model, optimizer)
    got_loss, got_parts = step(zoo.stage(got_pool, "cpu"), scene)
    _check(got_loss, got_parts, loss, parts)
    _check_gradients(model, _grads(grads), min_compared=8)


@pytest.mark.parametrize("name", ["uoisnet3d", "cascadepsp", "rice"])
def test_train_zoo_torch_cli(name, tmp_path, capsys, monkeypatch):
    import train_zoo_torch as zoo

    from quber_tpu_torch.evaluation import base_models as tbase
    from quber_tpu_torch.evaluation import refiner_models as tref

    if name == "cascadepsp":  # 64x64 crops: a step at 224x224 takes ~14 s on two threads
        make_pool, make_model, make_step = zoo.RECIPES[name]
        monkeypatch.setitem(zoo.RECIPES, name, (
            lambda *a: make_pool(*a, crop=CROP), make_model, make_step))
    out = tmp_path / name
    steps = 1 if name == "cascadepsp" else 2
    argv = ["--model", name, "--size", "2", "--height", str(H), "--width", str(W),
            "--max-iter", str(steps), "--log-period", "1", "--checkpoint-period", "1",
            "--output-dir", str(out)]
    if not torch.cuda.is_available():
        assert zoo.main(argv) == 2
    assert zoo.main(argv + ["--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert f"iter {steps}/{steps} total=" in text
    if name == "uoisnet3d":
        assert "loss_cluster=" in text and "loss_rrn=" in text
        for part in ("dsn", "rrn"):
            assert sorted(os.listdir(out / f"ckpt_{part}")) == ["1", "2"]
        monkeypatch.setenv("QUBER_UOIS3D_DSN_CKPT", str(out / "ckpt_dsn"))
        monkeypatch.setenv("QUBER_UOIS3D_RRN_CKPT", str(out / "ckpt_rrn"))
        base = tbase.build_base_model("uoisnet3d", "OSD", device="cpu")
        for part, model in (("dsn", base.dsn), ("rrn", base.rrn)):
            want = state_dict_from_jax(load_eval_params(str(out / f"ckpt_{part}")))
            assert all(torch.equal(v, want[k]) for k, v in model.state_dict().items())
        tree = jax_load_quantized(str(out / "uoisnet3d_dsn_int8.npz"))
        fg, offsets = JU.DepthSeedingNetwork().apply(tree, jnp.zeros((1, H, W, 3)))
        assert fg.shape == (1, H, W, 2) and bool(jnp.isfinite(offsets).all())
        tree = jax_load_quantized(str(out / "uoisnet3d_rrn_int8.npz"))
        assert JU.RegionRefinementNetwork().apply(tree, jnp.zeros((1, H, W, 4))).shape == \
            (1, H, W, 1)
        return
    assert sorted(os.listdir(out / "ckpt")) == [str(i) for i in range(1, steps + 1)]
    env = "QUBER_CASCADEPSP_CKPT" if name == "cascadepsp" else "QUBER_RICE_CKPT"
    monkeypatch.setenv(env, str(out / "ckpt"))
    refiner = tref.build_refiner_model(name, "OSD", device="cpu")
    model = refiner.model if name == "cascadepsp" else refiner.scorer
    want = state_dict_from_jax(load_eval_params(str(out / "ckpt")))
    assert all(torch.equal(v, want[k]) for k, v in model.state_dict().items())
    tree = jax_load_quantized(str(out / f"{name}_int8.npz"))
    if name == "cascadepsp":  # the JAX module's variables, leaf for leaf (its forward
        # compiles for ~10 s; test_cascadepsp_first_step_matches_jax runs it)
        z = jnp.zeros((1, 32, 32, 1))
        shapes = jax.eval_shape(JC.PSPNetUOAIS().init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 32, 32, 3)), z, z)
        assert jax.tree.structure(tree) == jax.tree.structure(shapes)
        assert all(a.shape == b.shape for a, b in zip(jax.tree.leaves(tree),
                                                      jax.tree.leaves(shapes)))
    else:
        assert JR.NodeScorer().apply(tree, jnp.zeros((3, 64, 64, 6))).shape == (3,)

"""The importers of the reference's released MSMFormer and UOAIS-Net
checkpoints and the modules they fill, against the JAX package
(quber_tpu/models/import_zoo.py, msmformer_pretrained.py,
uoais_net_pretrained.py).

No released checkpoint is in the repository, so the state dicts are
synthesised with the reference's key layout: MSMFormer's scaled down as the
JAX oracle test scales it (the UCN ResNet-34-8s branches of
tests/test_import_zoo.py, a 2-layer decoder of width 32), UOAIS-Net's at full
width from tests/test_uoais_pretrained.py's re-derivation, their weights and
BatchNorm statistics seeded. Each goes through the JAX importer and flax
forward and through the port's importer and torch forward. Tolerances: every
output within 1e-4 (float32, absolute: the UOAIS-Net heads' outputs are
~0.04 after ~80 unnormalised layers whose features reach ~8), the
selections equal; the importers map every key of the checkpoint and fill
every tensor of the module (strict), and refuse a checkpoint with a key
left over.
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn as tnn

from quber_tpu.models import import_zoo as JIZ
from quber_tpu.models.msmformer_pretrained import PretrainedMSMFormer as JPretrainedMSMFormer
from quber_tpu.models.msmformer_pretrained import position_embedding_sine as jax_pos_sine
from quber_tpu.models.uoais_net_pretrained import UOAISNetPretrained as JUOAISNetPretrained
from quber_tpu_torch.models import import_zoo as TIZ
from quber_tpu_torch.models.msmformer_pretrained import PretrainedMSMFormer, position_embedding_sine
from quber_tpu_torch.models.uoais_net_pretrained import UOAISNetPretrained
from test_import_zoo import _torch_resnet34_8s
from test_uoais_pretrained import RefUOAIS, _randomize_bn_stats

ATOL = 1e-4
MSM = dict(embed_dim=16, hidden_dim=32, nheads=4, dim_feedforward=48, num_queries=8,
           dec_layers=2, num_classes=2, mask_dim=24)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _seeded(module, seed):
    """The module's state dict as numpy, every float tensor moved by seeded
    noise (BatchNorm variances kept positive)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in module.state_dict().items():
        if k.endswith("running_var"):
            v = 0.5 + torch.rand(v.shape, generator=g)
        elif v.is_floating_point():
            v = v + 0.1 * torch.randn(v.shape, generator=g)
        out[k] = v.numpy()
    return out


def reference_msmformer_state(seed=0, **dims):
    """A state dict in the released MSMFormer's key layout (the
    PretrainedMeanShiftMaskFormer meta-architecture), at the widths `dims`
    (MSM's, scaled down, by default)."""
    dims = dims or MSM
    e, dim, heads, ffn = dims["embed_dim"], dims["hidden_dim"], dims["nheads"], dims["dim_feedforward"]
    q, layers, c, md = dims["num_queries"], dims["dec_layers"], dims["num_classes"], dims["mask_dim"]
    torch.manual_seed(seed)
    root = tnn.Module()
    bb = tnn.Module()
    bb.rgb_fcn, bb.depth_fcn = _torch_resnet34_8s(e), _torch_resnet34_8s(e)
    root.pretrained_backbone = bb
    pd, pred = tnn.Module(), tnn.Module()
    pd.mask_features = tnn.Conv2d(e, md, 3, padding=1)
    for kind, attr in (("cross", "meanshift_attn"), ("self", "self_attn")):
        blocks = tnn.ModuleList()
        for _ in range(layers):
            m = tnn.Module()
            setattr(m, attr, tnn.MultiheadAttention(dim, heads))
            m.norm = tnn.LayerNorm(dim)
            blocks.append(m)
        setattr(pred, f"transformer_{kind}_attention_layers", blocks)
    ffns = tnn.ModuleList()
    for _ in range(layers):
        m = tnn.Module()
        m.linear1, m.linear2, m.norm = tnn.Linear(dim, ffn), tnn.Linear(ffn, dim), tnn.LayerNorm(dim)
        ffns.append(m)
    pred.transformer_ffn_layers = ffns
    pred.decoder_norm = tnn.LayerNorm(dim)
    pred.query_feat, pred.query_embed = tnn.Embedding(q, dim), tnn.Embedding(q, dim)
    pred.level_embed = tnn.Embedding(1, dim)
    pred.input_proj = tnn.ModuleList([tnn.Conv2d(e, dim, 1)])
    pred.class_embed = tnn.Linear(dim, c + 1)
    me = tnn.Module()
    me.layers = tnn.ModuleList([tnn.Linear(dim, dim), tnn.Linear(dim, dim), tnn.Linear(dim, md)])
    pred.mask_embed = me
    sem = tnn.Module()
    sem.pixel_decoder, sem.predictor = pd, pred
    root.sem_seg_head = sem
    sd = _seeded(root, seed)
    sd["criterion.empty_weight"] = np.ones(c + 1, np.float32)  # a buffer with no network state
    return sd


@pytest.fixture(scope="module")
def uoais_state():
    rng = np.random.RandomState(7)
    torch.manual_seed(7)
    ref = RefUOAIS().eval()
    with torch.no_grad():
        _randomize_bn_stats(ref, rng)
    return {k: v.numpy() for k, v in ref.state_dict().items()}


def test_position_embedding_sine():
    np.testing.assert_allclose(position_embedding_sine(6, 9, 16).numpy(),
                               np.asarray(jax_pos_sine(6, 9, 16)), rtol=1e-6, atol=1e-6)


def test_msmformer_twin_matches_jax():
    sd = reference_msmformer_state()
    variables = JIZ.import_msmformer(sd)
    model = PretrainedMSMFormer(**MSM).eval()
    model.load_state_dict(TIZ.import_msmformer(sd), strict=True)
    rng = np.random.RandomState(1)
    rgb = rng.rand(1, 32, 48, 3).astype(np.float32)
    xyz = rng.rand(1, 32, 48, 3).astype(np.float32)
    want = jax.jit(JPretrainedMSMFormer(**MSM).apply)(variables, rgb, xyz)
    with torch.no_grad():
        got = model(torch.from_numpy(rgb).permute(0, 3, 1, 2),
                    torch.from_numpy(xyz).permute(0, 3, 1, 2))
    for k in ("pred_logits", "pred_masks"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=ATOL,
                                   err_msg=k)
    assert len(got["aux"]) == len(want["aux"]) == MSM["dec_layers"]
    for (gl, gm), (wl, wm) in zip(got["aux"], want["aux"]):
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=0, atol=ATOL)
        np.testing.assert_allclose(gm.numpy(), np.asarray(wm), rtol=0, atol=ATOL)


@pytest.mark.parametrize("score_thresh", [0.0, 0.5])
def test_uoais_net_twin_matches_jax(uoais_state, score_thresh):
    """The whole inference graph: RPN top-k and NMS per level, the box head,
    the detection NMS and top-k, the MLC and HOM heads."""
    x = np.random.RandomState(3).randn(128, 128, 6).astype(np.float32) * 20.0
    kw = dict(rpn_pre_nms_topk=64, rpn_post_nms_topk=64, detections=3, score_thresh=score_thresh)
    variables = JIZ.import_uoais_net(uoais_state)
    want = jax.tree.map(np.asarray, jax.jit(JUOAISNetPretrained(**kw).apply)(
        {"params": variables["params"]}, x))
    model = UOAISNetPretrained(**kw).eval()
    model.load_state_dict(TIZ.import_uoais_net(uoais_state), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(2, 0, 1))
    assert set(got) == set(want)
    for k, w in want.items():
        if w.dtype == bool:
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=ATOL, err_msg=k)
    if score_thresh == 0.0:
        assert want["valid"].all()


@pytest.mark.parametrize("which", ["msmformer", "uoais_net"])
def test_importers_map_every_key(which, uoais_state):
    sd = reference_msmformer_state() if which == "msmformer" else dict(uoais_state)
    importer = getattr(TIZ, f"import_{which}")
    model = PretrainedMSMFormer(**MSM) if which == "msmformer" else UOAISNetPretrained()
    got = importer(sd)
    assert set(got) == set(model.state_dict())  # every tensor of the module filled
    jax_tree = getattr(JIZ, f"import_{which}")(sd)
    n_jax = len(jax.tree_util.tree_leaves(jax_tree))
    # the JAX importer splits each attention's packed projection the same way
    assert len(got) == n_jax
    with pytest.raises(KeyError, match="unmapped"):
        importer(dict(sd, **{"roi_heads.extra.weight": np.zeros(3, np.float32)}))
    missing = dict(sd)
    missing.pop(next(k for k in sd if k.endswith("conv1.weight")))
    with pytest.raises(KeyError):
        importer(missing)
    assert set(importer(dict(sd, **{"roi_heads.extra.weight": np.zeros(3)}), strict=False)) == set(got)


def test_reference_checkpoint_file_reads_through_the_importer(tmp_path):
    """A .pth holding {"model": state_dict} (as the reference saves it) gives
    the same weights as the state dict itself."""
    sd = reference_msmformer_state(seed=2)
    path = str(tmp_path / "model_final.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}, "iteration": 7}, path)
    got = TIZ.import_msmformer(TIZ.load_reference_checkpoint(path))
    want = TIZ.import_msmformer(sd)
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)


# --- UOIS-Net-3D's DSN and RRN, CascadePSP's PSPNet_UOAIS ---------------------

UOIS_FD = 10  # the released width is 64; the map is per block


def _reference_psp_name(name):
    """A PSPNetUOAIS key of the port -> the reference's (torchvision trunk
    naming, nn.Sequential indices)."""
    import re

    name = re.sub(r"feats\.layer(\d)_(\d+)\.", r"feats.layer\1.\2.", name)
    name = name.replace("downsample_conv", "downsample.0").replace("downsample_bn", "downsample.1")
    name = re.sub(r"psp\.stage_(\d)\.", r"psp.stages.\1.1.", name)
    for seq in ("conv2", "conv"):
        for port, ref in (("bn0", "0"), ("conv0", "2"), ("bn1", "3"), ("conv1", "5")):
            name = name.replace(f".{seq}_{port}.", f".{seq}.{ref}.")
    return re.sub(r"final_(28|56)_(\d)\.", r"final_\1.\2.", name)


def reference_uois_cascade_state(which, seed=0):
    """A state dict in the reference's layout for `which` (uois_dsn: the
    DSN checkpoint's {"model": ...} with DataParallel's prefixes; uois_rrn:
    the RRN's; cascadepsp: PSPNet_UOAIS's with BatchNorm counters), seeded:
    LeCun weights, the norms' affine and BatchNorm statistics moved by
    noise. Returns (reference state dict, the port module it fills)."""
    from quber_tpu_torch.models.cascadepsp import PSPNetUOAIS
    from quber_tpu_torch.models.uois_net_pretrained import PretrainedDSN, PretrainedRRN

    model = {"uois_dsn": lambda: PretrainedDSN(feature_dim=UOIS_FD),
             "uois_rrn": lambda: PretrainedRRN(feature_dim=UOIS_FD),
             "cascadepsp": PSPNetUOAIS}[which]()
    g = torch.Generator().manual_seed(seed)
    model.reset_parameters(g)
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith("running_var"):
            v = 0.5 + torch.rand(v.shape, generator=g)
        elif k.endswith("running_mean") or ".gn" in k or ".bn" in k or "_bn" in k:
            v = v + 0.1 * torch.randn(v.shape, generator=g)
        sd[k] = v.numpy()
    if which == "cascadepsp":
        ref = {}
        for k, v in sd.items():
            ref[f"module.{_reference_psp_name(k)}"] = v
            if k.endswith("running_var"):
                ref[f"module.{_reference_psp_name(k)[:-len('running_var')]}num_batches_tracked"] \
                    = np.asarray(100)
        return ref, model
    if which == "uois_dsn":
        return {"model": {f"module.{k}": v for k, v in sd.items()}}, model
    return sd, model


@pytest.mark.parametrize("which", ["uois_dsn", "uois_rrn", "cascadepsp"])
def test_uois_and_cascadepsp_importers_fill_the_twins(which):
    from quber_tpu.models.cascadepsp import PSPNetUOAIS as JPSP
    from quber_tpu.models.uois_net_pretrained import PretrainedDSN as JDSN
    from quber_tpu.models.uois_net_pretrained import PretrainedRRN as JRRN

    sd, model = reference_uois_cascade_state(which, seed=3)
    importer = getattr(TIZ, f"import_{which}")
    got = importer(sd)
    assert set(got) == set(model.state_dict())  # every tensor of the module filled
    model.load_state_dict(got, strict=True)
    model.eval()
    variables = getattr(JIZ, f"import_{which}")(sd)
    rng = np.random.RandomState(2)
    if which == "cascadepsp":
        x = (rng.randn(1, 64, 64, 3).astype(np.float32), rng.rand(1, 64, 64, 1).astype(np.float32),
             (rng.rand(1, 64, 64, 1) > 0.5).astype(np.float32) * 2 - 1)
        want = jax.jit(JPSP().apply)(variables, *x)
        want = [np.asarray(want[k]) for k in sorted(want)]
        with torch.no_grad():
            out = model(*(torch.from_numpy(a).permute(0, 3, 1, 2) for a in x))
        got_out = [out[k].permute(0, 2, 3, 1).numpy() for k in sorted(out)]
    else:
        c, size = (3, (64, 96)) if which == "uois_dsn" else (4, (64, 64))
        x = rng.randn(1, *size, c).astype(np.float32)
        jm = (JDSN if which == "uois_dsn" else JRRN)(feature_dim=UOIS_FD)
        want = jax.jit(jm.apply)({"params": variables["params"]}, x)
        want = [np.asarray(w) for w in (want if isinstance(want, tuple) else (want,))]
        with torch.no_grad():
            out = model(torch.from_numpy(x).permute(0, 3, 1, 2))
        got_out = [o.permute(0, 2, 3, 1).numpy() if o.dim() == 4 else o.numpy()
                   for o in (out if isinstance(out, tuple) else (out,))]
    for g, w in zip(got_out, want):
        assert g.shape == w.shape and np.abs(w).max() > 0
        assert np.abs(g - w).max() <= ATOL * max(1.0, np.abs(w).max()), np.abs(g - w).max()
    flat = sd["model"] if which == "uois_dsn" else sd
    # a key no rule reads (the UOIS map takes every `.weight` by rule)
    extra = dict(flat, **{"module.extra.running_mean": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="unmapped"):
        importer({"model": extra} if which == "uois_dsn" else extra)
    if which == "cascadepsp":
        missing = dict(sd)
        missing.pop("module.psp.bottleneck.weight")
        with pytest.raises(KeyError):
            importer(missing)

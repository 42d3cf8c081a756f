"""build_base_model for the MSMFormer, UOAIS-Net and UOIS-Net-3D families
against the JAX package's evaluation wrappers on frames of the synthetic-OSD
protocol written to disk, at the same weights.

The native models' weights are the port's seed-0 init saved as an int8
archive in the JAX layout, which both packages read ($QUBER_MSMFORMER_NATIVE_CKPT,
$QUBER_UOAISNET_CKPT). Both wrappers run bfloat16, as the reference's do;
for the comparison both are given the float32 model with the same weights
(the wrappers' reading, preprocessing, selection, pasting and zoom-in are
what is held here: at a random init the bfloat16 scores of the queries and
detections lie within a rounding of each other, and the two frameworks'
bfloat16, which round in other places, order them differently: a seed-0
frame read 1 instance against 0, and 71% of the labels at UOAIS-Net's
threshold 0; the bfloat16 forwards are held by
tests/test_torch_zoo_msmformer.py and chip_smoke.py phase 23).
UOAIS-Net's score threshold is set to 0 through $QUBER_UOAISNET_THRESH so
that its detections are pasted (at this init none scores 0.5). Tolerance:
the instance count equal and >= 99.5% of the pixels' labels equal on every
frame.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quber_tpu.evaluation import datasets as jdata
from quber_tpu.models.msmformer import MSMFormer as JMSMFormer
from quber_tpu.models.msmformer import MSMFormerBaseModel as JMSMFormerBaseModel
from quber_tpu.models.uoais_net import UOAISNet as JUOAISNet
from quber_tpu.models.uoais_net import UOAISNetBaseModel as JUOAISNetBaseModel
from quber_tpu.models.uois_net import DepthSeedingNetwork as JDSN
from quber_tpu.models.uois_net import RegionRefinementNetwork as JRRN
from quber_tpu.models.uois_net import UOISNet3DBaseModel as JUOIS3DBase
from quber_tpu.train.checkpoint import load_quantized_params as jax_load_quantized
from quber_tpu_torch.data.make_synthetic_dataset import main as make_dataset
from quber_tpu_torch.evaluation import base_models as tbase
from quber_tpu_torch.models.from_jax import state_dict_to_jax
from quber_tpu_torch.models.msmformer import MSMFormer, MSMFormerBaseModel, set_compute_dtype
from quber_tpu_torch.models.uoais_net import UOAISNet, UOAISNetBaseModel
from quber_tpu_torch.models.uois_net import UOISNet3DBaseModel
from quber_tpu_torch.train.checkpoint import save_quantized_params

AGREEMENT = 0.995


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("osd"))
    make_dataset(["--out", root, "--n", "2", "--seed", "1000", "--depth-range", "250", "1500"])
    rgb, depth, _ = jdata.build_file_lists("OSD", root)
    return list(zip(rgb, depth))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """{family: int8 archive of the port's seed-0 init (the wrappers' own
    without a checkpoint)}."""
    out = {}
    for name, model in (("msmformer", MSMFormer()), ("uoaisnet", UOAISNet())):
        model.reset_parameters(torch.Generator().manual_seed(0))
        out[name] = str(tmp_path_factory.mktemp(name) / f"{name}_int8.npz")
        save_quantized_params(out[name], state_dict_to_jax(model))
    return out


def labels(masks, shape=(480, 640)):
    out = np.zeros(shape, np.int32)
    for i, m in enumerate(masks):
        out[m] = i + 1
    return out


def _agree(port, ref, keys):
    """The count and the labels of each frame against the reference's, some
    instance on some frame; returns the counts."""
    counts = []
    for i, key in enumerate(keys):
        got, fg, seconds = port.predict(*key)
        want = ref.predict(*key)[0]
        assert got.dtype == bool and got.shape[1:] == (480, 640) and seconds > 0
        assert len(got) == len(want), (i, len(got), len(want))
        agree = float((labels(got) == labels(want)).mean())
        assert agree >= AGREEMENT, (i, agree)
        counts.append(len(got))
    assert sum(counts) > 0  # the wrappers segment something at this init
    return counts


def _float32(port, ref, jax_model):
    """Both wrappers with the float32 model of their weights."""
    assert port.model.dtype == torch.bfloat16 and ref.model.dtype == jnp.bfloat16
    set_compute_dtype(port.model, torch.float32)
    port.model.dtype = torch.float32
    ref.model = jax_model


@pytest.mark.parametrize("name", ["msmformer", "msmformer-zoomin"])
def test_msmformer_base_models_match_jax(name, frames, weights, monkeypatch):
    monkeypatch.setenv("QUBER_MSMFORMER_NATIVE_CKPT", weights["msmformer"])
    port = tbase.build_base_model(name, "OSD", device="cpu")
    assert isinstance(port, MSMFormerBaseModel) and port.zoom_in == name.endswith("zoomin")
    tree = jax.tree.map(np.asarray, jax_load_quantized(weights["msmformer"]))
    ref = JMSMFormerBaseModel(params=tree, zoom_in=port.zoom_in)
    _float32(port, ref, JMSMFormer(num_queries=50))
    _agree(port, ref, frames)


@pytest.mark.parametrize("name", ["uoaisnet", "uoaisnet-amodal"])
def test_uoaisnet_base_models_match_jax(name, frames, weights, monkeypatch):
    monkeypatch.setenv("QUBER_UOAISNET_CKPT", weights["uoaisnet"])
    monkeypatch.setenv("QUBER_UOAISNET_THRESH", "0")
    port = tbase.build_base_model(name, "OSD", device="cpu")
    assert isinstance(port, UOAISNetBaseModel) and port.amodal == name.endswith("amodal")
    tree = jax.tree.map(np.asarray, jax_load_quantized(weights["uoaisnet"]))
    ref = JUOAISNetBaseModel(params=tree, amodal=port.amodal, score_threshold=0.0)
    _float32(port, ref, JUOAISNet())
    _agree(port, ref, frames)


def test_native_base_models_without_a_checkpoint_take_seed_0(monkeypatch, tmp_path):
    monkeypatch.setenv("QUBER_MSMFORMER_NATIVE_CKPT", str(tmp_path / "missing"))
    a = tbase.build_base_model("msmformer", "OSD", device="cpu")
    b = MSMFormerBaseModel(device="cpu")
    assert all(torch.equal(v, b.model.state_dict()[k]) for k, v in a.model.state_dict().items())
    with pytest.raises(NotImplementedError) as err:
        tbase.build_base_model("no-such-base", "OSD", device="cpu")
    available = str(err.value).split("available: ")[1].split(", ")
    for name in ("msmformer", "msmformer-zoomin", "msmformer-pretrained", "uoaisnet",
                 "uoaisnet-amodal", "uoaisnet-pretrained", "uoisnet3d", "uoisnet3d-pretrained"):
        assert name in available


class _TwoSlotUOIS(JUOIS3DBase):
    MAX_INSTANCES = 2


def test_uoisnet3d_base_model_matches_jax(frames, tmp_path, monkeypatch):
    """build_base_model("uoisnet3d") from train_zoo_torch-style checkpoint
    directories ($QUBER_UOIS3D_DSN_CKPT / _RRN_CKPT) against the JAX wrapper
    on the first frame: the port's seeded init with the DSN head's offset
    rows zeroed (votes = the cloud) and its foreground bias +5, the float32
    models, and the first 2 of the 32 slots refined in both (the RRN runs
    at 480x640 per slot)."""
    from quber_tpu_torch.models import uois_net as TU
    from quber_tpu_torch.train.checkpoint import save_params

    dsn, rrn = TU.DepthSeedingNetwork(), TU.RegionRefinementNetwork()
    dsn.reset_parameters(torch.Generator().manual_seed(0))
    rrn.reset_parameters(torch.Generator().manual_seed(1))
    with torch.no_grad():
        dsn.unet.head.weight[2:] = 0.0
        dsn.unet.head.bias[1] += 5.0
    for env, model, name in (("QUBER_UOIS3D_DSN_CKPT", dsn, "ckpt_dsn"),
                             ("QUBER_UOIS3D_RRN_CKPT", rrn, "ckpt_rrn")):
        save_params(str(tmp_path / name), state_dict_to_jax(model), step=1)
        monkeypatch.setenv(env, str(tmp_path / name))
    port = tbase.build_base_model("uoisnet3d", "OSD", device="cpu")
    assert isinstance(port, UOISNet3DBaseModel) and port.dsn.dtype == torch.bfloat16
    for model in (port.dsn, port.rrn):
        set_compute_dtype(model, torch.float32)
    port.MAX_INSTANCES = _TwoSlotUOIS.MAX_INSTANCES
    ref = _TwoSlotUOIS(dsn_params=state_dict_to_jax(dsn), rrn_params=state_dict_to_jax(rrn))
    ref.dsn, ref.rrn = JDSN(), JRRN()
    _agree(port, ref, frames[:1])
    monkeypatch.setenv("QUBER_UOIS3D_DSN_CKPT", str(tmp_path / "missing"))
    seeded = tbase.build_base_model("uoisnet3d", "OSD", device="cpu")
    want = UOISNet3DBaseModel(device="cpu").dsn.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in seeded.dsn.state_dict().items())

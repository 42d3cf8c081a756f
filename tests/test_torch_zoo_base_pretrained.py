"""build_base_model("msmformer-pretrained" / "uoaisnet-pretrained" /
"uoisnet3d-pretrained") against
the JAX package's wrappers over imported reference weights, on two frames of
the synthetic-OSD protocol written to disk.

No released checkpoint is in the repository: each wrapper reads a
synthesised state dict at the released models' full widths with the
reference's key layout (tests/test_torch_zoo_pretrained.py's, seeded, the
class and mask biases moved so that the wrappers keep detections), saved
as a .pth that $QUBER_MSMFORMER_CKPT / $QUBER_UOAIS_CKPT name; the JAX
wrappers take the same state dict through the JAX package's importers.
Tolerance: the instance count equal and >= 99.5% of the pixels' labels
equal on every frame. Without $QUBER_UOAIS_CKPT the UOAIS-Net wrapper takes
a random init, as the reference's does; msmformer-pretrained needs its
checkpoint. UOIS-Net-3D's DSN and RRN are synthesised at feature_dim 10
(the wrapper reads the width off the weights), the DSN's centre head zeroed
and its object class taking every pixel, and both wrappers run their float32
models (at a random init bfloat16 decides the classes differently).
"""

import numpy as np
import pytest
import torch

from quber_tpu.evaluation import datasets as jdata
from quber_tpu.models import import_zoo as JIZ
from quber_tpu.models.msmformer_pretrained import PretrainedMSMFormerBaseModel as JMSMBase
from quber_tpu.models.uoais_net_pretrained import UOAISNetPretrainedBaseModel as JUOAISBase
from quber_tpu_torch.data.make_synthetic_dataset import main as make_dataset
from quber_tpu_torch.evaluation import base_models as tbase
from quber_tpu_torch.models.msmformer_pretrained import PretrainedMSMFormerBaseModel
from quber_tpu_torch.models.uoais_net_pretrained import UOAISNetPretrainedBaseModel
from test_torch_zoo_base import _agree
from test_torch_zoo_pretrained import (  # noqa: F401
    UOIS_FD, reference_msmformer_state, reference_uois_cascade_state, uoais_state)

FULL_MSM = dict(embed_dim=64, hidden_dim=256, nheads=8, dim_feedforward=2048, num_queries=100,
                dec_layers=6, num_classes=2, mask_dim=256)


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


def _save(sd, path):
    torch.save({"model": {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}}, path)
    return path


def test_msmformer_pretrained_matches_jax(frames, tmp_path, monkeypatch):
    sd = reference_msmformer_state(seed=4, **FULL_MSM)
    # queries of class 1 (the object class) above the wrapper's 0.7
    sd["sem_seg_head.predictor.class_embed.bias"][1] += 4.0
    monkeypatch.setenv("QUBER_MSMFORMER_CKPT", _save(sd, str(tmp_path / "msm.pth")))
    port = tbase.build_base_model("msmformer-pretrained", "OSD", device="cpu")
    assert isinstance(port, PretrainedMSMFormerBaseModel)
    _agree(port, JMSMBase(JIZ.import_msmformer(sd)), frames)
    monkeypatch.setenv("QUBER_MSMFORMER_CKPT", str(tmp_path / "missing"))
    with pytest.raises(FileNotFoundError):
        tbase.build_base_model("msmformer-pretrained", "OSD", device="cpu")


def test_uoaisnet_pretrained_matches_jax(frames, uoais_state, tmp_path, monkeypatch):  # noqa: F811
    uoais_state = dict(uoais_state)
    # detections of the foreground class (index 0) well above the wrapper's
    # 0.5, and visible masks that cover pixels (their logits are ~0.04 here)
    for key, index, shift in (("roi_heads.box_predictor.cls_score.bias", 0, 4.0),
                              ("roi_heads.visible_mask_head.predictor.bias", 0, 2.0)):
        bias = uoais_state[key].copy()
        bias[index] += shift
        uoais_state[key] = bias
    monkeypatch.setenv("QUBER_UOAIS_CKPT", _save(uoais_state, str(tmp_path / "uoais.pth")))
    monkeypatch.delenv("QUBER_CGNET_CKPT", raising=False)
    port = tbase.build_base_model("uoaisnet-pretrained", "OSD", device="cpu")
    assert isinstance(port, UOAISNetPretrainedBaseModel) and port.fg is None
    _agree(port, JUOAISBase(JIZ.import_uoais_net(uoais_state)["params"]), frames)
    monkeypatch.setenv("QUBER_UOAIS_CKPT", str(tmp_path / "missing"))
    seeded = tbase.build_base_model("uoaisnet-pretrained", "OSD", device="cpu")
    want = UOAISNetPretrainedBaseModel(device="cpu").model.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in seeded.model.state_dict().items())


def test_uoisnet3d_pretrained_matches_jax(frames, tmp_path, monkeypatch):
    from quber_tpu.models.uois_net_pretrained import PretrainedDSN as JDSN
    from quber_tpu.models.uois_net_pretrained import PretrainedRRN as JRRN
    from quber_tpu.models.uois_net_pretrained import UOISNet3DPretrainedBaseModel as JUOIS
    from quber_tpu_torch.models import uois_net_pretrained as TUP

    dsn, _ = reference_uois_cascade_state("uois_dsn", seed=5)
    rrn, _ = reference_uois_cascade_state("uois_rrn", seed=6)
    sd = dsn["model"]
    sd["module.cd_module.weight"] = np.zeros_like(sd["module.cd_module.weight"])
    sd["module.fg_module.weight"] = np.zeros_like(sd["module.fg_module.weight"])
    sd["module.fg_module.weight"][2] = 1.0
    sd["module.decoder.last_conv.bias"] = sd["module.decoder.last_conv.bias"] + 3.0
    monkeypatch.setenv("QUBER_UOIS_DSN_CKPT", _save(sd, str(tmp_path / "dsn.pth")))
    monkeypatch.setenv("QUBER_UOIS_RRN_CKPT", _save(rrn, str(tmp_path / "rrn.pth")))
    port = tbase.build_base_model("uoisnet3d-pretrained", "OSD", device="cpu")
    assert isinstance(port, TUP.UOISNet3DPretrainedBaseModel)
    for model in (port.dsn, port.rrn):
        assert model.dtype == torch.bfloat16
        TUP.set_dtype(model, torch.float32)
    ref = JUOIS(JIZ.import_uois_dsn(dsn), JIZ.import_uois_rrn(rrn), feature_dim=UOIS_FD)
    ref.dsn, ref.rrn = JDSN(feature_dim=UOIS_FD), JRRN(feature_dim=UOIS_FD)
    _agree(port, ref, frames[:1])
    monkeypatch.setenv("QUBER_UOIS_DSN_CKPT", str(tmp_path / "missing"))
    seeded = tbase.build_base_model("uoisnet3d-pretrained", "OSD", device="cpu")
    want = TUP.UOISNet3DPretrainedBaseModel(device="cpu").dsn.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in seeded.dsn.state_dict().items())

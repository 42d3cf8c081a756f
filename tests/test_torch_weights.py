"""Config and weights: the port reads what the JAX package reads.

The in-repo int8 flagship archive carried across with state_dict_from_jax
loads strict into the full flagship MaskRefiner, each flax leaf used once.
"""

import dataclasses
import os

import numpy as np
import torch

from quber_tpu.config import load_config as jax_load_config
from quber_tpu.models.import_torch import conv_kernel_inv
from quber_tpu.models.mask_refiner import MaskRefinerConfig as JConfig
from quber_tpu.train.checkpoint import load_quantized_params as jax_load_quantized
from quber_tpu_torch.config import load_config
from quber_tpu_torch.models.from_jax import state_dict_from_jax
from quber_tpu_torch.models.mask_refiner import MaskRefiner, MaskRefinerConfig
from quber_tpu_torch.train.checkpoint import load_default_params, load_quantized_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "weights", "flagship_synth_int8.npz")
FLAGSHIP = os.path.join(REPO, "configs",
                        "mask_refiner_rgbd_concat_l2_gn_hf_m_b_f_c_o_l3_e2_b8.yaml")


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, key)
        else:
            yield key, v


def test_config_fields_and_defaults_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(JConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(MaskRefinerConfig)}
    assert tf == jf
    assert MaskRefinerConfig().compute_dtype == torch.float32
    assert MaskRefinerConfig(dtype="bfloat16").compute_dtype == torch.bfloat16
    assert MaskRefinerConfig().num_input_channels == JConfig().num_input_channels == 9


def test_load_config_flagship_matches_jax_and_defaults():
    model, train = load_config(FLAGSHIP)
    jmodel, jtrain = jax_load_config(FLAGSHIP)
    assert dataclasses.asdict(model) == dataclasses.asdict(jmodel)
    assert model == MaskRefinerConfig()  # the defaults are the flagship
    assert dataclasses.asdict(train) == dataclasses.asdict(jtrain)
    assert train.batch_size == 8


def test_load_quantized_params_matches_jax():
    ours = dict(_leaves(load_quantized_params(WEIGHTS)))
    ref = dict(_leaves(jax_load_quantized(WEIGHTS)))
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    assert len(ours) == 749  # 902 archive entries, 153 of them ::s scales
    assert sum(k.startswith("batch_stats/") for k in ours) == 32


def test_flagship_weights_load_strict_each_leaf_once():
    params = load_default_params()
    leaves = dict(_leaves(params))
    sd = state_dict_from_jax(params)
    assert len(sd) == len(leaves)  # a rename: no leaf dropped or merged
    model = MaskRefiner(MaskRefinerConfig())
    model.load_state_dict(sd, strict=True)
    assert set(sd) == set(model.state_dict())
    # conv kernels go HWIO -> OIHW, the JAX package's own inverse map
    k = "params/backbone/rgb_trunk/stem/conv1/conv/kernel"
    np.testing.assert_array_equal(
        model.backbone.rgb_trunk.stem.conv1.conv.weight.detach().numpy(), conv_kernel_inv(leaves[k]))
    bn = model.ins_embed_head.fusion_1.reduce.norm
    np.testing.assert_array_equal(
        bn.running_var.numpy(),
        leaves["batch_stats/ins_embed_head/fusion_1/reduce/BatchNorm_0/var"])

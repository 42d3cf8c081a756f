"""train_zoo_torch.py --model gsam against tools/train_zoo.py's recipe
(train_gsam) at a small size: 64x64 scenes, the recipe's text tower and
grounder at their widths in float32, and a small SAMHQ (64x64 frames, two
blocks 32 wide) in place of SAMHQ_SYNTH_ARCH.

One step from the port's seeded init carried to the reference (as
tests/test_torch_zoo_train_openvocab.py holds --model detic): the
grounder's losses and the SAM leg's "sam_total" (the recipe's sam_step:
one encode, the slots' box decodes, focal + dice on the HQ masks over the
valid slots) rtol 1e-3, every gradient with cosine >= 0.999. The grounder
has one phrase, so jax.nn.one_hot leaves every colour class but 0 without
a positive class target, and so must the port. Then the CLI at the
recipe's SAM: a CPU step writes the {text, grounder, sam} tree, vocab.json
and arch.json, which build_base_model("grounded-sam") loads.
"""

import json

import jax
import jax.numpy as jnp
import pytest
import torch

from quber_tpu.models import sam_hq as JS
from quber_tpu_torch.evaluation import base_models as tbase
from quber_tpu_torch.models.open_vocab import GROUNDING_PROMPT
from quber_tpu_torch.models.from_jax import state_dict_from_jax, state_dict_to_jax
from quber_tpu_torch.models.layers import set_compute_dtype
from test_torch_zoo_train_openvocab import (
    H, LR, SEED, W, check_loaded, check_step, jax_recipe_step, run_cli)

SAM_ARCH = dict(img_size=64, embed_dim=32, depth=2, num_heads=2, global_blocks=(1,),
                window_size=2)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_first_step_matches_the_jax_recipe(monkeypatch):
    import train_zoo_torch

    scene, sam_scene = 1, 0
    pool = train_zoo_torch.make_gsam_scenes(2, H, W, SEED, (250, 1500),
                                            img_size=SAM_ARCH["img_size"])
    valid = pool["valid"][scene]
    assert (pool["classes"][scene][valid] != 0).any()  # classes without a positive target
    monkeypatch.setattr(train_zoo_torch, "SAMHQ_SYNTH_ARCH", SAM_ARCH)
    model, optimizer = train_zoo_torch.make_gsam(SEED, LR, "cpu")
    set_compute_dtype(model["grounder"], torch.float32)
    loss, parts, grads = jax_recipe_step(model, "grounder", [GROUNDING_PROMPT],
                                         {k: pool[k] for k in ("bgr", "boxes", "classes",
                                                               "masks", "valid")}, scene)
    sam = JS.SAMHQ(**SAM_ARCH)
    img, boxes, tgt, ok = (jnp.asarray(pool[k][sam_scene])
                           for k in ("sam_img", "sam_boxes", "sam_tgt", "valid"))

    def sam_loss(v):  # the recipe's sam_step
        embed, interm = sam.apply(v, img[None], method=JS.SAMHQ.encode)

        def one(box, t, o):
            m_out, _, _ = sam.apply(v, embed, interm, box[None], False, True,
                                    method=JS.SAMHQ.decode_box)
            return JS.sam_hq_mask_loss(m_out[:, 0], t[None]) * o

        per = jax.vmap(one)(boxes, tgt, ok.astype(jnp.float32))
        return per.sum() / jnp.maximum(ok.sum(), 1)

    sl, sgrads = jax.jit(jax.value_and_grad(sam_loss))(state_dict_to_jax(model["sam"]))
    parts["sam_total"] = float(sl)
    grads.update({f"sam.{k}": v for k, v in state_dict_from_jax(sgrads).items()})
    step = train_zoo_torch.make_gsam_step(model, optimizer, size=2, seed=SEED)
    check_step(model, step(train_zoo_torch.stage(pool, "cpu"), scene, sam_scene=sam_scene),
               (loss, parts, grads))


def test_cli_checkpoint_loads_by_name(tmp_path, monkeypatch):
    import train_zoo_torch

    out = run_cli(tmp_path, "gsam")
    arch = {k: list(v) if isinstance(v, tuple) else v
            for k, v in train_zoo_torch.SAMHQ_SYNTH_ARCH.items()}
    assert json.load(open(out / "arch.json")) == arch
    assert json.load(open(out / "vocab.json")) == [GROUNDING_PROMPT]
    monkeypatch.setenv("QUBER_GSAM_CKPT", str(out / "ckpt"))
    base = tbase.build_base_model("grounded-sam", "OSD", device="cpu")
    assert base.sam_size == arch["img_size"] and base.text_prompt == GROUNDING_PROMPT
    check_loaded(tbase.load_eval_params(str(out / "ckpt")),
                 {"text": base.text_encoder, "grounder": base.grounder, "sam": base.sam})

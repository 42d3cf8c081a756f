"""The port's CLIP text stack (quber_tpu_torch/models/clip_text.py) against
the JAX package's (quber_tpu/models/clip_text.py).

The tokenizer: ids equal to the reference's and to the hand-derived golden
ids of the committed mini merges file, and on merges files the test writes
(plain and gzip, truncation at the context length). The word split, written
without `regex` (the card's machine has no such package): equal to
`regex.findall` of CLIP's pattern on Latin, accented, combining-mark,
CJK-numeral, Arabic-digit, superscript, Roman-numeral, fraction, emoji,
contraction and punctuation strings (`regex` is imported here only). The
text tower and import_clip_text: a seeded state dict in OpenAI CLIP's
layout (a visual tower and logit_scale beside it) imported by both
packages, the port's import equal to the reference's carried over by
from_jax, the embeddings within 1e-5.
"""

import gzip
import json
import os

import jax
import numpy as np
import pytest
import torch

from quber_tpu.models import clip_text as JC
from quber_tpu.models import import_zoo as JIZ
from quber_tpu_torch.models import clip_text as TC
from quber_tpu_torch.models.from_jax import state_dict_from_jax, state_dict_to_jax
from quber_tpu_torch.models.import_zoo import import_clip_text

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
MINI = os.path.join(FIXTURES, "clip_mini_merges.txt")
PATTERN = (r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
           r"""|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""")
SPLIT_CASES = [
    "a cup!", "The quick brown fox, 42 times.", "café naïve façade Ørsted Łódź",
    "é äb ᾳͅx ͅ", "一二三 十万 〇", "٣٤٥ ۱۲ ०१",
    "x² y³ ¹⁰", "Ⅻ ⅻ ↂ", "½ ¾ ⅓", "🙂 👍🏽 🇩🇪 ☃", "...!!?? --- ;:,",
    "can't won't I'LL it's WE'RE they've I'M she'd 'S", "itſ ſtop 'ſ",
    "<|startoftext|>a cup<|endoftext|>", "<|STARTOFTEXT|>", "x\x1cy\x1fz", "ＡＢＣ１２３",
    "日本語テキスト 123abc", "tab\tnew\nline  spaces", "", "&amp;lt;cup&amp;gt;",
]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_split_equals_the_regex_pattern():
    regex = pytest.importorskip("regex")
    pat = regex.compile(PATTERN, regex.IGNORECASE)
    for text in SPLIT_CASES:
        assert TC.split_words(text) == pat.findall(text), text
        low = " ".join(text.split()).lower()  # as encode() hands it over
        assert TC.split_words(low) == pat.findall(low), low


def test_tokenizer_golden_fixture():
    with open(os.path.join(FIXTURES, "clip_mini_golden.json")) as f:
        golden = json.load(f)
    tok = TC.CLIPTokenizer(MINI, context_length=16)
    assert tok.vocab_size == golden["vocab_size"]
    assert tok.encoder[tok.SOT] == golden["sot"] and tok.encoder[tok.EOT] == golden["eot"]
    for text, ids in golden["texts"].items():
        assert tok.encode(text) == ids, text


def _write(path, merges, gz):
    text = "\n".join(["#version: 0.2"] + [f"{a} {b}" for a, b in merges])
    with (gzip.open(path, "wt", encoding="utf-8") if gz else open(path, "w",
                                                                   encoding="utf-8")) as f:
        f.write(text)


@pytest.mark.parametrize("merges", ["mini", "plain", "gzip"])
def test_tokenizer_equals_the_reference(tmp_path, merges):
    if merges == "mini":
        path = MINI
    else:
        path = str(tmp_path / ("merges.txt.gz" if merges == "gzip" else "merges.txt"))
        _write(path, [("l", "o"), ("lo", "w"), ("e", "r</w>"), ("c", "a"), ("ca", "n</w>"),
                      ("ü", "b"), ("ä", "r</w>"), ("ð", "Ł")], merges == "gzip")
    texts = list(json.load(open(os.path.join(FIXTURES, "clip_mini_golden.json")))["texts"])
    texts += SPLIT_CASES + ["lower LOW low. can can't über bär", "w " * 40]
    want, got = JC.CLIPTokenizer(path, context_length=12), TC.CLIPTokenizer(path, 12)
    assert got.encoder == want.encoder
    for text in texts:
        assert got.encode(text) == want.encode(text), text
    np.testing.assert_array_equal(got(texts), want(texts))
    assert got(texts)[-1, -1] == got.encoder[got.EOT]  # cut, <eot> kept


CFG = dict(width=64, layers=2, heads=4, context_length=16, embed_dim=32)


def _clip_state_dict(vocab, seed=0):
    """A seeded state dict in OpenAI CLIP's layout (text tower, a stub of the
    visual tower, logit_scale)."""
    rng = np.random.RandomState(seed)
    c, n = CFG["width"], CFG["context_length"]

    def r(*shape, s=0.05):
        return torch.from_numpy((rng.randn(*shape) * s).astype(np.float32))

    sd = {"token_embedding.weight": r(vocab, c, s=0.5), "positional_embedding": r(n, c, s=0.3),
          "text_projection": r(c, CFG["embed_dim"], s=0.2), "logit_scale": torch.tensor(4.6),
          "ln_final.weight": 1 + r(c), "ln_final.bias": r(c),
          "visual.conv1.weight": r(8, 3, 4, 4), "visual.proj": r(8, 4)}
    for i in range(CFG["layers"]):
        t = f"transformer.resblocks.{i}"
        sd.update({f"{t}.ln_1.weight": 1 + r(c), f"{t}.ln_1.bias": r(c),
                   f"{t}.attn.in_proj_weight": r(3 * c, c, s=0.2),
                   f"{t}.attn.in_proj_bias": r(3 * c),
                   f"{t}.attn.out_proj.weight": r(c, c, s=0.2), f"{t}.attn.out_proj.bias": r(c),
                   f"{t}.ln_2.weight": 1 + r(c), f"{t}.ln_2.bias": r(c),
                   f"{t}.mlp.c_fc.weight": r(4 * c, c, s=0.2), f"{t}.mlp.c_fc.bias": r(4 * c),
                   f"{t}.mlp.c_proj.weight": r(c, 4 * c, s=0.1), f"{t}.mlp.c_proj.bias": r(c)})
    return sd


def test_text_tower_and_import_against_the_reference():
    tok = TC.CLIPTokenizer(MINI, context_length=CFG["context_length"])
    sd = _clip_state_dict(tok.vocab_size)
    ids = tok(["cup", "a cup!", "cupboard bowl mug can", "7 cups", "", "w " * 30])

    jtree = JIZ.import_clip_text({k: v.numpy() for k, v in sd.items()})
    want = np.asarray(JC.CLIPTextEncoder(vocab_size=tok.vocab_size, **CFG).apply(jtree, ids))

    got_sd = import_clip_text(sd)
    model = TC.CLIPTextEncoder(vocab_size=tok.vocab_size, **CFG).eval()
    model.load_state_dict(got_sd, strict=True)
    carried = state_dict_from_jax(jax.tree.map(np.asarray, jtree))
    assert set(carried) == set(got_sd)
    for k, v in carried.items():
        torch.testing.assert_close(got_sd[k], v, rtol=0, atol=0, msg=k)
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)

    flat = lambda t: dict(jax.tree_util.tree_leaves_with_path(t))  # noqa: E731
    back, ref = flat(state_dict_to_jax(model)), flat(jax.tree.map(np.asarray, jtree))
    assert set(back) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k])

    text_only = {k: v for k, v in sd.items() if not k.startswith("visual.") and k != "logit_scale"}
    assert set(import_clip_text(text_only)) == set(got_sd)
    with pytest.raises(KeyError):
        import_clip_text(dict(sd, **{"transformer.extra": torch.zeros(1)}))


def test_make_text_tower_with_a_merges_file():
    """open_vocab.make_text_tower's CLIP branch (the wrappers' `bpe_path`):
    the vocabulary's names with '_' as spaces, tokenised and embedded as the
    reference's."""
    from quber_tpu.models import open_vocab as JO
    from quber_tpu_torch.models import open_vocab as TO

    vocab = TO.VOCABULARIES["OSD"]
    clip_config = dict(CFG, vocab_size=524)
    model, inputs = TO.make_text_tower(vocab, MINI, clip_config)
    model.reset_parameters(torch.Generator().manual_seed(4))
    _, _, apply = JO.make_text_tower(vocab, MINI, clip_config)
    want = np.asarray(apply(state_dict_to_jax(model)))
    with torch.no_grad():
        got = model.eval()(*inputs).numpy()
    assert got.shape == (len(vocab), CFG["embed_dim"])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

"""CLIP's text stack: the byte-pair-encoding tokenizer and the text tower
(torch).

Port of quber_tpu/models/clip_text.py:
  * CLIPTokenizer: OpenAI CLIP's SimpleTokenizer (the `bpe_simple_vocab_16e6
    .txt[.gz]` merges file, its first 48,894 merges after the header; html
    unescaped twice, whitespace collapsed, lowercased; per-word BPE with an
    end-of-word marker; `<sot> ... <eot>` padded to the context length, a
    truncation keeping `<eot>`). The reference splits words with the `regex`
    package's pattern
        <|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d
        |[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+        (IGNORECASE)
    which the card's machine does not have: `split_words` scans the same
    alternatives with the standard library's unicodedata (letters are the
    L* categories, numbers the N* categories). Under IGNORECASE the pattern
    also takes the long s (U+017F) for 's' in the literals, and U+0345
    (which case-folds to a letter) falls in none of the three classes and
    is skipped: the scanner does both. Code points that Python's unicodedata does not assign (Cn)
    fall in the last class, where a newer Unicode in `regex` may know them
    as letters.
  * CLIPTextEncoder: the weight-compatible text transformer (ViT-B's by
    default): token and positional embeddings, causal residual attention
    blocks (fused in_proj, QuickGELU, LayerNorm eps 1e-5), ln_final in
    float32, the pooled row at argmax(ids) (the <eot> id is the largest)
    times text_projection, L2-normalised. import_zoo.import_clip_text fills
    it from a CLIP state dict.

It computes in float32, as the open-vocabulary wrappers and recipes run
their text towers.
"""

from __future__ import annotations

import gzip
import html
import unicodedata
from functools import lru_cache

import numpy as np
import torch
from torch import nn

from quber_tpu_torch.models.layers import Dense, LayerNorm, flax_softmax


@lru_cache()
def bytes_to_unicode():
    """Reversible byte -> printable-unicode map (GPT-2 / CLIP): the 188
    printable latin-1 bytes map to themselves, the rest to 256 + n."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return {(a, b) for a, b in zip(word, word[1:])}


_SPECIALS = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
# the ASCII-range whitespace that str.isspace() takes and `regex`'s \s does not
_NOT_SPACE = frozenset("\x1c\x1d\x1e\x1f")
# combining ypogegrammeni: case-folds to a letter, so under IGNORECASE it is
# neither a letter nor outside the letters and numbers
_NO_CLASS = frozenset("\u0345")


def _fold(c: str) -> str:
    """A character as IGNORECASE compares it with the pattern's lowercase
    ASCII literals."""
    return "s" if c == "\u017f" else c.lower()  # long s


def _kind(c: str) -> str:
    """"L" letter, "N" number, " " whitespace or no class, "O" any other."""
    if c in _NO_CLASS or (c.isspace() and c not in _NOT_SPACE):
        return " "
    cat = unicodedata.category(c)[0]
    return cat if cat in "LN" else "O"


def _literal_at(text: str, i: int, lit: str) -> bool:
    return len(text) - i >= len(lit) and all(_fold(text[i + j]) == ch
                                             for j, ch in enumerate(lit))


def split_words(text: str) -> list[str]:
    """`regex.findall` of CLIP's word pattern (IGNORECASE) over `text`:
    at each position the special tokens, the contractions, a run of
    letters, one number, or a run of characters that are none of
    whitespace, letter or number, in that order; a position none matches
    is skipped."""
    out = []
    i, n = 0, len(text)
    while i < n:
        lit = next((s for s in _SPECIALS + _CONTRACTIONS if _literal_at(text, i, s)), None)
        if lit is not None:
            out.append(text[i:i + len(lit)])
            i += len(lit)
            continue
        kind = _kind(text[i])
        if kind == " ":
            i += 1
            continue
        j = i + 1
        if kind != "N":  # letters and the last class run on; a number is one character
            while j < n and _kind(text[j]) == kind:
                j += 1
        out.append(text[i:j])
        i = j
    return out


class CLIPTokenizer:
    """CLIP's SimpleTokenizer: lowercase, the word split, byte-encode,
    per-word BPE with an end-of-word marker.

    Args:
      bpe_path: the merges file (`bpe_simple_vocab_16e6.txt` or `.txt.gz`: a
        version header, then the merges).
      context_length: the padded sequence length (CLIP's 77)."""

    SOT = "<|startoftext|>"
    EOT = "<|endoftext|>"

    def __init__(self, bpe_path: str, context_length: int = 77):
        self.context_length = context_length
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # CLIP's merges[1 : 49152 - 256 - 2 + 1]: the header dropped, 48894 kept
        merges = [tuple(m.split()) for m in lines[1: 49152 - 256 - 2 + 1] if m]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += [self.SOT, self.EOT]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {self.SOT: self.SOT, self.EOT: self.EOT}

    @property
    def vocab_size(self):
        return len(self.encoder)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        text = html.unescape(html.unescape(text))
        text = " ".join(text.split()).strip().lower()
        ids = []
        for token in split_words(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def __call__(self, texts) -> np.ndarray:
        """[B, context_length] int32: <sot> tokens <eot>, zero-padded, cut so
        that <eot> stays."""
        if isinstance(texts, str):
            texts = [texts]
        sot, eot = self.encoder[self.SOT], self.encoder[self.EOT]
        out = np.zeros((len(texts), self.context_length), np.int32)
        for i, text in enumerate(texts):
            ids = [sot] + self.encode(text) + [eot]
            if len(ids) > self.context_length:
                ids = ids[: self.context_length]
                ids[-1] = eot
            out[i, : len(ids)] = ids
        return out


def quick_gelu(x):
    """OpenAI CLIP's QuickGELU: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


class ResidualAttentionBlock(nn.Module):
    """Pre-norm causal self-attention (torch MultiheadAttention's fused
    in_proj) and a QuickGELU MLP, each residual."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.ln_1 = LayerNorm(width, eps=1e-5)
        self.in_proj = Dense(width, 3 * width)
        self.out_proj = Dense(width, width)
        self.ln_2 = LayerNorm(width, eps=1e-5)
        self.c_fc = Dense(width, 4 * width)
        self.c_proj = Dense(4 * width, width)

    def forward(self, x, causal_mask):
        b, n, c = x.shape
        nh = self.heads
        q, k, v = (t.reshape(b, n, nh, c // nh).transpose(1, 2)
                   for t in self.in_proj(self.ln_1(x)).chunk(3, dim=-1))
        attn = (q / float(np.sqrt(c // nh))) @ k.transpose(-2, -1)
        attn = flax_softmax(attn.masked_fill(~causal_mask, -float("inf")))
        o = (attn @ v).transpose(1, 2).reshape(b, n, c)
        x = x + self.out_proj(o)
        y = self.c_fc(self.ln_2(x))
        return x + self.c_proj(quick_gelu(y))


class CLIPTextEncoder(nn.Module):
    """CLIP's text tower: causal transformer over BPE ids, the <eot> row
    projected and L2-normalised. forward(ids [B, L] int) -> [B, embed_dim]
    float32."""

    def __init__(self, vocab_size: int = 49408, width: int = 512, layers: int = 12,
                 heads: int = 8, context_length: int = 77, embed_dim: int = 512):
        super().__init__()
        self.context_length = context_length
        self.token_embedding = nn.Parameter(torch.empty(vocab_size, width))
        self.positional_embedding = nn.Parameter(torch.empty(context_length, width))
        for i in range(layers):
            self.add_module(f"resblock_{i}", ResidualAttentionBlock(width, heads))
        self.layers = layers
        self.ln_final = LayerNorm(width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.empty(width, embed_dim))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The flax module's initialisers: embeddings N(0, 0.02^2) and (the
        positions) N(0, 0.01^2), text_projection N(0, 0.02^2), LeCun-normal
        kernels, zero biases, unit norms."""
        from quber_tpu_torch.models.msmformer import reset_flax_init

        reset_flax_init(self, generator)
        for p, std in ((self.token_embedding, 0.02), (self.positional_embedding, 0.01),
                       (self.text_projection, 0.02)):
            p.copy_(torch.randn(p.shape, generator=generator) * std)

    def forward(self, ids):
        ids = ids.long()
        n = ids.shape[1]
        x = self.token_embedding[ids] + self.positional_embedding[None, :n]
        causal = torch.ones(n, n, dtype=torch.bool, device=ids.device).tril()[None, None]
        for i in range(self.layers):
            x = getattr(self, f"resblock_{i}")(x, causal)
        x = self.ln_final(x)
        pooled = x[torch.arange(x.shape[0], device=x.device), ids.argmax(dim=-1)]
        out = pooled @ self.text_projection
        return out / out.norm(dim=-1, keepdim=True).clamp_min(1e-8)

"""CLIP's text tower and its BPE tokenizer, plain, for Stable Diffusion v1's conditioning.

The text transformer of openai/clip-vit-large-patch14 as transformers'
modeling_clip.py runs it: token and position embeddings, pre-LN layers of
causal multi-head attention (q, k, v and out projections with biases, the
logits scaled by dh^-0.5 and masked by a triangle of float32's minimum) and
an MLP of quick_gelu (x * sigmoid(1.702 x)), then the final LayerNorm; the
conditioning is its last hidden state. Keys are transformers'
`text_model.*` keys.

The tokenizer is transformers' CLIPTokenizer without ftfy: BERT's basic
cleaning (control characters dropped, whitespace collapsed, CJK spaced,
NFC, lower case), CLIP's split pattern, byte-level BPE by the ranks of
merges.txt, ids from vocab.json (unknown pieces take <|endoftext|>'s id),
then <|startoftext|>, at most 75 pieces, <|endoftext|>, padded with
<|endoftext|> to 77.
"""

from __future__ import annotations

import functools
import json
import re
import unicodedata
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from port_bench.reference.layers import (FP32, Embedding, Linear, Norm, Precision, attention,
                                         layer_norm)

BOS, EOS = "<|startoftext|>", "<|endoftext|>"
N_MERGES = 49152 - 256 - 2


class _Attention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (Linear(d, d) for _ in range(4))


class _MLP(nn.Module):
    def __init__(self, d: int, inner: int):
        super().__init__()
        self.fc1, self.fc2 = Linear(d, inner), Linear(inner, d)


class _Layer(nn.Module):
    def __init__(self, d: int, inner: int):
        super().__init__()
        self.self_attn, self.mlp = _Attention(d), _MLP(d, inner)
        self.layer_norm1, self.layer_norm2 = Norm(d), Norm(d)


class _Embeddings(nn.Module):
    def __init__(self, vocab: int, positions: int, d: int):
        super().__init__()
        self.token_embedding = Embedding(vocab, d)
        self.position_embedding = Embedding(positions, d)


class _Encoder(nn.Module):
    def __init__(self, d: int, inner: int, n: int):
        super().__init__()
        self.layers = nn.ModuleList(_Layer(d, inner) for _ in range(n))


class _TextTransformer(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d = cfg["hidden_size"]
        self.embeddings = _Embeddings(cfg["vocab_size"], cfg["max_position_embeddings"], d)
        self.encoder = _Encoder(d, cfg["intermediate_size"], cfg["num_hidden_layers"])
        self.final_layer_norm = Norm(d)


class CLIPText(nn.Module):
    """`cfg`: the configuration file's `text_encoder` group (transformers'
    CLIPTextConfig keys)."""

    def __init__(self, cfg: dict):
        super().__init__()
        if cfg["hidden_act"] != "quick_gelu":
            raise ValueError("the reference text tower is OpenAI's, with quick_gelu")
        self.heads, self.eps = cfg["num_attention_heads"], cfg["layer_norm_eps"]
        self.text_model = _TextTransformer(cfg)

    def forward(self, ids: torch.Tensor, prec: Precision = FP32) -> torch.Tensor:
        """The last hidden state (B, T, D) of int ids (B, T)."""
        tm, eps = self.text_model, self.eps
        t = ids.shape[1]
        x = (tm.embeddings.token_embedding.weight[ids]
             + tm.embeddings.position_embedding.weight[:t][None])
        mask = torch.full((t, t), torch.finfo(torch.float32).min, device=x.device).triu(1)
        d = x.shape[-1]
        for layer in tm.encoder.layers:
            a = layer.self_attn
            h = layer_norm(x, layer.layer_norm1, eps)
            q, k, v = a.q_proj(h, prec), a.k_proj(h, prec), a.v_proj(h, prec)
            x = x + a.out_proj(attention(q, k, v, self.heads, (d // self.heads) ** -0.5, prec,
                                         mask=mask), prec)
            h = layer.mlp.fc1(layer_norm(x, layer.layer_norm2, eps), prec)
            x = x + layer.mlp.fc2(h * torch.sigmoid(1.702 * h), prec)
        return layer_norm(x, tm.final_layer_norm, eps)


# --------------------------------------------------------------------------- #
# the tokenizer
# --------------------------------------------------------------------------- #


@functools.lru_cache(maxsize=None)
def bytes_to_unicode() -> Dict[int, str]:
    """Each byte value -> a printable character (GPT-2's table)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _category_class(prefix: str) -> str:
    """A character-class body of every code point whose Unicode category starts with `prefix`."""
    out, start = [], None
    for cp in range(0x110000 + 1):
        inside = cp < 0x110000 and unicodedata.category(chr(cp)).startswith(prefix)
        if inside and start is None:
            start = cp
        elif not inside and start is not None:
            lo, hi = re.escape(chr(start)), re.escape(chr(cp - 1))
            out.append(lo if start == cp - 1 else f"{lo}-{hi}")
            start = None
    return "".join(out)


@functools.lru_cache(maxsize=None)
def _pattern() -> "re.Pattern":
    letters, numbers = _category_class("L"), _category_class("N")
    return re.compile(
        rf"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        rf"|[{letters}]+|[{numbers}]|[^\s{letters}{numbers}]+", re.IGNORECASE)


def _cjk(cp: int) -> bool:
    return any(lo <= cp <= hi for lo, hi in (
        (0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
        (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F)))


def basic_clean(text: str) -> str:
    chars = []
    for ch in text:
        cp = ord(ch)
        cat = unicodedata.category(ch)
        if cp in (0, 0xFFFD) or (ch not in "\t\n\r" and cat.startswith("C")):
            continue
        if ch in " \t\n\r" or cat == "Zs":
            chars.append(" ")
        elif _cjk(cp):
            chars.extend((" ", ch, " "))
        else:
            chars.append(ch)
    text = unicodedata.normalize("NFC", "".join(chars))
    return " ".join(w.lower() for w in text.split())


class Tokenizer:
    """Reads `vocab.json` and `merges.txt` from `directory`."""

    def __init__(self, directory: Path):
        directory = Path(directory)
        self.encoder = json.loads((directory / "vocab.json").read_text("utf-8"))
        merges = (directory / "merges.txt").read_text("utf-8").strip().split("\n")[1:N_MERGES + 1]
        self.ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.bos, self.eos = self.encoder[BOS], self.encoder[EOS]

    def _bpe(self, token: str) -> List[str]:
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word, word[1:]))
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        return list(word)

    def ids(self, text: str) -> List[int]:
        out = []
        for token in _pattern().findall(basic_clean(text)):
            if token in (BOS, EOS):
                pieces = [token]
            else:
                pieces = self._bpe("".join(self.byte_encoder[b] for b in token.encode("utf-8")))
            out.extend(self.encoder.get(p, self.eos) for p in pieces)
        return out

    def __call__(self, prompts: Sequence[str], max_length: int = 77) -> torch.Tensor:
        rows = []
        for text in prompts:
            row = [self.bos] + self.ids(text)[:max_length - 2] + [self.eos]
            rows.append(row + [self.eos] * (max_length - len(row)))
        return torch.tensor(rows, dtype=torch.int64)

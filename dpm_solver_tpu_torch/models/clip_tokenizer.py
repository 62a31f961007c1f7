"""CLIP's byte-level BPE tokenizer, read from a local HF-format directory.

The port's own copy of transformers' `CLIPTokenizer` (tokenization_clip.py)
as that class runs without `ftfy`: the text goes through BERT's basic
cleaning (control characters dropped, whitespace collapsed, CJK characters
spaced, NFC, lower case, accents kept, no punctuation split), is split by
CLIP's pattern `<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|
[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+` (case-insensitive), and each piece,
mapped byte by byte to printable characters, is merged by the ranks of
`merges.txt` and looked up in `vocab.json`; unknown pieces take the id of
<|endoftext|>. Python's `re` has no \\p{L} or \\p{N}, so the two classes are
built once from `unicodedata` (every code point of category L*, N*).
`__call__` gives what `tokenizer(prompts, truncation=True, max_length=77,
padding="max_length")` gives there: <|startoftext|>, at most max_length - 2
pieces, <|endoftext|>, padded with <|endoftext|>.
"""

from __future__ import annotations

import functools
import json
import re
import unicodedata
from pathlib import Path
from typing import Dict, List, Sequence, Tuple, Union

import torch

BOS, EOS = "<|startoftext|>", "<|endoftext|>"
# merges.txt's first line is a version header; CLIP keeps the next 48,894
# (49,152 - 256 - 2) merges, as transformers' CLIPTokenizer does
N_MERGES = 49152 - 256 - 2


@functools.lru_cache(maxsize=None)
def bytes_to_unicode() -> Dict[int, str]:
    """Each of the 256 byte values -> a printable character (GPT-2's table)."""
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


def _ranges(prefix: str) -> str:
    """A regex character-class body of every code point whose Unicode
    category starts with `prefix`."""
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
    letters, numbers = _ranges("L"), _ranges("N")
    return re.compile(
        rf"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        rf"|[{letters}]+|[{numbers}]|[^\s{letters}{numbers}]+", re.IGNORECASE)


def _is_control(ch: str) -> bool:
    return ch not in "\t\n\r" and unicodedata.category(ch).startswith("C")


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def basic_clean(text: str) -> str:
    """BERT's BasicTokenizer as CLIPTokenizer runs it without ftfy
    (strip_accents=False, do_split_on_punc=False), its pieces joined by spaces."""
    chars = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_whitespace(ch):
            chars.append(" ")
        elif _is_cjk(cp):
            chars.extend((" ", ch, " "))
        else:
            chars.append(ch)
    text = unicodedata.normalize("NFC", "".join(chars))
    return " ".join(token.lower() for token in text.split())


def local_directory(version: Union[str, Path]) -> Path:
    """`version` as a local directory; a hub name or a missing path raises:
    nothing is downloaded."""
    directory = Path(version)
    if not directory.is_dir():
        raise FileNotFoundError(
            f"CLIP loads from a local HF-format directory (config.json, pytorch_model.bin, "
            f"vocab.json, merges.txt); {str(version)!r} is not one (no hub names: nothing is "
            f"downloaded)")
    return directory


class CLIPTokenizer:
    """`CLIPTokenizer(directory)` reads `vocab.json` and `merges.txt` there."""

    def __init__(self, directory: Union[str, Path]):
        directory = local_directory(directory)
        self.encoder: Dict[str, int] = json.loads((directory / "vocab.json").read_text("utf-8"))
        merges = (directory / "merges.txt").read_text("utf-8").strip().split("\n")[1:N_MERGES + 1]
        self.bpe_ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.cache = {BOS: BOS, EOS: EOS}
        self.bos_id, self.eos_id = self.encoder[BOS], self.encoder[EOS]

    def bpe(self, token: str) -> List[str]:
        if token in self.cache:
            return self.cache[token].split(" ")
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word, word[1:]))
            first, second = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if (first, second) not in self.bpe_ranks:
                break
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        self.cache[token] = " ".join(word)
        return list(word)

    def tokenize(self, text: str) -> List[str]:
        pieces = []
        for token in _pattern().findall(basic_clean(text)):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            pieces.extend(self.bpe(token))
        return pieces

    def encode(self, text: str) -> List[int]:
        """The ids of `text`'s pieces, without the special tokens."""
        return [self.encoder.get(p, self.eos_id) for p in self.tokenize(text)]

    def __call__(self, prompts: Union[str, Sequence[str]], max_length: int = 77) -> torch.Tensor:
        """(B, max_length) int64 ids: <|startoftext|>, the first max_length - 2
        pieces, <|endoftext|>, then <|endoftext|> as padding."""
        if isinstance(prompts, str):
            prompts = [prompts]
        rows = []
        for text in prompts:
            ids = [self.bos_id] + self.encode(text)[:max_length - 2] + [self.eos_id]
            rows.append(ids + [self.eos_id] * (max_length - len(ids)))
        return torch.tensor(rows, dtype=torch.int64)


SYNTHETIC_WORDS = ("a", "photograph", "photo", "of", "an", "astronaut", "riding", "horse",
                   "the", "red", "teapot", "on", "table", "cat", "dog", "painting", "castle")


def write_synthetic_vocab(directory: Union[str, Path], n_merges: int = N_MERGES) -> Path:
    """Write a `vocab.json` and `merges.txt` of CLIP's layout to `directory`:
    the 256 byte characters and their end-of-word forms, `n_merges` merges
    (first those that spell SYNTHETIC_WORDS left to right, then pairs of
    byte characters in order), then <|startoftext|> and <|endoftext|>. At
    the default count the vocabulary has CLIP's 49,408 entries. A stand-in
    for runs on random weights: no pretrained vocabulary is in the repo."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    base = list(bytes_to_unicode().values())
    ends = [c + "</w>" for c in base]
    vocab, merges, seen = base + ends, [], set(base + ends)

    def add(a: str, b: str) -> None:
        if a + b not in seen and len(merges) < n_merges:
            merges.append((a, b))
            seen.add(a + b)
            vocab.append(a + b)

    for word in SYNTHETIC_WORDS:
        sym = word[0]
        for i, ch in enumerate(word[1:], 1):
            nxt = ch + "</w>" if i == len(word) - 1 else ch
            add(sym, nxt)
            sym += nxt
    for a in base:
        for b in base + ends:
            if len(merges) == n_merges:
                break
            add(a, b)
    vocab += [BOS, EOS]
    (directory / "vocab.json").write_text(json.dumps({t: i for i, t in enumerate(vocab)}),
                                          "utf-8")
    (directory / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n", "utf-8")
    return directory

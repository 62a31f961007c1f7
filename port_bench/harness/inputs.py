"""Inputs made from the seed: prompts, and the tokenizer's vocabulary files.

A prompt is `prompt_words` = [lo, hi] words (the count uniform in that
range) drawn with replacement from the traffic's word list; request i's
prompts come from the generator seeded with (seed, i), so two runs of one
seed send the same prompts, and every seed the same amount of work (the
text tower always reads 77 positions).

The vocabulary is synthetic, of CLIP's layout and size: the 256 byte
characters and their end-of-word forms, 48,894 merges (first those that
spell the traffic's words left to right, then pairs of byte characters in
order), then <|startoftext|> and <|endoftext|>: 49,408 entries. It is
written once to a fixed directory under the temporary directory and read
by both the program's tokenizer and the reference's.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import tempfile
from pathlib import Path
from typing import List, Sequence

from port_bench.harness.weights import seed_value

N_MERGES = 49152 - 256 - 2


def read_words(path: Path) -> List[str]:
    return [w for w in Path(path).read_text("utf-8").split() if w]


def prompts(words: Sequence[str], lo_hi, n: int, seed: int, i: int) -> List[str]:
    rng = random.Random(seed_value(seed, i, 2))
    lo, hi = lo_hi
    return [" ".join(rng.choice(words) for _ in range(rng.randint(lo, hi))) for _ in range(n)]


def _byte_chars() -> List[str]:
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs, n = bs[:], 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return [chr(c) for c in cs]


def vocabulary(words: Sequence[str]) -> tuple:
    """(vocab.json's dict, merges.txt's text)."""
    base = _byte_chars()
    ends = [c + "</w>" for c in base]
    vocab, merges, seen = base + ends, [], set(base + ends)

    def add(a: str, b: str) -> None:
        if a + b not in seen and len(merges) < N_MERGES:
            merges.append((a, b))
            seen.add(a + b)
            vocab.append(a + b)

    for word in sorted(set(words)):
        sym = word[0]
        for k, ch in enumerate(word[1:], 1):
            nxt = ch + "</w>" if k == len(word) - 1 else ch
            add(sym, nxt)
            sym += nxt
    for a in base:
        for b in base + ends:
            if len(merges) == N_MERGES:
                break
            add(a, b)
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    text = "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n"
    return {t: k for k, t in enumerate(vocab)}, text


def vocab_dir(words: Sequence[str]) -> Path:
    """The directory holding vocab.json and merges.txt for `words`, written
    at its first use (a fixed path under the temporary directory)."""
    vocab, merges = vocabulary(words)
    body = json.dumps(vocab)
    tag = hashlib.sha256((body + merges).encode("utf-8")).hexdigest()[:16]
    d = Path(tempfile.gettempdir()) / f"port_bench_vocab_{tag}"
    if not (d / "merges.txt").is_file():
        d.mkdir(parents=True, exist_ok=True)
        for name, text in (("vocab.json", body), ("merges.txt", merges)):
            part = d / f"{name}.{os.getpid()}"
            part.write_text(text, "utf-8")
            os.replace(part, d / name)
    return d

"""Offline lyrics tokenizer: (artist, song, lyrics) CSV -> word tokens.

Port of ``fewshot/data/lyrics.py``: the pure-Python tokenizer, the corpus
passes (``count_corpus``, ``encode_corpus``, ``tokenize_corpus``) and
``detokenize`` for readable samples.  The corpus passes run through the
native library (``data/native.py``, byte for byte the same) unless the
caller passes ``native=False``; where the library cannot be built they
raise, as ``data/native.py`` says, rather than fall back.
"""

from __future__ import annotations

import csv
import re
from collections import Counter
from pathlib import Path

from fewshot_torch.data.vocab import Vocab

# Lowercase words (with internal apostrophes) or one punctuation mark.
_TOKEN_RE = re.compile(r"[a-z0-9]+(?:'[a-z]+)?|[^\sa-z0-9]")


def tokenize_line(text: str) -> list[str]:
    return _TOKEN_RE.findall(text.lower())


def read_lyrics_csv(path: str | Path) -> list[tuple[str, str, str]]:
    """Read (artist, song, lyrics) rows.  Header row optional."""
    rows: list[tuple[str, str, str]] = []
    with open(path, newline="", encoding="utf-8") as f:
        for row in csv.reader(f):
            if len(row) < 3:
                continue
            artist, song, lyric = row[0], row[1], ",".join(row[2:])
            if (artist.strip().lower(), song.strip().lower()) == \
                    ("artist", "song"):
                continue  # header
            rows.append((artist.strip(), song.strip(), lyric))
    return rows


def count_corpus(rows: list[tuple[str, str, str]],
                 native: bool = True) -> Counter:
    """Token counts over rows (one pass; no encoded output)."""
    if native:
        from fewshot_torch.data import native as native_mod
        return native_mod.count_corpus(rows)
    counter: Counter = Counter()
    for _, _, text in rows:
        counter.update(tokenize_line(text))
    return counter


def encode_corpus(rows: list[tuple[str, str, str]], vocab: Vocab,
                  native: bool = True) -> list:
    """Encode rows against a fixed vocab: [(artist, song, ids)] (int32
    arrays from the native pass, lists of ints from Python's)."""
    if native:
        from fewshot_torch.data import native as native_mod
        return native_mod.encode_corpus(rows, vocab)
    return [(a, s, vocab.encode(tokenize_line(t))) for a, s, t in rows]


def tokenize_corpus(rows: list[tuple[str, str, str]], vocab_size: int,
                    native: bool = True
                    ) -> tuple[Vocab, list[tuple[str, str, list[int]]]]:
    """Tokenize all songs, build the top-N vocab, encode to int ids.

    Returns (vocab, [(artist, song, ids)]); ids exclude BOS/EOS, which the
    packer adds.  native=False is the pure-Python path."""
    if native:
        from fewshot_torch.data import native as native_mod
        return native_mod.tokenize_corpus(rows, vocab_size)
    tokenized = [(a, s, tokenize_line(t)) for a, s, t in rows]
    counter: Counter = Counter()
    for _, _, toks in tokenized:
        counter.update(toks)
    vocab = Vocab.build(counter, vocab_size)
    return vocab, [(a, s, vocab.encode(t)) for a, s, t in tokenized]


def detokenize(tokens: list[str]) -> str:
    """Best-effort inverse of tokenize_line for human-readable samples."""
    out: list[str] = []
    for t in tokens:
        if out and re.fullmatch(r"[^\w']+", t):
            out[-1] += t
        else:
            out.append(t)
    return " ".join(out)

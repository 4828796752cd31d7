"""Offline lyrics tokenizer: (artist, song, lyrics) CSV -> word tokens.

Port of ``fewshot/data/lyrics.py`` without its native-library branch: the
pure-Python tokenizer, which the native one matches byte for byte, and
``detokenize`` for readable samples.
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


def tokenize_corpus(rows: list[tuple[str, str, str]], vocab_size: int
                    ) -> tuple[Vocab, list[tuple[str, str, list[int]]]]:
    """Tokenize all songs, build the top-N vocab, encode to int ids.

    Returns (vocab, [(artist, song, ids)]); ids exclude BOS/EOS, which the
    packer adds."""
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

"""ctypes bindings for the native offline-data library (csrc/fastdata.cpp).

Port of ``fewshot/data/native.py``.  The pure-Python paths in
``data/lyrics.py`` and ``data/midi.py`` are the reference semantics; these
bindings are the same passes in C++, byte for byte, for the corpus cold
start (tokenize, count, encode, SMF parse).

The library is built at first use by ``g++ -O3 -shared -fPIC`` into
``.torch_ext/`` at the repository root, named by a hash of its source and
flags (``ops/_ext.build``, the helper the CUDA libraries use), and loaded
with ``ctypes``.  Nothing is built at import.  Unlike the JAX module, which
falls back to Python silently where its library is missing, a failed build
raises with the compiler's message, and so does a capacity overflow: a
caller asks for the Python path by name (``native=False``).
"""

from __future__ import annotations

import ctypes
import re
import threading
from collections import Counter
from pathlib import Path

import numpy as np

from fewshot_torch.ops import _ext

CSRC = Path(__file__).resolve().parent / "csrc"
COMPILER = "g++"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-Wall", "-Wextra")

_P32 = ctypes.POINTER(ctypes.c_int32)
_SIGNATURES = {
    "fd_tokenize": [ctypes.c_char_p, ctypes.c_int32, ctypes.c_char_p, _P32,
                    _P32, ctypes.c_int32],
    "fd_parse_smf": [ctypes.c_char_p, ctypes.c_int32,
                     ctypes.POINTER(ctypes.c_double),
                     ctypes.POINTER(ctypes.c_double), _P32, _P32,
                     ctypes.c_int32],
    "fd_count_corpus": [ctypes.c_char_p, ctypes.c_int32, ctypes.c_char_p,
                        _P32, _P32, ctypes.c_int32, ctypes.c_char_p,
                        ctypes.c_int32, _P32,
                        ctypes.POINTER(ctypes.c_int64), ctypes.c_int32],
    "fd_encode_corpus": [ctypes.c_char_p, ctypes.c_int32, ctypes.c_char_p,
                         _P32, _P32, ctypes.c_int32, ctypes.c_char_p, _P32,
                         ctypes.c_int32, ctypes.c_int32, _P32,
                         ctypes.c_int64, _P32],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def load() -> ctypes.CDLL:
    """The loaded library, built on first use (raises if g++ fails)."""
    global _lib
    with _lock:
        if _lib is None:
            path = _ext.build("fastdata", CSRC, COMPILER, FLAGS, ".cpp")
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in _SIGNATURES.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _lib = lib
    return _lib


def _i32(arr: np.ndarray):
    return arr.ctypes.data_as(_P32)


_WS = re.compile(r"\s")
# the ASCII characters that Python's \s takes and the C side does not
_ASCII_ONLY_PY_SPACE = re.compile("[\x1c-\x1f]")


def _normalize(text: str) -> str:
    r"""Fold Unicode before the C call: Python's str.lower() folds
    non-ASCII case (the C side only ASCII), and Python's \s takes Unicode
    whitespace such as U+00A0 (the C side only ASCII spaces).  Both are
    needed for the byte-exact match with the Python path."""
    return _WS.sub(" ", text.lower())


def _encode(text: str) -> bytes:
    """UTF-8 bytes for the C side: ASCII text without \x1c-\x1f needs no
    folding (the C side lowers ASCII case and skips ASCII spaces itself),
    which skips the regex pass, most of a corpus pass's time."""
    if text.isascii() and not _ASCII_ONLY_PY_SPACE.search(text):
        return text.encode("ascii")
    return _normalize(text).encode("utf-8")


def _rows_blob(rows):
    """Normalized UTF-8 blob + [start, end) byte offsets per row."""
    texts = [_encode(t) for _, _, t in rows]
    ends = np.cumsum([len(t) for t in texts], dtype=np.int64)
    starts = np.concatenate([[0], ends[:-1]]) if len(texts) else ends
    return (b"".join(texts), np.ascontiguousarray(starts, np.int32),
            np.ascontiguousarray(ends, np.int32))


def count_corpus(rows, blob=None) -> Counter:
    """Token counts over (artist, song, text) rows, one native pass
    (`blob`: ``_rows_blob(rows)`` where the caller has it already)."""
    lib = load()
    blob, row_starts, row_ends = blob or _rows_blob(rows)
    n = len(blob)
    lowered = ctypes.create_string_buffer(max(1, n))
    tok_buf = ctypes.create_string_buffer(max(1, n + 16))
    for cap in (max(1024, n // 2 + 16), n + 16):
        tok_offsets = np.zeros(cap + 1, np.int32)
        counts = np.zeros(cap, np.int64)
        n_unique = lib.fd_count_corpus(
            blob, n, lowered, _i32(row_starts), _i32(row_ends), len(rows),
            tok_buf, n + 16, _i32(tok_offsets),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap)
        if n_unique >= 0:
            raw = tok_buf.raw
            return Counter({
                raw[tok_offsets[i]:tok_offsets[i + 1]].decode(
                    "utf-8", errors="replace"): int(counts[i])
                for i in range(n_unique)})
    raise RuntimeError("fd_count_corpus: capacity exceeded")


def encode_corpus(rows, vocab, blob=None) -> list:
    """(artist, song, int32 ids) per row against a fixed vocab, one native
    pass; the ids are views of one array."""
    from fewshot_torch.data.vocab import UNK
    lib = load()
    blob, row_starts, row_ends = blob or _rows_blob(rows)
    n = len(blob)
    lowered = ctypes.create_string_buffer(max(1, n))
    vtoks = [t.encode("utf-8") for t in vocab.tokens]
    vocab_offsets = np.zeros(len(vtoks) + 1, np.int32)
    vocab_offsets[1:] = np.cumsum([len(t) for t in vtoks])
    total_cap = n + 16        # every token is >= 1 byte
    out_ids = np.zeros(total_cap, np.int32)
    row_counts = np.zeros(len(rows), np.int32)
    total = lib.fd_encode_corpus(
        blob, n, lowered, _i32(row_starts), _i32(row_ends), len(rows),
        b"".join(vtoks), _i32(vocab_offsets), len(vtoks), UNK,
        _i32(out_ids), total_cap, _i32(row_counts))
    if total < 0:
        raise RuntimeError("fd_encode_corpus: capacity exceeded")
    items = []
    pos = 0
    for (artist, song, _), cnt in zip(rows, row_counts):
        items.append((artist, song, out_ids[pos:pos + cnt]))
        pos += cnt
    return items


def tokenize_corpus(rows, vocab_size: int):
    """count -> top-N vocab -> encode, natively: the same vocab and ids as
    ``lyrics.tokenize_corpus(rows, vocab_size, native=False)``."""
    from fewshot_torch.data.vocab import Vocab
    blob = _rows_blob(rows)
    vocab = Vocab.build(count_corpus(rows, blob), vocab_size)
    return vocab, [(a, s, ids.tolist())
                   for a, s, ids in encode_corpus(rows, vocab, blob)]


def tokenize_line(text: str) -> list[str]:
    """``lyrics.tokenize_line`` through the library (byte-exact)."""
    lib = load()
    raw = _encode(text)
    n = len(raw)
    cap = max(16, n + 1)
    lowered = ctypes.create_string_buffer(cap)
    starts = (ctypes.c_int32 * cap)()
    ends = (ctypes.c_int32 * cap)()
    count = lib.fd_tokenize(raw, n, lowered, starts, ends, cap)
    if count < 0:
        raise RuntimeError("fd_tokenize: token buffer overflow")
    low = lowered.raw[:n]
    return [low[starts[i]:ends[i]].decode("utf-8", errors="replace")
            for i in range(count)]


def parse_midi(path) -> list:
    """``midi.parse_midi`` through the library (the same Note list)."""
    from fewshot_torch.data.midi import Note
    lib = load()
    data = Path(path).read_bytes()
    cap = max(64, len(data))        # a note needs >= 6 bytes of events
    starts = np.zeros(cap, np.float64)
    ends = np.zeros(cap, np.float64)
    pitches = np.zeros(cap, np.int32)
    vels = np.zeros(cap, np.int32)
    n = lib.fd_parse_smf(
        data, len(data),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ends.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        _i32(pitches), _i32(vels), cap)
    if n == -3:
        raise ValueError(f"{path}: SMPTE time division unsupported")
    if n < 0:
        raise ValueError(f"{path}: malformed SMF (code {n})")
    return [Note(float(starts[i]), float(ends[i]), int(pitches[i]),
                 int(vels[i])) for i in range(n)]

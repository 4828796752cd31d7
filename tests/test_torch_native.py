"""The port's native data tier against fewshot.data.native and the Python
paths.

``fewshot_torch/data/native.py`` builds its own copy of the C++ source
(``fewshot_torch/data/csrc/fastdata.cpp``) with g++ at first use.  Checked,
byte for byte (token strings, vocab order, ids; SMF notes to 1e-9 s, the
JAX tests' bound, as a double from either parser):

* the tokenizer on ASCII, punctuation, apostrophes, Unicode case and
  Unicode whitespace, against ``fewshot.data.native.tokenize_line`` and
  the port's Python ``lyrics.tokenize_line``;
* the count and encode passes over a synthetic lyrics corpus, against
  JAX's native passes and the Python passes (``native=False``);
* the SMF parser on synthetic ``.mid`` files, a mid-stream tempo change and
  two channels sharing a pitch, against JAX's native parser and the port's
  Python parser; garbage raises ValueError;
* the packed corpus files (``corpus.npz``, ``vocab.json``) of a lyrics and
  a MIDI corpus are the same bytes with ``native`` on and off;
* a source that does not compile raises with g++'s message, and the
  corpus passes raise with it rather than fall back to Python.
"""

import struct

import pytest

import fewshot.data.native as jax_native
from fewshot_torch.data import lyrics, midi, native
from fewshot_torch.data.corpus import build_lyrics_corpus, build_midi_corpus
from fewshot_torch.data.synthetic import (generate_lyrics_csv,
                                          generate_midi_corpus)
from fewshot_torch.ops import _ext

TEXTS = [
    "Don't stop! 99 red balloons",
    "  multiple   spaces\tand\nnewlines ",
    "UPPER lower MiXeD",
    "hyphen-ated and semi;colons, quotes 'round words'",
    "",
    "unicode café — naïve…",
    "a'b'c can't won't 'tis o'clock'",
    "!!!???...",
    "CAFÉ Déjà VU İstanbul Ärger ß",
    "non\u00a0breaking em\u2003space ideographic\u3000space",
    "ascii\x1cfile\x1dgroup\x1erecord\x1funit separators\x0bvt\x0cff",
]


@pytest.fixture(scope="module")
def jax_lib():
    if not jax_native.available():
        pytest.fail("fewshot.data.native did not build its library")
    return jax_native


@pytest.mark.parametrize("i", range(len(TEXTS)))
def test_tokenizer_matches(jax_lib, i):
    text = TEXTS[i]
    got = native.tokenize_line(text)
    assert got == lyrics.tokenize_line(text)
    assert got == jax_lib.tokenize_line(text)


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    d = tmp_path_factory.mktemp("lyrics")
    generate_lyrics_csv(d / "l.csv", 5, 4, 2)
    out = lyrics.read_lyrics_csv(d / "l.csv")
    out += [("odd", f"u{i}", t) for i, t in enumerate(TEXTS)]
    return out


def test_corpus_passes_match(jax_lib, rows):
    counts = lyrics.count_corpus(rows)
    assert counts == lyrics.count_corpus(rows, native=False)
    assert counts == jax_lib.count_corpus(rows)
    vocab, items = lyrics.tokenize_corpus(rows, 80)
    vocab_py, items_py = lyrics.tokenize_corpus(rows, 80, native=False)
    vocab_jax, items_jax = jax_lib.tokenize_corpus(rows, 80)
    assert vocab.tokens == vocab_py.tokens == vocab_jax.tokens
    assert items == items_py == items_jax
    enc = lyrics.encode_corpus(rows, vocab)
    enc_py = lyrics.encode_corpus(rows, vocab, native=False)
    assert [(a, s, ids.tolist()) for a, s, ids in enc] == enc_py


def _same_notes(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.pitch, a.velocity) == (b.pitch, b.velocity)
        assert abs(a.start - b.start) < 1e-9 and abs(a.end - b.end) < 1e-9


def _smf(tmp_path, name, events):
    body = bytearray()
    for delta, ev in events:
        body += midi._varlen(delta) + bytes(ev)
    body += midi._varlen(0) + bytes([0xFF, 0x2F, 0x00])
    p = tmp_path / name
    p.write_bytes(b"MThd" + struct.pack(">IHHH", 6, 0, 1, 480) + b"MTrk"
                  + struct.pack(">I", len(body)) + bytes(body))
    return p


def test_smf_parser_matches(jax_lib, tmp_path):
    generate_midi_corpus(tmp_path / "raw", 3, 3, 1)
    files = sorted((tmp_path / "raw").rglob("*.mid"))
    files.append(_smf(tmp_path, "tempo.mid", [
        (0, [0x90, 60, 90]),
        (240, [0xFF, 0x51, 0x03, *(250000).to_bytes(3, "big")]),
        (240, [0x80, 60, 0])]))
    files.append(_smf(tmp_path, "channels.mid", [
        (0, [0x90, 60, 100]), (240, [0x91, 60, 80]), (240, [0x81, 60, 0]),
        (480, [0x80, 60, 0])]))
    assert len(files) == 11
    for f in files:
        got = native.parse_midi(f)
        assert got, f
        _same_notes(got, midi.parse_midi(f))
        _same_notes(got, jax_lib.parse_midi(f))
    bad = tmp_path / "bad.mid"
    bad.write_bytes(b"not a midi file at all")
    with pytest.raises(ValueError):
        native.parse_midi(bad)


def test_packed_files_identical(tmp_path):
    generate_lyrics_csv(tmp_path / "l.csv", 6, 5, 3)
    generate_midi_corpus(tmp_path / "raw", 3, 4, 4)
    for on in (True, False):
        build_lyrics_corpus(tmp_path / "l.csv", tmp_path / f"lyr{on}", 200,
                            64, seed=1, native=on)
        build_midi_corpus(tmp_path / "raw", tmp_path / f"mid{on}", 0,
                          seed=1, native=on)
    for kind in ("lyr", "mid"):
        for name in ("corpus.npz", "vocab.json", "meta.json"):
            a = (tmp_path / f"{kind}True" / name).read_bytes()
            b = (tmp_path / f"{kind}False" / name).read_bytes()
            assert a == b, (kind, name)


def test_failed_build_raises(tmp_path, monkeypatch, rows):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "fastdata.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "CSRC", csrc)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(_ext, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on fastdata.cpp"):
        native.load()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        lyrics.tokenize_corpus(rows, 80)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        lyrics.count_corpus(rows)
    assert lyrics.tokenize_corpus(rows, 80, native=False)[0] is not None
    assert not (tmp_path / "build").exists() or not any(
        (tmp_path / "build").glob("*.so"))

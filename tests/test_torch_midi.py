"""The port's MIDI tier (fewshot_torch/data/midi.py, the MIDI half of
data/synthetic.py, corpus.build_midi_corpus) against fewshot's.

* ``write_midi`` writes the JAX package's bytes for the same notes;
* ``parse_midi`` reads what either package wrote, and a hand-made SMF with
  running status, a tempo change, sysex, two tracks and two channels, as
  fewshot's reader does; a write / parse round trip keeps the notes on the
  1/16 s grid;
* ``notes_to_events`` and ``events_to_notes`` give fewshot's output, on
  garbage event streams too; ``grammar_masks`` is fewshot's array;
* ``generate_midi_corpus`` writes byte-identical files for one seed, and
  ``build_midi_corpus`` packs the same arrays, vocab and splits (plain and
  with BPE merges), each package loading the other's corpus;
* ``cli prepare --synthetic`` packs the corpus ``scripts/prepare_data.py``
  packs (lyrics and MIDI, with and without BPE) and prints its line.

Everything here is exact: bytes, token strings and integer arrays.  Note
times compare within 1e-9 s (the same float arithmetic on both sides).
"""

import struct
import sys
from pathlib import Path

import numpy as np
import pytest

from fewshot.data import corpus as jcorpus
from fewshot.data import midi as jmidi
from fewshot.data import synthetic as jsynthetic
from fewshot.data.vocab import SPECIALS as JSPECIALS, Vocab as JVocab
from fewshot_torch.data import corpus as tcorpus
from fewshot_torch.data import midi as tmidi
from fewshot_torch.data import synthetic as tsynthetic
from fewshot_torch import cli
from fewshot_torch.data.vocab import SPECIALS, Vocab

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
import prepare_data                              # noqa: E402

ARRAYS = ("songs", "song_len", "song_artist", "artist_song_ids",
          "artist_num_songs")


def _notes(mod, seed, n=40):
    rng = np.random.RandomState(seed)
    notes, t = [], 0.0
    for _ in range(n):
        t += float(rng.choice([0.0, 0.0625, 0.13, 0.25, 1.7]))
        dur = float(rng.choice([0.01, 0.0625, 0.3, 0.5, 3.0]))
        notes.append(mod.Note(start=t, end=t + dur,
                              pitch=int(rng.randint(0, 128)),
                              velocity=int(rng.randint(-5, 140))))
    return notes


def _same_notes(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.pitch, x.velocity) == (y.pitch, y.velocity)
        assert abs(x.start - y.start) <= 1e-9 and abs(x.end - y.end) <= 1e-9


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_write_midi_bytes_equal_jax(tmp_path, seed):
    tmidi.write_midi(_notes(tmidi, seed), tmp_path / "t.mid")
    jmidi.write_midi(_notes(jmidi, seed), tmp_path / "j.mid")
    assert (tmp_path / "t.mid").read_bytes() == \
        (tmp_path / "j.mid").read_bytes()
    tmidi.write_midi([], tmp_path / "te.mid")
    jmidi.write_midi([], tmp_path / "je.mid")
    assert (tmp_path / "te.mid").read_bytes() == \
        (tmp_path / "je.mid").read_bytes()


def test_parse_write_round_trip(tmp_path):
    """Notes on the 1/16 s grid with durations of at least one step come
    back as written (velocities clamped to 1..127)."""
    rng = np.random.RandomState(3)
    notes, t = [], 0.0
    for _ in range(30):
        t += tmidi.TIME_GRID * int(rng.randint(0, 6))
        notes.append(tmidi.Note(t, t + tmidi.TIME_GRID * int(rng.randint(
            1, 20)), int(rng.randint(0, 128)), int(rng.randint(1, 128))))
    tmidi.write_midi(notes, tmp_path / "r.mid")
    back = tmidi.parse_midi(tmp_path / "r.mid")
    _same_notes(back, sorted(notes, key=lambda n: (n.start, n.pitch)))
    assert tmidi.notes_to_events(back) == tmidi.notes_to_events(notes)


def _vlq(v):
    out = [v & 0x7F]
    v >>= 7
    while v:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    return bytes(reversed(out))


def _handmade(path):
    """Format 1, two tracks: a tempo map (with a mid-song change and a
    sysex), and notes on two channels with running status, note-on
    velocity 0 as note-off, a control change and a program change."""
    t1 = (_vlq(0) + b"\xff\x51\x03" + (600000).to_bytes(3, "big")
          + _vlq(10) + b"\xf0\x03\x01\x02\xf7"
          + _vlq(470) + b"\xff\x51\x03" + (300000).to_bytes(3, "big")
          + _vlq(0) + b"\xff\x2f\x00")
    t2 = (_vlq(0) + b"\x90\x3c\x40" + _vlq(0) + b"\x3e\x50"   # running
          + _vlq(0) + b"\x91\x3c\x30"                       # channel 2
          + _vlq(240) + b"\x80\x3c\x00" + _vlq(0) + b"\xb0\x07\x64"
          + _vlq(0) + b"\xc0\x05" + _vlq(240) + b"\x90\x3e\x00"
          + _vlq(480) + b"\x81\x3c\x00" + _vlq(0) + b"\x90\x40\x7f"
          + _vlq(960) + b"\x40\x00" + _vlq(0) + b"\xff\x2f\x00")
    data = (b"MThd" + struct.pack(">IHHH", 6, 1, 2, 480)
            + b"MTrk" + struct.pack(">I", len(t1)) + t1
            + b"MTrk" + struct.pack(">I", len(t2)) + t2)
    path.write_bytes(data)
    return path


def test_parse_matches_jax_on_handmade_and_written_files(tmp_path):
    f = _handmade(tmp_path / "h.mid")
    got, want = tmidi.parse_midi(f), jmidi.parse_midi(f)
    assert len(got) == 4
    _same_notes(got, want)
    jmidi.write_midi(_notes(jmidi, 4), tmp_path / "j.mid")
    _same_notes(tmidi.parse_midi(tmp_path / "j.mid"),
                jmidi.parse_midi(tmp_path / "j.mid"))
    (tmp_path / "bad.mid").write_bytes(b"RIFF....")
    with pytest.raises(ValueError, match="not a Standard MIDI File"):
        tmidi.parse_midi(tmp_path / "bad.mid")


@pytest.mark.parametrize("seed", [0, 5])
def test_events_match_jax(seed):
    t_notes, j_notes = _notes(tmidi, seed), _notes(jmidi, seed)
    events = tmidi.notes_to_events(t_notes)
    assert events == jmidi.notes_to_events(j_notes)
    assert len(events) == 4 * len(t_notes)
    _same_notes(tmidi.events_to_notes(events), jmidi.events_to_notes(events))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_events_to_notes_matches_jax_on_garbage(seed):
    """Model output that breaks the grammar: both packages keep the same
    complete SHIFT/PITCH/DUR/VEL groups."""
    vocab = tmidi.full_event_vocab() + ["<unk>", "w_x"]
    rng = np.random.RandomState(seed)
    events = list(rng.choice(vocab, size=200))
    good = tmidi.notes_to_events(_notes(tmidi, seed, 6))
    events[50:50] = good                        # a clean run inside
    got, want = tmidi.events_to_notes(events), jmidi.events_to_notes(events)
    assert len(got) >= 6
    _same_notes(got, want)


def test_grammar_masks_match_jax():
    t_vocab = Vocab(SPECIALS + tmidi.full_event_vocab())
    j_vocab = JVocab(JSPECIALS + jmidi.full_event_vocab())
    assert tmidi.full_event_vocab() == jmidi.full_event_vocab()
    got, want = tmidi.grammar_masks(t_vocab), jmidi.grammar_masks(j_vocab)
    assert got.dtype == want.dtype and got.shape == (4, 204)
    np.testing.assert_array_equal(got, want)
    # merged (BPE) tokens belong to no phase, as in JAX
    t_big = Vocab(t_vocab.tokens + ["SHIFT_1+PITCH_60"])
    j_big = JVocab(j_vocab.tokens + ["SHIFT_1+PITCH_60"])
    np.testing.assert_array_equal(tmidi.grammar_masks(t_big),
                                  jmidi.grammar_masks(j_big))


@pytest.mark.parametrize("notes_range", [(24, 48), (60, 100)])
def test_generate_midi_corpus_bytes_identical(tmp_path, notes_range):
    kw = dict(num_artists=4, songs_per_artist=3, seed=2,
              notes_range=notes_range)
    tsynthetic.generate_midi_corpus(tmp_path / "t", **kw)
    jsynthetic.generate_midi_corpus(tmp_path / "j", **kw)
    t_files = sorted(p.relative_to(tmp_path / "t")
                     for p in (tmp_path / "t").rglob("*.mid"))
    j_files = sorted(p.relative_to(tmp_path / "j")
                     for p in (tmp_path / "j").rglob("*.mid"))
    assert t_files == j_files and len(t_files) == 12
    for f in t_files:
        assert (tmp_path / "t" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes(), f


def _same_corpus(a, b):
    for k in ARRAYS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert set(a.splits) == set(b.splits)
    for k in a.splits:
        np.testing.assert_array_equal(a.splits[k], b.splits[k])
    assert list(a.artist_names) == list(b.artist_names)
    assert a.vocab.tokens == b.vocab.tokens
    assert [tuple(m) for m in a.merges] == [tuple(m) for m in b.merges]
    if a.base_song_len is None:
        assert b.base_song_len is None
    else:
        np.testing.assert_array_equal(a.base_song_len, b.base_song_len)


@pytest.mark.parametrize("bpe_merges,max_len", [(0, 0), (0, 64), (40, 0)])
def test_build_midi_corpus_matches_jax(tmp_path, bpe_merges, max_len):
    raw = tmp_path / "raw"
    jsynthetic.generate_midi_corpus(raw, num_artists=6, songs_per_artist=4,
                                    seed=1, notes_range=(10, 30))
    # a file without notes: skipped by both
    (raw / "artist_000" / "empty.mid").write_bytes(
        b"MThd" + struct.pack(">IHHH", 6, 0, 1, 480) + b"MTrk"
        + struct.pack(">I", 4) + b"\x00\xff\x2f\x00")
    a = tcorpus.build_midi_corpus(raw, tmp_path / "tc", max_len, seed=3,
                                  bpe_merges=bpe_merges)
    b = jcorpus.build_midi_corpus(raw, tmp_path / "jc", max_len, seed=3,
                                  bpe_merges=bpe_merges)
    _same_corpus(a, b)
    assert len(a.vocab) == 204 + bpe_merges
    assert a.songs.shape[0] == 24
    # each package loads the other's files
    _same_corpus(tcorpus.PackedCorpus.load(tmp_path / "jc"), b)
    _same_corpus(jcorpus.PackedCorpus.load(tmp_path / "tc"), a)


@pytest.mark.parametrize("dataset,extra", [
    ("midi", []), ("midi", ["--bpe_merges", "25"]),
    ("lyrics", ["--vocab_size", "90"]),
    ("lyrics", ["--vocab_size", "90", "--bpe_merges", "20"])])
def test_prepare_matches_prepare_data(tmp_path, capsys, dataset, extra):
    """``cli prepare --synthetic`` packs the corpus that
    ``scripts/prepare_data.py`` packs, and prints the same line."""
    args = ["--synthetic", "--dataset", dataset, "--artists", "5",
            "--songs", "4", "--max_len", "0", "--seed", "2", *extra]
    prepare_data.main([*args, "--out", str(tmp_path / "j")])
    cli.main(["prepare", *args, "--out", str(tmp_path / "t")])
    jline, tline = capsys.readouterr().out.splitlines()
    assert tline == jline.replace(str(tmp_path / "j"), str(tmp_path / "t"))
    _same_corpus(tcorpus.PackedCorpus.load(tmp_path / "t"),
                 jcorpus.PackedCorpus.load(tmp_path / "j"))

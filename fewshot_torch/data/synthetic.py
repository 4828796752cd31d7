"""Deterministic synthetic corpora (offline stand-ins for scraped data).

Port of ``fewshot/data/synthetic.py`` (``generate_lyrics_csv``,
``generate_midi_corpus``): the same seeded numpy streams, so both packages
write a byte-identical lyrics CSV and byte-identical per-artist ``.mid``
files for the same arguments.  Every artist gets its own style (signature
words; a musical scale, key, register, loudness and note spacing), so
conditioning on an artist's support songs is a real few-shot task.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

from fewshot_torch.data.midi import Note, write_midi

_COMMON = ("the a my your in on of and i you we it to for with night day "
           "heart time love never always gone away home road fire rain light "
           "dark dream run stay go know feel see hold take give").split()
_THEMES = [
    "river stone mountain echo wild silver cold north wind hollow".split(),
    "neon city subway velvet smoke midnight taxi skyline glass chrome".split(),
    "honey summer peach golden barefoot porch sweet clover meadow sun".split(),
    "ghost sorrow ashes winter grave pale mourning shadow bone frost".split(),
    "engine highway gasoline thunder steel whiskey dust leather crow".split(),
    "ocean salt sail horizon tide pearl drift harbor gull moon".split(),
]
_SYLLABLES = ("ba be bi bo bu da de di do du ka ke ki ko ku la le li lo lu "
              "ma me mi mo mu na ne ni no nu ra re ri ro ru sa se si so su "
              "ta te ti to tu va ve vi vo vu za ze zi zo zu").split()

# styled songs: n_lines ~ U{6..11}, words per line ~ U{4..8};
# generic filler: n_lines ~ U{2..3}, words per line ~ U{3..5}
LINE_RANGE = (6, 12)
WORDS_RANGE = (4, 9)
GENERIC_LINE_RANGE = (2, 4)
GENERIC_WORDS_RANGE = (3, 6)


def _artist_name(i: int) -> str:
    return f"artist_{i:03d}"


def _synth_words(n: int, rng) -> list[str]:
    """n distinct pronounceable fake words (vocab-scale corpora)."""
    words: list[str] = []
    seen = set(_COMMON)
    while len(words) < n:
        w = "".join(rng.choice(_SYLLABLES)
                    for _ in range(rng.randint(2, 5)))
        if w not in seen:
            seen.add(w)
            words.append(w)
    return words


def _make_pool(extra_vocab: int, rng):
    """The shared zipf-weighted synthetic word pool."""
    if extra_vocab <= 0:
        return [], None
    pool = _synth_words(extra_vocab, rng)
    ranks = np.arange(1, len(pool) + 1, dtype=np.float64)
    pool_p = 1.0 / ranks ** 1.1
    pool_p /= pool_p.sum()
    return pool, pool_p


def _draw_style(rng, artist_idx: int, pool: list[str]) -> dict:
    theme = list(_THEMES[artist_idx % len(_THEMES)])
    if pool:
        sig = rng.choice(len(pool), size=12, replace=False)
        theme = theme + [pool[i] for i in sig]
    mix = rng.dirichlet(np.ones(len(_COMMON)) * 2.0)
    theme_w = rng.dirichlet(np.ones(len(theme)) * 2.0)
    theme_rate = 0.35 + 0.2 * rng.rand()
    return {"theme": theme, "mix": mix, "theme_w": theme_w,
            "theme_rate": theme_rate, "pool_rate": 0.35 if pool else 0.0}


def _draw_song(rng, style: dict, pool: list[str], pool_p, generic: bool
               ) -> str:
    if generic:
        n_lines = rng.randint(*GENERIC_LINE_RANGE)
        counts = rng.randint(*GENERIC_WORDS_RANGE, size=n_lines)
        n = int(counts.sum())
        w = rng.choice(len(_COMMON), size=n)
        words = [_COMMON[int(i)] for i in w]
    else:
        theme = style["theme"]
        n_lines = rng.randint(*LINE_RANGE)
        counts = rng.randint(*WORDS_RANGE, size=n_lines)
        n = int(counts.sum())
        u = rng.rand(n)
        w_theme = rng.choice(len(theme), size=n, p=style["theme_w"])
        w_common = rng.choice(len(_COMMON), size=n, p=style["mix"])
        words = [theme[w_theme[i]] if u[i] < style["theme_rate"]
                 else _COMMON[w_common[i]] for i in range(n)]
        if pool:
            w_pool = rng.choice(len(pool), size=n, p=pool_p)
            hi = style["theme_rate"] + style["pool_rate"]
            words = [pool[w_pool[i]]
                     if style["theme_rate"] <= u[i] < hi else words[i]
                     for i in range(n)]
    lines = []
    pos = 0
    for c in counts:
        lines.append(" ".join(words[pos:pos + int(c)]))
        pos += int(c)
    return " / ".join(lines)


def generate_lyrics_csv(path: str | Path, num_artists: int = 24,
                        songs_per_artist: int = 16, seed: int = 0,
                        extra_vocab: int = 0,
                        generic_frac: float = 0.0) -> None:
    """Write an (artist, song, lyrics) CSV with per-artist word styles.

    extra_vocab > 0 adds a zipf-weighted pool of that many synthetic words
    (vocab-scale corpora); generic_frac > 0 makes that fraction of each
    artist's songs short and style-free."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    pool, pool_p = _make_pool(extra_vocab, rng)
    with open(path, "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f)
        writer.writerow(["artist", "song", "lyrics"])
        for a in range(num_artists):
            style = _draw_style(rng, a, pool)
            n_generic = int(round(generic_frac * songs_per_artist))
            for s in range(songs_per_artist):
                text = _draw_song(rng, style, pool, pool_p, s < n_generic)
                writer.writerow([_artist_name(a), f"song_{s:03d}", text])


_SCALES = {  # semitone offsets within an octave
    "major": [0, 2, 4, 5, 7, 9, 11],
    "minor": [0, 2, 3, 5, 7, 8, 10],
    "pent": [0, 3, 5, 7, 10],
}


def generate_midi_corpus(root: str | Path, num_artists: int = 24,
                         songs_per_artist: int = 16, seed: int = 0,
                         notes_range: tuple[int, int] = (24, 48)) -> None:
    """Write per-artist directories of ``.mid`` files with per-artist
    styles.  notes_range: (lo, hi) notes per song, hi exclusive (each note
    becomes 4 SHIFT/PITCH/DUR/VEL events)."""
    rng = np.random.RandomState(seed + 1)
    root = Path(root)
    scale_names = list(_SCALES)
    for a in range(num_artists):
        adir = root / _artist_name(a)
        adir.mkdir(parents=True, exist_ok=True)
        key = rng.randint(0, 12)
        scale = _SCALES[scale_names[a % len(scale_names)]]
        register = rng.randint(48, 68)          # the artist's pitch centre
        vel_center = rng.randint(40, 100)
        tempo_grid = rng.choice([0.125, 0.25, 0.375])  # note spacing (s)
        for s in range(songs_per_artist):
            n_notes = rng.randint(notes_range[0], notes_range[1])
            t = 0.0
            deg = rng.randint(0, len(scale))
            notes = []
            for _ in range(n_notes):
                deg = (deg + rng.randint(-2, 3)) % len(scale)
                octave = rng.choice([-12, 0, 0, 0, 12])
                pitch = int(np.clip(register + key + scale[deg] + octave,
                                    21, 108))
                dur = tempo_grid * rng.choice([1, 1, 2, 2, 4])
                vel = int(np.clip(vel_center + rng.randint(-12, 13), 1, 127))
                notes.append(Note(start=t, end=t + dur, pitch=pitch,
                                  velocity=vel))
                t += tempo_grid * rng.choice([1, 1, 1, 2])
            write_midi(notes, adir / f"song_{s:03d}.mid")

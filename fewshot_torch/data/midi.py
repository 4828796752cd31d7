"""MIDI: a Standard-MIDI-File reader and writer and the event tokenizer.

Port of ``fewshot/data/midi.py`` (stdlib ``struct`` only): the same parse,
the same event tokens and grammar masks, and a writer that emits the same
bytes for the same notes, so a ``.mid`` written by either package parses
identically in both.  The SMF container (variable-length quantities,
running status, tempo meta events, note-on/off pairing per channel) is
implemented from the spec.  Offline only: never on a device path.

Event vocabulary (string tokens shared with the word-vocab machinery):
    SHIFT_<k>  k in [0,31]  time since the previous note ONSET, 1/16 s grid
    PITCH_<p>  p in [0,127] MIDI note number
    DUR_<d>    d in [0,31]  note duration, 1/16 s grid (bucket d ~ (d+1)/16 s)
    VEL_<v>    v in [0,7]   velocity // 16
Each note emits the 4-token group (SHIFT, PITCH, DUR, VEL) in onset order.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path

TIME_GRID = 1.0 / 16.0   # seconds per SHIFT/DUR bucket
N_SHIFT, N_DUR, N_VEL = 32, 32, 8
DEFAULT_TEMPO = 500_000  # microseconds per quarter note (120 bpm)


@dataclass
class Note:
    start: float      # seconds
    end: float        # seconds
    pitch: int        # 0..127
    velocity: int     # 1..127


# ---------------------------------------------------------------------------
# SMF parsing
# ---------------------------------------------------------------------------

class _Cursor:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def u8(self) -> int:
        b = self.data[self.pos]
        self.pos += 1
        return b

    def take(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def varlen(self) -> int:
        """MIDI variable-length quantity (7 bits per byte, MSB = continue)."""
        val = 0
        while True:
            b = self.u8()
            val = (val << 7) | (b & 0x7F)
            if not b & 0x80:
                return val

    def eof(self) -> bool:
        return self.pos >= len(self.data)


def _parse_track(data: bytes):
    """Yield (abs_tick, kind, args) events from one MTrk chunk payload.

    kind in {"on", "off", "tempo"}.  Handles running status and skips
    meta/sysex events other than Set Tempo.
    """
    cur = _Cursor(data)
    tick = 0
    status = 0
    while not cur.eof():
        tick += cur.varlen()
        b = cur.u8()
        if b & 0x80:
            status = b
        else:
            cur.pos -= 1  # running status: data byte belongs to prev status
            if status == 0:
                raise ValueError("SMF: data byte with no running status")
        if status == 0xFF:          # meta
            mtype = cur.u8()
            length = cur.varlen()
            payload = cur.take(length)
            if mtype == 0x51 and length == 3:
                tempo = (payload[0] << 16) | (payload[1] << 8) | payload[2]
                yield tick, "tempo", (tempo,)
            status = 0              # meta/sysex cancel running status
        elif status in (0xF0, 0xF7):  # sysex
            cur.take(cur.varlen())
            status = 0
        else:
            kind = status & 0xF0
            chan = status & 0x0F
            if kind in (0x80, 0x90, 0xA0, 0xB0, 0xE0):
                d1, d2 = cur.u8(), cur.u8()
                if kind == 0x90 and d2 > 0:
                    yield tick, "on", (d1, d2, chan)
                elif kind == 0x80 or (kind == 0x90 and d2 == 0):
                    yield tick, "off", (d1, chan)
            elif kind in (0xC0, 0xD0):
                cur.u8()
            else:
                raise ValueError(f"SMF: bad status byte 0x{status:02x}")


def parse_midi(path: str | Path) -> list[Note]:
    """Parse an SMF file into a note list sorted by (start, pitch)."""
    data = Path(path).read_bytes()
    if data[:4] != b"MThd":
        raise ValueError(f"{path}: not a Standard MIDI File")
    hlen = struct.unpack(">I", data[4:8])[0]
    _fmt, ntrks, division = struct.unpack(">HHH", data[8:14])
    if division & 0x8000:
        raise ValueError(f"{path}: SMPTE time division unsupported")
    tpq = division or 480
    pos = 8 + hlen

    events: list[tuple[int, str, tuple]] = []
    for _ in range(ntrks):
        if data[pos:pos + 4] != b"MTrk":
            raise ValueError(f"{path}: expected MTrk chunk at {pos}")
        tlen = struct.unpack(">I", data[pos + 4:pos + 8])[0]
        events.extend(_parse_track(data[pos + 8:pos + 8 + tlen]))
        pos += 8 + tlen

    # tick -> seconds via the tempo map (tempo events apply globally).
    events.sort(key=lambda e: e[0])
    tempo_map = [(0, DEFAULT_TEMPO)]
    for tick, kind, args in events:
        if kind == "tempo":
            tempo_map.append((tick, args[0]))

    def tick_to_sec(tick: int) -> float:
        sec, prev_tick, tempo = 0.0, 0, DEFAULT_TEMPO
        for t, tp in tempo_map:
            if t >= tick:
                break
            sec += (t - prev_tick) * tempo / (tpq * 1e6)
            prev_tick, tempo = t, tp
        return sec + (tick - prev_tick) * tempo / (tpq * 1e6)

    # FIFO pairing keyed by (channel, pitch): a note-off only terminates a
    # note-on from its OWN channel (pretty_midi pairs per instrument; a
    # global-pitch key gave wrong durations on multi-channel files).
    notes: list[Note] = []
    open_notes: dict[tuple[int, int], list[tuple[int, int]]] = {}
    for tick, kind, args in events:
        if kind == "on":
            open_notes.setdefault((args[2], args[0]), []).append(
                (tick, args[1]))
        elif kind == "off" and open_notes.get((args[1], args[0])):
            on_tick, vel = open_notes[(args[1], args[0])].pop(0)
            if tick > on_tick:
                notes.append(Note(tick_to_sec(on_tick), tick_to_sec(tick),
                                  args[0], vel))
    notes.sort(key=lambda n: (n.start, n.pitch))
    return notes


# ---------------------------------------------------------------------------
# Event tokenization (the model's vocabulary)
# ---------------------------------------------------------------------------

def _bucket(seconds: float, n: int) -> int:
    return min(n - 1, max(0, int(round(seconds / TIME_GRID))))


def notes_to_events(notes: list[Note]) -> list[str]:
    """Notes -> SHIFT/PITCH/DUR/VEL token stream (onset order)."""
    out: list[str] = []
    prev_start = 0.0
    for n in sorted(notes, key=lambda n: (n.start, n.pitch)):
        out.append(f"SHIFT_{_bucket(n.start - prev_start, N_SHIFT)}")
        out.append(f"PITCH_{int(n.pitch) & 0x7F}")
        out.append(f"DUR_{_bucket(max(0.0, n.end - n.start - TIME_GRID), N_DUR)}")
        out.append(f"VEL_{min(N_VEL - 1, int(n.velocity) // 16)}")
        prev_start = n.start
    return out


def full_event_vocab() -> list[str]:
    """The closed MIDI event vocabulary (fixed, no counting needed)."""
    return ([f"SHIFT_{i}" for i in range(N_SHIFT)]
            + [f"PITCH_{i}" for i in range(128)]
            + [f"DUR_{i}" for i in range(N_DUR)]
            + [f"VEL_{i}" for i in range(N_VEL)])


def grammar_masks(vocab) -> "object":
    """[4, V] bool: which token ids are legal at each phase of the
    SHIFT->PITCH->DUR->VEL note-group cycle.

    Phase 0 may also end the song (EOS).  The decode loop
    (fewshot_torch.sampling) applies them so that every sampled group
    decodes into a note; an unconstrained model spends probability on
    malformed groups early in training.
    """
    import numpy as np
    from fewshot_torch.data.vocab import EOS
    kinds = ["SHIFT", "PITCH", "DUR", "VEL"]
    masks = np.zeros((4, len(vocab)), bool)
    for tid, tok in enumerate(vocab.tokens):
        kind = tok.split("_")[0]
        if kind in kinds:
            masks[kinds.index(kind), tid] = True
    masks[0, EOS] = True
    return masks


def events_to_notes(events: list[str]) -> list[Note]:
    """Token stream -> notes.  Tolerates malformed model output by scanning
    for complete SHIFT/PITCH/DUR/VEL groups."""
    notes: list[Note] = []
    t = 0.0
    i = 0
    while i + 3 < len(events):
        grp = events[i:i + 4]
        kinds = [e.split("_")[0] for e in grp]
        if kinds != ["SHIFT", "PITCH", "DUR", "VEL"]:
            i += 1
            continue
        shift, pitch, dur, vel = (int(e.split("_")[1]) for e in grp)
        t += shift * TIME_GRID
        notes.append(Note(start=t, end=t + (dur + 1) * TIME_GRID,
                          pitch=pitch, velocity=vel * 16 + 8))
        i += 4
    return notes


# ---------------------------------------------------------------------------
# SMF writing (for the `sample` entry point)
# ---------------------------------------------------------------------------

def _varlen(val: int) -> bytes:
    chunks = [val & 0x7F]
    val >>= 7
    while val:
        chunks.append((val & 0x7F) | 0x80)
        val >>= 7
    return bytes(reversed(chunks))


def write_midi(notes: list[Note], path: str | Path, tpq: int = 480) -> None:
    """Write notes as a format-0 SMF at fixed 120 bpm."""
    evs: list[tuple[int, int, bytes]] = []  # (tick, order, message)
    for n in notes:
        on_tick = int(round(n.start * 1e6 / DEFAULT_TEMPO * tpq))
        off_tick = int(round(n.end * 1e6 / DEFAULT_TEMPO * tpq))
        vel = min(127, max(1, int(n.velocity)))
        evs.append((on_tick, 1, bytes([0x90, n.pitch & 0x7F, vel])))
        evs.append((max(off_tick, on_tick + 1), 0,
                    bytes([0x80, n.pitch & 0x7F, 0])))
    evs.sort(key=lambda e: (e[0], e[1]))

    body = bytearray()
    body += _varlen(0) + bytes([0xFF, 0x51, 0x03]) + \
        DEFAULT_TEMPO.to_bytes(3, "big")
    prev = 0
    for tick, _, msg in evs:
        body += _varlen(tick - prev) + msg
        prev = tick
    body += _varlen(0) + bytes([0xFF, 0x2F, 0x00])  # end of track

    out = bytearray()
    out += b"MThd" + struct.pack(">IHHH", 6, 0, 1, tpq)
    out += b"MTrk" + struct.pack(">I", len(body)) + body
    Path(path).write_bytes(bytes(out))

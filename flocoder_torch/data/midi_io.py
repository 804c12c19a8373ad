"""Standard MIDI File (SMF) reader and writer, the port's own copy of
``flocoder_tpu/data/midi_io.py`` (stdlib only; pretty_midi is not a
dependency):

- ``read_midi``: parse format 0/1 files (header division, tempo map, track
  names, program changes, note-on/off pairing with running status) into
  ``MidiFile``/``MidiInstrument``/``MidiNote`` objects with absolute times
  in seconds;
- ``write_midi``: emit a format-1 file at a fixed tempo;
- ``MidiFile.get_tempo_changes`` / ``get_end_time`` as pretty_midi names
  them.

Both packages write the same bytes for the same ``MidiFile``
(tests/test_torch_midi.py).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Tuple

__all__ = ["MidiNote", "MidiInstrument", "MidiFile", "read_midi",
           "write_midi", "write_synthetic_corpus"]


@dataclass
class MidiNote:
    pitch: int
    velocity: int
    start: float  # seconds
    end: float    # seconds


@dataclass
class MidiInstrument:
    name: str = ""
    program: int = 0
    is_drum: bool = False
    notes: List[MidiNote] = field(default_factory=list)


@dataclass
class MidiFile:
    instruments: List[MidiInstrument] = field(default_factory=list)
    tempos: List[Tuple[float, float]] = field(default_factory=list)  # (time_s, bpm)

    def get_tempo_changes(self):
        """pretty_midi-compatible: (times array, bpm array)."""
        import numpy as np
        if not self.tempos:
            return np.array([0.0]), np.array([120.0])
        t, b = zip(*self.tempos)
        return np.asarray(t), np.asarray(b)

    def get_end_time(self) -> float:
        return max((n.end for i in self.instruments for n in i.notes),
                   default=0.0)

    def write(self, path: str, ticks_per_beat: int = 480):
        write_midi(path, self, ticks_per_beat=ticks_per_beat)


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    value = 0
    while True:
        b = data[pos]
        pos += 1
        value = (value << 7) | (b & 0x7F)
        if not b & 0x80:
            return value, pos


def _varint(value: int) -> bytes:
    out = [value & 0x7F]
    value >>= 7
    while value:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    return bytes(reversed(out))


def read_midi(path: str) -> MidiFile:
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"MThd":
        raise ValueError(f"{path}: not a MIDI file")
    hlen = struct.unpack(">I", data[4:8])[0]
    fmt, ntrks, division = struct.unpack(">HHH", data[8:14])
    if division & 0x8000:
        raise ValueError("SMPTE time division not supported")
    tpb = division

    pos = 8 + hlen
    # Pass 1: collect tempo events (tick, us_per_beat) across all tracks.
    tracks_raw = []
    for _ in range(ntrks):
        if data[pos:pos + 4] != b"MTrk":
            raise ValueError("bad track chunk")
        tlen = struct.unpack(">I", data[pos + 4:pos + 8])[0]
        tracks_raw.append(data[pos + 8:pos + 8 + tlen])
        pos += 8 + tlen

    tempo_events: List[Tuple[int, int]] = []  # (tick, us_per_beat)

    def parse_track(raw: bytes, collect):
        p = 0
        tick = 0
        status = 0
        while p < len(raw):
            delta, p = _read_varint(raw, p)
            tick += delta
            b = raw[p]
            if b >= 0x80:
                status = b
                p += 1
            if status == 0xFF:  # meta
                mtype = raw[p]
                mlen, p2 = _read_varint(raw, p + 1)
                payload = raw[p2:p2 + mlen]
                p = p2 + mlen
                collect(tick, "meta", mtype, payload)
            elif status in (0xF0, 0xF7):  # sysex
                mlen, p2 = _read_varint(raw, p)
                p = p2 + mlen
            else:
                kind = status & 0xF0
                ch = status & 0x0F
                if kind in (0xC0, 0xD0):  # program change / channel pressure
                    collect(tick, "short", status, raw[p:p + 1])
                    p += 1
                else:
                    collect(tick, "event", status, raw[p:p + 2])
                    p += 2

    for raw in tracks_raw:
        def tempo_collect(tick, kind, a, payload):
            if kind == "meta" and a == 0x51 and len(payload) == 3:
                tempo_events.append(
                    (tick, int.from_bytes(payload, "big")))
        parse_track(raw, tempo_collect)
    tempo_events.sort()
    if not tempo_events or tempo_events[0][0] > 0:
        tempo_events.insert(0, (0, 500000))  # default 120 bpm

    # tick → seconds via the tempo map
    seg_start_tick = [t for t, _ in tempo_events]
    seg_uspb = [u for _, u in tempo_events]
    seg_start_sec = [0.0]
    for i in range(1, len(tempo_events)):
        dt = (seg_start_tick[i] - seg_start_tick[i - 1]) / tpb
        seg_start_sec.append(seg_start_sec[-1] + dt * seg_uspb[i - 1] / 1e6)

    def tick_to_sec(tick: int) -> float:
        import bisect
        i = bisect.bisect_right(seg_start_tick, tick) - 1
        return (seg_start_sec[i] +
                (tick - seg_start_tick[i]) / tpb * seg_uspb[i] / 1e6)

    mf = MidiFile(tempos=[(tick_to_sec(t), 6e7 / u)
                          for t, u in tempo_events])

    for raw in tracks_raw:
        inst = MidiInstrument()
        open_notes: dict = {}

        def collect(tick, kind, a, payload):
            if kind == "meta" and a == 0x03:
                inst.name = payload.decode("latin-1", errors="replace")
            elif kind == "short" and (a & 0xF0) == 0xC0:
                inst.program = payload[0]
            elif kind == "event":
                st = a & 0xF0
                ch = a & 0x0F
                if ch == 9:
                    inst.is_drum = True
                if st == 0x90 and payload[1] > 0:  # note on
                    open_notes.setdefault(payload[0], []).append(
                        (tick, payload[1]))
                elif st == 0x80 or (st == 0x90 and payload[1] == 0):
                    pitch = payload[0]
                    if open_notes.get(pitch):
                        t_on, vel = open_notes[pitch].pop(0)
                        inst.notes.append(MidiNote(
                            pitch=pitch, velocity=vel,
                            start=tick_to_sec(t_on), end=tick_to_sec(tick)))

        parse_track(raw, collect)
        if inst.notes:
            inst.notes.sort(key=lambda n: (n.start, n.pitch))
            mf.instruments.append(inst)
    return mf


def write_midi(path: str, mf: MidiFile, ticks_per_beat: int = 480,
               bpm: float = 120.0):
    uspb = int(round(6e7 / bpm))

    def sec_to_tick(s: float) -> int:
        return int(round(s * bpm / 60.0 * ticks_per_beat))

    chunks = []
    # tempo/conductor track
    t0 = b"".join([
        _varint(0), bytes([0xFF, 0x51, 0x03]), uspb.to_bytes(3, "big"),
        _varint(0), bytes([0xFF, 0x2F, 0x00]),
    ])
    chunks.append(t0)

    for ch, inst in enumerate(mf.instruments):
        channel = 9 if inst.is_drum else min(ch, 15)
        events: List[Tuple[int, int, bytes]] = []  # (tick, order, data)
        for n in inst.notes:
            on = sec_to_tick(n.start)
            off = sec_to_tick(max(n.end, n.start))
            vel = max(1, min(127, int(n.velocity)))
            events.append((on, 1, bytes([0x90 | channel, n.pitch & 0x7F, vel])))
            events.append((off, 0, bytes([0x80 | channel, n.pitch & 0x7F, 0])))
        events.sort()
        out = []
        if inst.name:
            name_b = inst.name.encode("latin-1", errors="replace")
            out += [_varint(0), bytes([0xFF, 0x03]), _varint(len(name_b)),
                    name_b]
        out += [_varint(0), bytes([0xC0 | channel, inst.program & 0x7F])]
        last = 0
        for tick, _, ev in events:
            out += [_varint(tick - last), ev]
            last = tick
        out += [_varint(0), bytes([0xFF, 0x2F, 0x00])]
        chunks.append(b"".join(out))

    with open(path, "wb") as f:
        f.write(b"MThd" + struct.pack(">IHHH", 6, 1, len(chunks),
                                      ticks_per_beat))
        for c in chunks:
            f.write(b"MTrk" + struct.pack(">I", len(c)) + c)
    return path


def write_synthetic_corpus(root: str, n_songs: int, seed: int = 0,
                           frames: int = 128, bpm: float = 120.0) -> list:
    """A seeded corpus in POP909's layout, for runs with no corpus on disk:
    ``root/NNN/NNN.mid`` for songs 1..n_songs, each with a MELODY track (a
    line of notes, pitches 60–84) and a PIANO track (three-note chords,
    roots 36–59), velocities 40–119, on the piano-roll grid of 8 frames a
    beat, starting at 0 and ending at frame ``frames − 1``: each song's
    rolls convert to ``frames``-wide images (128 × 128 by default). Song
    ``s`` draws from ``numpy.random.default_rng(seed · 100003 + s)``.
    Returns the paths."""
    import os

    import numpy as np
    step = 60.0 / bpm / 8.0                    # seconds per frame
    paths = []
    for s in range(1, n_songs + 1):
        rng = np.random.default_rng(seed * 100003 + s)
        melody, piano = [], []
        t = 0
        while t < frames - 1:
            d = min(int(rng.integers(2, 9)), frames - 1 - t)
            melody.append(MidiNote(pitch=int(rng.integers(60, 85)),
                                   velocity=int(rng.integers(40, 120)),
                                   start=t * step, end=(t + d) * step))
            t += d
        t = 0
        while t < frames - 1:
            d = min(int(rng.integers(4, 17)), frames - 1 - t)
            low = int(rng.integers(36, 60))
            vel = int(rng.integers(40, 120))
            piano += [MidiNote(pitch=low + k, velocity=vel, start=t * step,
                               end=(t + d) * step) for k in (0, 4, 7)]
            t += d
        song = MidiFile(instruments=[MidiInstrument(name="MELODY", notes=melody),
                                     MidiInstrument(name="PIANO", notes=piano)],
                        tempos=[(0.0, bpm)])
        d = os.path.join(root, f"{s:03d}")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"{s:03d}.mid")
        write_midi(path, song)
        paths.append(path)
    return paths

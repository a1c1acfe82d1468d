"""Standard MIDI file reader/writer, pure Python.

Replaces the reference's `mido` dependency (reference task/diffusion.py:
1235-1265 `save_midi`; the MAPS/MAESTRO label pipeline needs the reader).

Writer contract matches the reference's `save_midi`: format-0 file, one
track, no tempo event (default 120 bpm), `ticks_per_second =
ticks_per_beat * 2`, absolute times quantized to ticks and emitted as
delta-time note_on/note_off pairs.

Reader: tempo-map-aware tick->second conversion, note_on(vel=0) == note_off,
optional sustain-pedal (CC64) offset extension — the onsets-and-frames
labelling convention used for MAESTRO frame rolls.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Tuple


@dataclasses.dataclass
class MidiNote:
    onset: float      # seconds
    offset: float     # seconds
    pitch: int        # MIDI note number
    velocity: int     # 1-127


# ----------------------------------------------------------------- writing

def _varlen(value: int) -> bytes:
    out = [value & 0x7F]
    value >>= 7
    while value:
        out.append(0x80 | (value & 0x7F))
        value >>= 7
    return bytes(reversed(out))


def write_midi(
    path: str,
    pitches: List[int],
    intervals: List[Tuple[float, float]],
    velocities: Optional[List[int]] = None,
    ticks_per_beat: int = 480,
) -> None:
    """Write note events (pitch: MIDI number, interval: seconds) as SMF0.

    Mirrors reference save_midi's timing scheme (ticks_per_second =
    2 * ticks_per_beat at the default 120 bpm, task/diffusion.py:1247).
    """
    if velocities is None:
        velocities = [100] * len(pitches)
    tps = ticks_per_beat * 2.0

    events = []  # (tick, order, status, pitch, velocity); offs before ons at same tick
    for p, (t0, t1), v in zip(pitches, intervals, velocities):
        v = max(1, min(127, int(v)))
        p = int(p)
        events.append((int(round(t0 * tps)), 1, 0x90, p, v))
        events.append((int(round(t1 * tps)), 0, 0x80, p, 0))
    events.sort()

    track = bytearray()
    last = 0
    for tick, _, status, p, v in events:
        track += _varlen(tick - last)
        track += bytes([status, p, v])
        last = tick
    track += b"\x00\xff\x2f\x00"  # end of track

    with open(path, "wb") as f:
        f.write(b"MThd" + struct.pack(">IHHH", 6, 0, 1, ticks_per_beat))
        f.write(b"MTrk" + struct.pack(">I", len(track)) + bytes(track))


# ----------------------------------------------------------------- reading

def _read_varlen(data: bytes, i: int) -> Tuple[int, int]:
    value = 0
    while True:
        b = data[i]
        i += 1
        value = (value << 7) | (b & 0x7F)
        if not b & 0x80:
            return value, i


def _parse_track(data: bytes):
    """Yield (tick, kind, a, b) events; kind in {'on','off','cc','tempo'}."""
    i, tick, status = 0, 0, 0
    while i < len(data):
        delta, i = _read_varlen(data, i)
        tick += delta
        b = data[i]
        if b & 0x80:
            status = b
            i += 1
        kind = status & 0xF0
        if kind in (0x80, 0x90, 0xA0, 0xB0, 0xE0):
            a, b2 = data[i], data[i + 1]
            i += 2
            if kind == 0x90 and b2 > 0:
                yield tick, "on", a, b2
            elif kind == 0x80 or (kind == 0x90 and b2 == 0):
                yield tick, "off", a, b2
            elif kind == 0xB0:
                yield tick, "cc", a, b2
        elif kind in (0xC0, 0xD0):
            i += 1
        elif status == 0xFF:
            meta = data[i]
            length, i2 = _read_varlen(data, i + 1)
            payload = data[i2 : i2 + length]
            i = i2 + length
            if meta == 0x51:
                yield tick, "tempo", int.from_bytes(payload, "big"), 0
            if meta == 0x2F:
                return
        elif status in (0xF0, 0xF7):  # sysex
            length, i2 = _read_varlen(data, i)
            i = i2 + length
        else:
            raise ValueError(f"unparseable MIDI byte 0x{b:02x} at {i}")


def read_midi(path: str, extend_sustain: bool = True) -> List[MidiNote]:
    """Parse an SMF file into note events in seconds.

    extend_sustain: extend note offsets to the sustain-pedal (CC64) release,
    the frame-label convention for MAESTRO-style datasets.
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"MThd":
        raise ValueError(f"{path}: not a MIDI file")
    _, fmt, ntrks, division = struct.unpack(">IHHH", data[4:14])
    if division & 0x8000:
        raise ValueError("SMPTE time division not supported")

    # collect all events from all tracks with absolute ticks
    events = []
    i = 14
    for _ in range(ntrks):
        if data[i : i + 4] != b"MTrk":
            raise ValueError("bad track chunk")
        (length,) = struct.unpack(">I", data[i + 4 : i + 8])
        body = data[i + 8 : i + 8 + length]
        events.extend(_parse_track(body))
        i += 8 + length
    events.sort(key=lambda e: e[0])

    # tick -> seconds with the tempo map (default 120 bpm = 500000 us/beat)
    tempo_us = 500000
    sec, last_tick = 0.0, 0
    out_events = []
    for tick, kind, a, b in events:
        sec += (tick - last_tick) * tempo_us / (1e6 * division)
        last_tick = tick
        if kind == "tempo":
            tempo_us = a
        else:
            out_events.append((sec, kind, a, b))

    notes: List[MidiNote] = []
    active = {}          # pitch -> (onset_sec, velocity)
    pedal_down = False
    pending_release = {}  # pitch -> onset info waiting for pedal up

    for sec, kind, a, b in out_events:
        if kind == "on":
            # re-strike while sustained: close the old instance first
            if a in pending_release:
                onset, vel = pending_release.pop(a)
                notes.append(MidiNote(onset, sec, a, vel))
            if a in active:
                onset, vel = active.pop(a)
                notes.append(MidiNote(onset, sec, a, vel))
            active[a] = (sec, b)
        elif kind == "off":
            if a in active:
                onset, vel = active.pop(a)
                if extend_sustain and pedal_down:
                    pending_release[a] = (onset, vel)
                else:
                    notes.append(MidiNote(onset, sec, a, vel))
        elif kind == "cc" and a == 64:
            was_down = pedal_down
            pedal_down = b >= 64
            if was_down and not pedal_down:
                for pitch, (onset, vel) in pending_release.items():
                    notes.append(MidiNote(onset, sec, pitch, vel))
                pending_release.clear()

    end = out_events[-1][0] if out_events else 0.0
    for pitch, (onset, vel) in {**active, **pending_release}.items():
        notes.append(MidiNote(onset, end, pitch, vel))
    notes.sort(key=lambda n: (n.onset, n.pitch))
    return notes

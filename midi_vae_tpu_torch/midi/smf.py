"""Standard MIDI File (SMF) reader/writer, pure Python (a copy of
``midi_vae_tpu/midi/smf.py``: the port keeps its own).

A MIDI file parses to flat arrays ``(onset_sec, duration_sec, pitch,
velocity)`` sorted by onset. Tempo changes (set-tempo meta events across
all tracks, as the spec requires for format 1) are applied when
converting ticks to seconds; note-on with velocity 0 is treated as
note-off; unterminated notes close at the end of the track.

It is the oracle of the native C++ parser (``native/midiparse.cc``),
which ``midi/parse.py`` uses by default.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Tuple

import numpy as np

DEFAULT_TEMPO_US = 500000  # 120 bpm, MIDI spec default
MAX_PITCH = 128
MAX_VARLEN_BYTES = 4  # SMF spec: variable-length quantities fit 4 bytes


@dataclasses.dataclass
class NoteArrays:
    """Flat note-event arrays, the cross-language parse result."""

    onset: np.ndarray  # float64 [N] seconds
    duration: np.ndarray  # float64 [N] seconds
    pitch: np.ndarray  # int32 [N] 0..127
    velocity: np.ndarray  # int32 [N] 1..127

    def __len__(self) -> int:
        return len(self.onset)

    @property
    def total_seconds(self) -> float:
        if len(self.onset) == 0:
            return 0.0
        return float(np.max(self.onset + self.duration))


def _read_varlen(data: bytes, pos: int, end: int) -> Tuple[int, int]:
    """Bounded variable-length quantity: reads stop at ``end`` and at the
    spec's 4-byte cap, so a crafted stream of continuation bytes can
    neither run past the track nor grow the value without bound."""
    value = 0
    for _ in range(MAX_VARLEN_BYTES):
        if pos >= end:
            raise ValueError("truncated variable-length quantity")
        b = data[pos]
        pos += 1
        value = (value << 7) | (b & 0x7F)
        if not b & 0x80:
            return value, pos
    raise ValueError("variable-length quantity exceeds 4 bytes")


def _write_varlen(value: int) -> bytes:
    out = [value & 0x7F]
    value >>= 7
    while value:
        out.append(0x80 | (value & 0x7F))
        value >>= 7
    return bytes(reversed(out))


def read_smf(path: str) -> NoteArrays:
    """Parse an SMF format 0/1 file into note arrays (onsets in seconds)."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return parse_smf_bytes(data)
    except ValueError as e:
        raise ValueError(f"{e}: {path}") from None


def parse_smf_bytes(data: bytes) -> NoteArrays:
    """Parse SMF bytes into note arrays.

    Untrusted-input contract (shared with the C++ parser, which returns
    NULL → ValueError for the same byte streams): any malformed input
    raises ValueError — truncation, header/track overruns, >4-byte
    varlen quantities, data bytes with the high bit set, running status
    before any status byte, SMPTE division with zero ticks/frame. Every
    read is bounded by its chunk, so no input can index past a track or
    allocate beyond the note events it actually carries.
    """
    if len(data) < 14 or data[:4] != b"MThd":
        raise ValueError("not a MIDI file (bad header)")
    hlen, fmt, ntrks, division = struct.unpack(">IHHH", data[4:14])
    if hlen < 6:
        raise ValueError(f"bad MThd length {hlen}")
    pos = 8 + hlen
    if pos > len(data):
        raise ValueError("MThd chunk extends past end of file")

    # Pass 1: gather (tick, tempo) changes and raw (tick, kind, pitch, vel)
    # note events across every track, then merge on ticks.
    tempo_changes: List[Tuple[int, int]] = []  # (tick, microseconds/quarter)
    raw: List[Tuple[int, int, int, int]] = []  # (tick, on/off, pitch, vel)

    for _ in range(ntrks):
        if data[pos : pos + 4] != b"MTrk":
            raise ValueError(f"bad track chunk at byte {pos}")
        if pos + 8 > len(data):
            raise ValueError("truncated track header")
        (tlen,) = struct.unpack(">I", data[pos + 4 : pos + 8])
        tpos, tend = pos + 8, pos + 8 + tlen
        if tend > len(data):
            raise ValueError("track chunk extends past end of file")
        pos = tend

        tick = 0
        running = 0
        while tpos < tend:
            delta, tpos = _read_varlen(data, tpos, tend)
            tick += delta
            if tpos >= tend:
                raise ValueError("truncated event (no status byte)")
            status = data[tpos]
            if status & 0x80:
                tpos += 1
                if status < 0xF0:
                    running = status
            else:
                status = running  # running status reuses the previous one

            kind = status & 0xF0
            if kind in (0x90, 0x80):  # note on / note off
                if tpos + 2 > tend:
                    raise ValueError("truncated note event")
                pitch, vel = data[tpos], data[tpos + 1]
                if (pitch | vel) & 0x80:
                    raise ValueError("note data byte out of range (desynchronized stream)")
                tpos += 2
                on = kind == 0x90 and vel > 0
                raw.append((tick, 1 if on else 0, pitch, vel))
            elif kind in (0xA0, 0xB0, 0xE0):  # two data bytes
                tpos += 2
            elif kind in (0xC0, 0xD0):  # one data byte
                tpos += 1
            elif status == 0xFF:  # meta
                if tpos >= tend:
                    raise ValueError("truncated meta event")
                meta = data[tpos]
                length, tpos = _read_varlen(data, tpos + 1, tend)
                if meta == 0x51 and length == 3:
                    if tpos + 3 > tend:
                        raise ValueError("truncated tempo event")
                    tempo = int.from_bytes(data[tpos : tpos + 3], "big")
                    tempo_changes.append((tick, tempo))
                tpos += length
            elif status in (0xF0, 0xF7):  # sysex: F0 <varlen length> <bytes>
                # the length follows the status byte directly (no type byte
                # — a former off-by-one here skipped a byte and desynced
                # against the C++ parser on any file carrying sysex)
                length, tpos = _read_varlen(data, tpos, tend)
                tpos += length
            else:
                raise ValueError(f"unhandled status byte 0x{status:02x}")
        if tpos > tend:
            raise ValueError("event data overruns its track chunk")

    # Tick → seconds conversion (piecewise-linear over the tempo map).
    tempo_changes.sort()
    if division & 0x8000:  # SMPTE: ticks are already wall-clock
        fps = 256 - (division >> 8)  # two's complement of the negative byte
        tpf = division & 0xFF
        if tpf == 0:
            raise ValueError("SMPTE division with zero ticks per frame")

        def tick_to_sec(t: int) -> float:
            return t / (fps * tpf)

    else:
        ppq = division or 96
        anchors_t = [0]
        anchors_s = [0.0]
        tempo = DEFAULT_TEMPO_US
        for ctick, ctempo in tempo_changes:
            anchors_s.append(anchors_s[-1] + (ctick - anchors_t[-1]) * tempo / (ppq * 1e6))
            anchors_t.append(ctick)
            tempo = ctempo
        tempos = [DEFAULT_TEMPO_US] + [tc[1] for tc in tempo_changes]

        def tick_to_sec(t: int) -> float:
            i = np.searchsorted(anchors_t, t, side="right") - 1
            return anchors_s[i] + (t - anchors_t[i]) * tempos[i] / (ppq * 1e6)

    # Pair note-ons with the matching note-off (FIFO per pitch).
    raw.sort(key=lambda e: (e[0], e[1]))  # offs before ons at the same tick
    open_notes: dict[int, List[Tuple[int, int]]] = {}
    notes: List[Tuple[float, float, int, int]] = []
    max_tick = 0
    for tick, on, pitch, vel in raw:
        max_tick = max(max_tick, tick)
        if on:
            open_notes.setdefault(pitch, []).append((tick, vel))
        else:
            stack = open_notes.get(pitch)
            if stack:
                start, svel = stack.pop(0)
                notes.append((tick_to_sec(start), tick_to_sec(tick) - tick_to_sec(start), pitch, svel))
    for pitch, stack in open_notes.items():  # unterminated: close at track end
        for start, svel in stack:
            notes.append((tick_to_sec(start), tick_to_sec(max_tick) - tick_to_sec(start), pitch, svel))

    notes.sort()
    if not notes:
        return NoteArrays(
            onset=np.zeros(0), duration=np.zeros(0), pitch=np.zeros(0, np.int32), velocity=np.zeros(0, np.int32)
        )
    onset, duration, pitch, velocity = zip(*notes)
    return NoteArrays(
        onset=np.asarray(onset, np.float64),
        duration=np.asarray(duration, np.float64),
        pitch=np.asarray(pitch, np.int32),
        velocity=np.asarray(velocity, np.int32),
    )


def _sec_to_tick_fn(tempo_map: List[Tuple[float, int]], ppq: int):
    """Piecewise tick quantizer for a ``[(onset_sec, tempo_us), ...]`` map.

    Tempo-change ticks are laid on the same piecewise grid, so a file
    written with this quantizer parses back (via :func:`read_smf`'s
    tick→second conversion) to the original seconds up to ±½ tick.
    """
    anchors_s = [0.0]
    anchors_t = [0]
    tempos = [tempo_map[0][1]]
    for s, us in tempo_map[1:]:
        dt = round((s - anchors_s[-1]) * ppq * 1e6 / tempos[-1])
        anchors_t.append(anchors_t[-1] + dt)
        anchors_s.append(s)
        tempos.append(us)

    def sec_to_tick(sec: float) -> int:
        i = int(np.searchsorted(anchors_s, sec, side="right")) - 1
        return anchors_t[i] + round((sec - anchors_s[i]) * ppq * 1e6 / tempos[i])

    return sec_to_tick, list(zip(anchors_t, tempos))


def _note_events(notes: NoteArrays, index, sec_to_tick) -> List[Tuple[int, int, int, int]]:
    events: List[Tuple[int, int, int, int]] = []  # (tick, on, pitch, vel)
    for j in index:
        start = sec_to_tick(float(notes.onset[j]))
        end = sec_to_tick(float(notes.onset[j] + notes.duration[j]))
        end = max(end, start + 1)  # at least one tick long
        events.append((start, 1, int(notes.pitch[j]), int(notes.velocity[j])))
        events.append((end, 0, int(notes.pitch[j]), 0))
    events.sort(key=lambda e: (e[0], e[1]))  # offs before ons at the same tick
    return events


def _track_chunk(items: List[Tuple[int, bytes]]) -> bytes:
    """Serialize (tick, event-bytes) items (pre-sorted) as one MTrk chunk."""
    body = bytearray()
    last_tick = 0
    for tick, payload in items:
        body += _write_varlen(tick - last_tick) + payload
        last_tick = tick
    body += _write_varlen(0) + bytes([0xFF, 0x2F, 0x00])  # end of track
    return b"MTrk" + struct.pack(">I", len(body)) + bytes(body)


def write_smf(
    notes: NoteArrays,
    path: str,
    *,
    tempo_us: int = DEFAULT_TEMPO_US,
    ppq: int = 480,
    tempo_map: List[Tuple[float, int]] = None,
    tracks=None,
) -> None:
    """Write note arrays as an SMF file.

    Default: single-track format 0 at a constant tempo (the dataset
    factory / parser-test path). Extensions:

    tempo_map : ``[(onset_sec, tempo_us), ...]``
        Tempo changes; note ticks are quantized piecewise so the file
        parses back to the same seconds (±½ tick). An entry at 0.0 s
        overrides ``tempo_us``.
    tracks : int array [N], optional
        Per-note track assignment → a format-1 file with a conductor
        track (track 0: all tempo events) and one note track per
        distinct value, in ascending order.
    """
    if tempo_map is None:
        tempo_map = [(0.0, tempo_us)]
    tempo_map = sorted(tempo_map)
    if tempo_map[0][0] > 0.0:
        tempo_map.insert(0, (0.0, tempo_us))
    sec_to_tick, tempo_ticks = _sec_to_tick_fn(tempo_map, ppq)
    tempo_items = [
        (tick, bytes([0xFF, 0x51, 0x03]) + int(us).to_bytes(3, "big")) for tick, us in tempo_ticks
    ]

    def note_items(index):
        return [
            (tick, bytes([0x90 if on else 0x80, pitch & 0x7F, vel & 0x7F]))
            for tick, on, pitch, vel in _note_events(notes, index, sec_to_tick)
        ]

    if tracks is None:
        # format 0: one track, tempo events merged in (stable: tempo first)
        items = sorted(tempo_items + note_items(range(len(notes))), key=lambda it: (it[0], it[1][0] != 0xFF))
        chunks = [_track_chunk(items)]
        fmt = 0
    else:
        tracks = np.asarray(tracks)
        if len(tracks) != len(notes):
            raise ValueError(f"tracks has {len(tracks)} entries for {len(notes)} notes")
        chunks = [_track_chunk(tempo_items)]  # conductor track
        for t in np.unique(tracks):
            chunks.append(_track_chunk(note_items(np.nonzero(tracks == t)[0])))
        fmt = 1

    with open(path, "wb") as f:
        f.write(b"MThd" + struct.pack(">IHHH", 6, fmt, len(chunks), ppq))
        for chunk in chunks:
            f.write(chunk)

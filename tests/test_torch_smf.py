"""The port's Standard MIDI File readers against the JAX package's
``midi/smf.py`` ``parse_smf_bytes``: the port's Python copy
(``midi_vae_tpu_torch/midi/smf.py``) and its native C++ parser
(``native/midiparse.cc`` through ``native/midiparse.py``), array for
array and bit for bit, on generated files:

- note arrays written by the JAX package's ``write_smf``: format 0 and 1
  (notes spread over tracks under a conductor track), tempo maps, several
  resolutions, overlapping notes of one pitch;
- raw byte streams: format 0 and 1, several tracks, running status,
  note-on with velocity 0, note-off with a velocity, every channel
  message, tempo, time-signature and text meta events, SysEx (``F0`` and
  ``F7``), unterminated notes, PPQ, zero and SMPTE divisions;
- those files cut, grown or with a byte changed: every reader raises
  ``ValueError`` or all read the same notes.
"""

import struct

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from midi_vae_tpu.midi.smf import NoteArrays as JaxNoteArrays
from midi_vae_tpu.midi.smf import parse_smf_bytes as jax_parse_smf_bytes
from midi_vae_tpu.midi.smf import write_smf as jax_write_smf
from midi_vae_tpu_torch.midi.smf import parse_smf_bytes
from midi_vae_tpu_torch.native.midiparse import parse_midi_native
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

FIELDS = ("onset", "duration", "pitch", "velocity")


@pytest.fixture(scope="module")
def mid_path(tmp_path_factory):
    return str(tmp_path_factory.mktemp("smf") / "file.mid")


def read_all(data: bytes, path: str) -> list:
    """The JAX parser's notes, then the port's Python and native parsers';
    ``None`` where a reader raises ``ValueError``."""
    with open(path, "wb") as f:
        f.write(data)
    out = []
    for parse in (jax_parse_smf_bytes, parse_smf_bytes, lambda _: parse_midi_native(path)):
        try:
            out.append(parse(data))
        except ValueError:
            out.append(None)
    return out


def assert_all_read_alike(data: bytes, path: str):
    want, *ours = read_all(data, path)
    for got in ours:
        if want is None:
            assert got is None
            continue
        assert got is not None
        for field in FIELDS:
            a, b = getattr(got, field), getattr(want, field)
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), field
    return want


# ------------------------------------------------------ write_smf's files


@st.composite
def written_files(draw):
    seed = draw(st.integers(0, 2**32 - 1))
    rng = np.random.default_rng(seed)
    n = draw(st.integers(0, 40))
    onset = np.round(rng.uniform(0, 20, n), draw(st.sampled_from([2, 6])))
    duration = rng.uniform(0.01, 3, n)
    pitch = rng.integers(0, 128, n).astype(np.int32)
    if n >= 3 and draw(st.booleans()):  # overlapping notes of one pitch
        pitch[:3] = 60
        onset[:3] = [1.0, 1.5, 1.25]
    velocity = rng.integers(1, 128, n).astype(np.int32)
    notes = JaxNoteArrays(onset=onset, duration=duration, pitch=pitch, velocity=velocity)
    tempo_map = None
    if draw(st.booleans()):
        times = sorted(rng.uniform(0, 15, draw(st.integers(1, 5))).tolist())
        tempo_map = [(float(t), int(us)) for t, us in zip(times, rng.integers(200_000, 1_500_000, len(times)))]
    tracks = rng.integers(0, draw(st.integers(1, 4)), n) if draw(st.booleans()) else None
    return notes, dict(ppq=draw(st.sampled_from([24, 96, 480, 960])), tempo_us=int(rng.integers(250_000, 1_000_000)),
                       tempo_map=tempo_map, tracks=tracks)


@settings(max_examples=100, deadline=None, derandomize=True, database=None)
@given(case=written_files())
def test_files_write_smf_writes_read_alike(mid_path, case):
    notes, kwargs = case
    jax_write_smf(notes, mid_path, **kwargs)
    with open(mid_path, "rb") as f:
        data = f.read()
    want = assert_all_read_alike(data, mid_path)
    assert want is not None and len(want) == len(notes)


# ---------------------------------------------------------- raw byte streams


def varlen(value: int) -> bytes:
    out = [value & 0x7F]
    value >>= 7
    while value:
        out.append(0x80 | (value & 0x7F))
        value >>= 7
    return bytes(reversed(out))


PITCHES = st.one_of(st.integers(58, 61), st.integers(0, 127))  # few pitches: notes overlap
EVENTS = st.one_of(
    st.tuples(st.just("on"), st.integers(0, 15), PITCHES, st.integers(0, 127)),  # velocity 0 is an off
    st.tuples(st.just("off"), st.integers(0, 15), PITCHES, st.integers(0, 127)),
    st.tuples(st.just("two"), st.sampled_from([0xA0, 0xB0, 0xE0]), st.integers(0, 127), st.integers(0, 127)),
    st.tuples(st.just("one"), st.sampled_from([0xC0, 0xD0]), st.integers(0, 127)),
    st.tuples(st.just("tempo"), st.integers(1, 2**24 - 1)),
    st.tuples(st.just("meta"), st.sampled_from([0x58, 0x01, 0x03, 0x59, 0x51, 0x7F]), st.binary(max_size=6)),
    st.tuples(st.just("sysex"), st.sampled_from([0xF0, 0xF7]), st.binary(max_size=8)),
)


@st.composite
def tracks(draw) -> bytes:
    body = bytearray()
    running = None
    for event in draw(st.lists(EVENTS, max_size=30)):
        body += varlen(draw(st.one_of(st.integers(0, 200), st.integers(0, 2**28 - 1))))
        kind = event[0]
        if kind in ("on", "off", "two", "one"):
            status = (0x90 if kind == "on" else 0x80) | event[1] if kind in ("on", "off") else event[1]
            if status != running or not draw(st.booleans()):  # running status: the status byte left out
                body.append(status)
            running = status
            body += bytes(event[2:])
        elif kind == "tempo":
            body += b"\xff\x51\x03" + event[1].to_bytes(3, "big")
        elif kind == "meta":
            body += bytes([0xFF, event[1]]) + varlen(len(event[2])) + event[2]
        else:
            body += bytes([event[1]]) + varlen(len(event[2])) + event[2]
    if draw(st.booleans()):
        body += b"\x00\xff\x2f\x00"
    return b"MTrk" + struct.pack(">I", len(body)) + bytes(body)


@st.composite
def raw_files(draw) -> bytes:
    fmt = draw(st.sampled_from([0, 1]))
    chunks = [draw(tracks()) for _ in range(1 if fmt == 0 else draw(st.integers(1, 4)))]
    division = draw(st.sampled_from([96, 480, 1, 0, 0xE728, 0xE250, 0xE764]))  # PPQ, none, SMPTE 24/30/25 fps
    return b"MThd" + struct.pack(">IHHH", 6, fmt, len(chunks), division) + b"".join(chunks)


@settings(max_examples=150, deadline=None, derandomize=True, database=None)
@given(data=raw_files())
def test_raw_files_read_alike(mid_path, data):
    assert assert_all_read_alike(data, mid_path) is not None


@settings(max_examples=150, deadline=None, derandomize=True, database=None)
@given(data=raw_files(), at=st.integers(0, 2**16), byte=st.integers(0, 255),
       kind=st.sampled_from(["cut", "grow", "byte", "header_length", "track_count"]))
def test_damaged_files_raise_or_read_alike(mid_path, data, at, byte, kind):
    data = bytearray(data)
    if kind == "cut":
        data = data[: at % len(data)]
    elif kind == "grow":
        data[at % len(data) : at % len(data)] = bytes([byte])
    elif kind == "byte":
        data[at % len(data)] = byte
    elif kind == "header_length":
        data[4:8] = struct.pack(">I", byte % 12)
    else:
        data[10:12] = struct.pack(">H", byte % 6)
    assert_all_read_alike(bytes(data), mid_path)


REFUSED = {
    "not_midi": b"RIFF\x00\x00\x00\x00WAVE" + b"\x00" * 8,
    "short_header": b"MThd\x00\x00\x00\x04\x00\x00\x00\x01\x00\x60",
    "missing_track": b"MThd\x00\x00\x00\x06\x00\x00\x00\x01\x00\x60",
    "running_status_first": b"MThd\x00\x00\x00\x06\x00\x00\x00\x01\x00\x60MTrk\x00\x00\x00\x03\x00\x3c\x40",
    "varlen_over_4_bytes": b"MThd\x00\x00\x00\x06\x00\x00\x00\x01\x00\x60MTrk\x00\x00\x00\x08\xff\xff\xff\xff\x7f\x90"
                           b"\x3c\x40",
    "smpte_zero_ticks": b"MThd\x00\x00\x00\x06\x00\x00\x00\x01\xe7\x00MTrk\x00\x00\x00\x04\x00\xff\x2f\x00",
    "data_byte_high_bit": b"MThd\x00\x00\x00\x06\x00\x00\x00\x01\x00\x60MTrk\x00\x00\x00\x04\x00\x90\x80\x40",
    "system_common": b"MThd\x00\x00\x00\x06\x00\x00\x00\x01\x00\x60MTrk\x00\x00\x00\x03\x00\xf2\x00",
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_files_every_reader_refuses(mid_path, name):
    assert read_all(REFUSED[name], mid_path) == [None, None, None]

"""ctypes bindings of the native SMF parser (``native/midiparse.cc``).

:func:`parse_midi_native` returns the :class:`~midi_vae_tpu_torch.midi.smf.NoteArrays`
of the pure-Python oracle ``midi/smf.py``; callers go through
``midi/parse.py`` ``parse_midi``. The library is built with g++ at first
use (``native/_build.py``); a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from midi_vae_tpu_torch.native._build import library


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = library("midiparse")
    lib.midi_open.restype = ctypes.c_void_p
    lib.midi_open.argtypes = [ctypes.c_char_p]
    lib.midi_n_notes.restype = ctypes.c_long
    lib.midi_n_notes.argtypes = [ctypes.c_void_p]
    lib.midi_get_notes.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.midi_close.argtypes = [ctypes.c_void_p]
    return lib


def parse_midi_native(path: str):
    """Parse an SMF file with the C++ parser; ``ValueError`` when it cannot."""
    from midi_vae_tpu_torch.midi.smf import NoteArrays

    lib = _lib()
    handle = lib.midi_open(path.encode())
    if not handle:
        raise ValueError(f"cannot parse MIDI file: {path}")
    try:
        n = lib.midi_n_notes(handle)
        onset = np.empty(n, np.float64)
        duration = np.empty(n, np.float64)
        pitch = np.empty(n, np.int32)
        velocity = np.empty(n, np.int32)
        if n:
            lib.midi_get_notes(
                handle,
                onset.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                duration.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                pitch.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                velocity.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            )
        return NoteArrays(onset=onset, duration=duration, pitch=pitch, velocity=velocity)
    finally:
        lib.midi_close(handle)

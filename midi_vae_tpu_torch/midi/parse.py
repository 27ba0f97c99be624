"""MIDI parsing entry point (counterpart of ``midi_vae_tpu/midi/parse.py``).

``parse_midi`` parses with the native C++ parser (``native/midiparse.cc``,
built with g++ at first use; a failed build raises) unless the caller
passes ``prefer_native=False``, which selects the pure-Python reader of
``midi/smf.py``, the parser's oracle. Both produce the same
:class:`~midi_vae_tpu_torch.midi.smf.NoteArrays`.
"""

from __future__ import annotations

from midi_vae_tpu_torch.midi.smf import NoteArrays, read_smf


def parse_midi(path: str, *, prefer_native: bool = True) -> NoteArrays:
    """Parse a Standard MIDI File into flat note-event arrays."""
    if prefer_native:
        from midi_vae_tpu_torch.native.midiparse import parse_midi_native

        return parse_midi_native(path)
    return read_smf(path)

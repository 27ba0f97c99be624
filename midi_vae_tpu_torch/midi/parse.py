"""MIDI parsing entry point (counterpart of ``midi_vae_tpu/midi/parse.py``).

The port parses with the pure-Python reader of ``midi/smf.py``; the JAX
package's native C++ parser is not ported yet (ROADMAP Queue 1 item 9).
Both produce the same :class:`~midi_vae_tpu_torch.midi.smf.NoteArrays`.
"""

from __future__ import annotations

from midi_vae_tpu_torch.midi.smf import NoteArrays, read_smf


def parse_midi(path: str) -> NoteArrays:
    """Parse a Standard MIDI File into flat note-event arrays."""
    return read_smf(path)

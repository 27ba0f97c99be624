"""See the module docstrings; counterpart of ``midi_vae_tpu.midi``."""

from midi_vae_tpu_torch.midi.smf import NoteArrays, read_smf, write_smf  # noqa: F401

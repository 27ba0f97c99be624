"""See the module docstrings; counterpart of ``midi_vae_tpu.cli``."""

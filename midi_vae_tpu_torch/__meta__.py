"""Package metadata. Both packages ship in one distribution (``pyproject.toml``
``[project]``), so the port carries the JAX package's name and version."""

name = "midi-vae-tpu"
version = "0.1.0"
description = "PyTorch/CUDA port of midi_vae_tpu, the MIDI piano-roll VAE framework, for NVIDIA Hopper"

__version__ = version

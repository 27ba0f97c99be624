"""See the module docstrings; counterpart of ``midi_vae_tpu.interop``."""

from midi_vae_tpu_torch.interop.torch_reference import import_reference_state_dict  # noqa: F401

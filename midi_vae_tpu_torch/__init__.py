"""PyTorch/CUDA port of ``midi_vae_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its layout
(``core``, ``ops``, ``losses``, ``models``, ``train``, ``data``,
``parallel``) module by module, plus ``interop/from_jax.py``, the weight bridge its parity tests
use. It imports ``torch`` and never JAX or the JAX package. Entry points
run on the GPU unless the caller passes ``device="cpu"``.
"""

from midi_vae_tpu_torch.__meta__ import __version__  # noqa: F401

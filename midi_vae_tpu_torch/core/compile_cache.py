"""Persistent compilation cache for the port (counterpart of
``midi_vae_tpu/core/compile_cache.py``), behind ``--compilation-cache DIR``
on the train CLI and the server.

What the port compiles is its kernels, so DIR holds every build
directory a process writes:

- ``DIR/kernels``: the CUDA C++ libraries (``ops/cuda_lib.py``
  ``build_dir``, through ``$MIDI_VAE_TORCH_KERNEL_DIR``) and, under
  ``DIR/kernels/host``, the host C++ libraries (``native/_build.py``);
- ``DIR/triton``: Triton's cache (``$TRITON_CACHE_DIR``);
- ``DIR/inductor``: inductor's cache (``$TORCHINDUCTOR_CACHE_DIR``), which
  the exported artifact's compiled programs use.

Call it before the first build: each builder reads its directory when it
builds. A second process given the same DIR then builds nothing. Entries
are keyed by their sources and flags (the kernels) or by Triton's and
inductor's own keys, and written atomically, so processes can share DIR.
"""

from __future__ import annotations

import os

from midi_vae_tpu_torch.ops.cuda_lib import BUILD_DIR_ENV


def enable_compilation_cache(cache_dir: str) -> str:
    """Point every build directory of this process into ``cache_dir``;
    returns its absolute path."""
    cache_dir = os.path.abspath(os.path.expanduser(cache_dir))
    for env, sub in ((BUILD_DIR_ENV, "kernels"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.makedirs(os.path.join(cache_dir, sub), exist_ok=True)
        os.environ[env] = os.path.join(cache_dir, sub)
    return cache_dir

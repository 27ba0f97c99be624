"""ctypes bindings of the port's zstd decoder and CRC32C (``native/zstd.cc``).

:func:`decompress` decodes every frame of a zstd stream (RFC 8878) and
raises ``ValueError`` with the decoder's reason when the input is corrupt,
truncated or needs a dictionary; :func:`crc32c` is the Castagnoli CRC the
OCDBT files of a JAX Orbax checkpoint end in. The library is built with
g++ at first use (``native/_build.py``); a failed build raises, and
nothing falls back to another decoder.
"""

from __future__ import annotations

import ctypes
import functools

from midi_vae_tpu_torch.native._build import library

_ERR_BYTES = 512


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = library("zstd")
    lib.zstd_decompress.restype = ctypes.c_int
    lib.zstd_decompress.argtypes = [
        ctypes.c_char_p,
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_char_p,
        ctypes.c_size_t,
    ]
    lib.zstd_free.restype = None
    lib.zstd_free.argtypes = [ctypes.c_void_p]
    lib.crc32c.restype = ctypes.c_uint32
    lib.crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    return lib


def decompress(data) -> bytes:
    """The content of every frame of ``data`` (bytes-like), concatenated."""
    data = bytes(data)
    lib = _lib()
    out = ctypes.c_void_p()
    size = ctypes.c_size_t()
    err = ctypes.create_string_buffer(_ERR_BYTES)
    if lib.zstd_decompress(data, len(data), ctypes.byref(out), ctypes.byref(size), err, _ERR_BYTES):
        raise ValueError(f"zstd: {err.value.decode(errors='replace')}")
    try:
        return ctypes.string_at(out.value, size.value)
    finally:
        lib.zstd_free(out)


def crc32c(data) -> int:
    """CRC32C (Castagnoli) of ``data``."""
    data = bytes(data)
    return int(_lib().crc32c(data, len(data)))


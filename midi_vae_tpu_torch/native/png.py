"""The port's PNG decoder: chunks and zlib in Python, the scanline filters
in host C++ (``native/png.cc``, built with g++ at first use like the other
host libraries; a failed build raises).

:func:`decode_png` returns what ``np.asarray(PIL.Image.open(f)).astype(np.uint8)``
returns, so the image-folder datasets load the same without Pillow, which
the GPU machine does not have:

- greyscale at 1 bit gives 0/1, at 2 and 4 bits the value scaled to 8 bits
  (×85, ×17), at 16 bits the low byte (Pillow's 16-bit greyscale, cast);
- palette images give their indices (Pillow's ``P`` mode);
- RGB, RGBA and grey + alpha at 16 bits give each sample's high byte, and
  grey + alpha at 16 bits comes out as RGBA (L, L, L, A), as Pillow opens it;
- a ``tRNS`` chunk changes nothing; Adam7 interlacing is undone.

Greyscale and palette images are [H, W], the others [H, W, C]. A bad
signature, a CRC that does not match, a missing or malformed ``IHDR``,
``PLTE`` or ``IEND``, a filter type outside 0–4, or image data that is
corrupt, short or long raises ``ValueError``.
"""

from __future__ import annotations

import ctypes
import functools
import struct
import zlib

import numpy as np

from midi_vae_tpu_torch.native._build import library

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type → (channels, allowed bit depths)
_COLOUR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7 passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = library("png")
    lib.png_unfilter.restype = ctypes.c_int64
    lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
    return lib


def _chunks(data: bytes):
    """(type, body) of every chunk up to and including ``IEND``, CRCs checked."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    at = 8
    while True:
        if at + 12 > len(data):
            raise ValueError("truncated PNG: the file ends before IEND")
        length, kind = struct.unpack(">I4s", data[at:at + 8])
        end = at + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"truncated PNG: chunk {kind!r} runs past the end of the file")
        body = data[at + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r} at byte {at}: CRC mismatch")
        yield kind, body
        if kind == b"IEND":
            return
        at = end + 4


def _passes(width: int, height: int, interlaced: bool):
    """(x0, y0, dx, dy, pass width, pass height) of each non-empty pass."""
    for x0, y0, dx, dy in _ADAM7 if interlaced else ((0, 0, 1, 1),):
        pw, ph = (width - x0 + dx - 1) // dx, (height - y0 + dy - 1) // dy
        if pw > 0 and ph > 0:
            yield x0, y0, dx, dy, pw, ph


def _samples(rows: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """Unfiltered scanlines [h, stride] → samples [h, width, channels]
    (uint8, or uint16 at 16 bits)."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, width, channels)
    if depth == 8:
        return rows.reshape(h, width, channels)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)  # most significant bits first
    values = (rows[:, :, None] >> shifts) & np.uint8((1 << depth) - 1)
    return values.reshape(h, -1)[:, :width, None]


def decode_png(data) -> np.ndarray:
    """A PNG file's bytes → the uint8 array Pillow's ``np.asarray`` gives
    (see the module docstring)."""
    data = bytes(data)
    chunks = _chunks(data)
    kind, ihdr = next(chunks)
    if kind != b"IHDR" or len(ihdr) != 13:
        raise ValueError("PNG does not start with a 13-byte IHDR chunk")
    width, height, depth, colour, compression, filtering, interlace = struct.unpack(">IIBBBBB", ihdr)
    if colour not in _COLOUR_TYPES or depth not in _COLOUR_TYPES[colour][1]:
        raise ValueError(f"PNG colour type {colour} with bit depth {depth} is not valid")
    if width == 0 or height == 0 or compression != 0 or filtering != 0 or interlace not in (0, 1):
        raise ValueError(f"PNG IHDR not valid: {width}x{height}, compression {compression}, filter {filtering}, "
                         f"interlace {interlace}")
    channels = _COLOUR_TYPES[colour][0]
    idat, palette = [], None
    for kind, body in chunks:
        if kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            if len(body) % 3 or not 0 < len(body) <= 768:
                raise ValueError(f"PNG PLTE of {len(body)} bytes")
            palette = body
    if colour == 3 and palette is None:
        raise ValueError("palette PNG without a PLTE chunk")

    bits = channels * depth
    passes = list(_passes(width, height, interlace == 1))
    sizes = [ph * (1 + (pw * bits + 7) // 8) for *_, pw, ph in passes]
    expected = sum(sizes)
    inflater = zlib.decompressobj()
    try:
        raw = inflater.decompress(b"".join(idat), expected + 1)
    except zlib.error as e:
        raise ValueError(f"PNG image data is corrupt: {e}") from e
    if len(raw) != expected or not inflater.eof:
        raise ValueError(f"PNG image data holds {len(raw)}{'' if inflater.eof else '+ (unterminated)'} bytes, "
                         f"the header needs {expected}")

    buf = np.frombuffer(raw, np.uint8)
    lib = _lib()
    samples = np.zeros((height, width, channels), np.uint16 if depth == 16 else np.uint8)
    at = 0
    for (x0, y0, dx, dy, pw, ph), size in zip(passes, sizes):
        stride = size // ph - 1
        filtered = np.ascontiguousarray(buf[at:at + size])
        rows = np.empty((ph, stride), np.uint8)
        bad = lib.png_unfilter(filtered.ctypes.data, rows.ctypes.data, ph, stride, max(1, bits // 8))
        if bad >= 0:
            raise ValueError(f"PNG row {bad} of pass at ({x0}, {y0}) has filter type {filtered[bad * (stride + 1)]}")
        samples[y0::dy, x0::dx] = _samples(rows, pw, channels, depth)
        at += size

    if colour == 0:  # greyscale: Pillow's "1", "L" (2 and 4 bits scaled) and "I;16" modes
        if depth == 16:
            return (samples[..., 0] & 0xFF).astype(np.uint8)
        return samples[..., 0] * np.uint8({1: 1, 2: 85, 4: 17, 8: 1}[depth])
    if colour == 3:
        return samples[..., 0]
    if depth == 16:
        samples = (samples >> 8).astype(np.uint8)
    if colour == 4 and depth == 16:  # Pillow opens 16-bit grey + alpha as RGBA
        return samples[..., [0, 0, 0, 1]]
    return samples


def read_png(path: str) -> np.ndarray:
    """:func:`decode_png` of a file."""
    with open(path, "rb") as f:
        return decode_png(f.read())

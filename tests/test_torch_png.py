"""The port's PNG decoder (``midi_vae_tpu_torch/native/png.py`` over the
scanline filters of ``native/png.cc``) against Pillow, on the CPU.

Pillow is the oracle: the decoder must give ``np.asarray(Image.open(f))
.astype(np.uint8)`` for every colour type (0, 2, 3, 4, 6) at each of its bit
depths (1, 2, 4, 8, 16), with and without Adam7 interlacing and ``tRNS``.
Pillow writes only some of these kinds (8-bit grey, grey + alpha, RGB and
RGBA, 1-bit grey, 16-bit grey, palettes of 1, 2, 4 and 8 bits), never
interlaced, and always with its own choice of filters; so the files come from
both Pillow and this file's own encoder (every kind, each row under a chosen
filter type). A hypothesis case draws sizes, kinds and filters. Corrupt,
truncated and bad-CRC files raise. ``load_image_folder`` with Pillow blocked
equals the JAX package's loader (Pillow) on the same tree, and the other
extensions raise naming Pillow when it is missing.
"""

import io
import os
import shutil
import struct
import sys
import zlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from midi_vae_tpu.data.sources import load_image_folder as jax_load_image_folder
from midi_vae_tpu_torch.data.sources import load_image_folder
from midi_vae_tpu_torch.native.png import decode_png, read_png
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (4, 16),
         (6, 8), (6, 16)]
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def _row_bytes(samples: np.ndarray, depth: int) -> list:
    """Samples [h, w, c] → each row's packed bytes."""
    if depth == 16:
        return [r.astype(">u2").tobytes() for r in samples]
    if depth == 8:
        return [r.astype(np.uint8).tobytes() for r in samples]
    shifts = np.arange(depth - 1, -1, -1)
    return [np.packbits(((r[:, 0, None].astype(np.uint8) >> shifts) & 1).reshape(-1)).tobytes() for r in samples]


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter(row: bytes, prior: bytes, kind: int, bpp: int) -> bytes:
    out = bytearray([kind])
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[kind]
        out.append((x - pred) & 0xFF)
    return bytes(out)


def encode_png(samples: np.ndarray, depth: int, colour: int, *, interlace: int = 0, filters=(0,),
               palette: bytes = b"", trns: bytes = b"", idat_splits: int = 1) -> bytes:
    """A PNG of ``samples`` [h, w, c] (values within the bit depth), each
    scanline under ``filters[row % len(filters)]``."""
    h, w = samples.shape[:2]
    bpp = max(1, CHANNELS[colour] * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    raw, n = b"", 0
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.shape[0] == 0 or sub.shape[1] == 0:
            continue
        rows = _row_bytes(sub, depth)
        prior = bytes(len(rows[0]))
        for row in rows:
            raw += _filter(row, prior, filters[n % len(filters)], bpp)
            prior, n = row, n + 1
    data = zlib.compress(raw)
    cuts = np.linspace(0, len(data), idat_splits + 1).astype(int)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace))
    if palette:
        out += _chunk(b"PLTE", palette)
    if trns:
        out += _chunk(b"tRNS", trns)
    out += b"".join(_chunk(b"IDAT", data[a:b]) for a, b in zip(cuts[:-1], cuts[1:]))
    return out + _chunk(b"IEND", b"")


def _kind_image(rng, colour: int, depth: int, h: int, w: int, trns: bool):
    """(samples, palette, tRNS) of a random image of one kind."""
    top = (1 << depth) - 1
    samples = rng.integers(0, top + 1, (h, w, CHANNELS[colour]), dtype=np.uint32)
    palette = b""
    if colour == 3:
        entries = min(1 << depth, 256)
        samples %= entries
        palette = rng.integers(0, 256, 3 * entries, dtype=np.uint8).tobytes()
    t = b""
    if trns:
        if colour == 0:
            t = struct.pack(">H", int(samples[0, 0, 0]))
        elif colour == 2:
            t = struct.pack(">HHH", *map(int, samples[0, 0]))
        elif colour == 3:
            t = bytes(rng.integers(0, 256, len(palette) // 3, dtype=np.uint8))
    return samples, palette, t


def _pillow(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im).astype(np.uint8)


def _assert_as_pillow(data: bytes):
    got, want = decode_png(data), _pillow(data)
    assert got.dtype == np.uint8 and got.shape == want.shape and np.array_equal(got, want)


# every kind, plain and interlaced, with and without tRNS (which an alpha channel excludes)
CASES = [(c, d, i, t) for c, d in KINDS for i in (0, 1) for t in (False, True) if not (t and c in (4, 6))]


@pytest.mark.parametrize("colour,depth,interlace,trns", CASES,
                         ids=[f"type{c}_{d}bit{'_adam7' if i else ''}{'_trns' if t else ''}" for c, d, i, t in CASES])
def test_every_kind_decodes_as_pillow_does(colour, depth, interlace, trns):
    rng = np.random.default_rng(colour * 100 + depth * 10 + interlace * 2 + trns)
    samples, palette, t = _kind_image(rng, colour, depth, 13, 11, trns)
    _assert_as_pillow(encode_png(samples, depth, colour, interlace=interlace, filters=(0, 1, 2, 3, 4),
                                 palette=palette, trns=t, idat_splits=3))


@pytest.mark.parametrize("mode,kw", [
    ("L", {}), ("L", {"optimize": True}), ("LA", {}), ("RGB", {}), ("RGBA", {}), ("1", {}), ("I;16", {}),
    ("P", {"bits": 1}), ("P", {"bits": 2}), ("P", {"bits": 4}), ("P", {}), ("P", {"transparency": 3}),
    ("L", {"transparency": 7}), ("RGB", {"transparency": (1, 2, 3)}),
], ids=lambda v: str(v))
def test_files_pillow_writes_decode_as_pillow_reads_them(mode, kw):
    rng = np.random.default_rng(len(mode) + len(kw))
    if mode == "1":
        im = Image.fromarray(rng.integers(0, 2, (17, 23)).astype(bool))
    elif mode == "I;16":
        im = Image.fromarray(rng.integers(0, 65536, (17, 23), dtype=np.uint16))
    elif mode == "P":
        colours = 1 << kw.get("bits", 8)
        im = Image.fromarray(rng.integers(0, colours, (17, 23), dtype=np.uint8), mode="L").convert("P")
        im.putpalette(rng.integers(0, 256, 3 * colours, dtype=np.uint8).tobytes())
    else:
        shape = (17, 23) if mode == "L" else (17, 23, len(mode))
        im = Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8), mode=mode)
    buf = io.BytesIO()
    im.save(buf, format="PNG", **kw)
    _assert_as_pillow(buf.getvalue())


@settings(max_examples=60, deadline=None)
@given(kind=st.sampled_from(KINDS), h=st.integers(1, 24), w=st.integers(1, 24), interlace=st.integers(0, 1),
       filters=st.lists(st.integers(0, 4), min_size=1, max_size=5), seed=st.integers(0, 2**32 - 1))
def test_random_sizes_and_filters_decode_as_pillow(kind, h, w, interlace, filters, seed):
    colour, depth = kind
    samples, palette, _ = _kind_image(np.random.default_rng(seed), colour, depth, h, w, False)
    _assert_as_pillow(encode_png(samples, depth, colour, interlace=interlace, filters=tuple(filters),
                                 palette=palette))


def _good() -> bytes:
    samples, _, _ = _kind_image(np.random.default_rng(0), 0, 8, 16, 16, False)
    return encode_png(samples, 8, 0, filters=(1, 4))


def _rechunk(data: bytes, kind: bytes, body: bytes) -> bytes:
    """``data`` with the body of its first ``kind`` chunk replaced (CRC made to match)."""
    at = 8
    while True:
        length, k = struct.unpack(">I4s", data[at:at + 8])
        if k == kind:
            return data[:at] + _chunk(kind, body) + data[at + 12 + length:]
        at += 12 + length


def _idat(data: bytes) -> bytes:
    at = data.index(b"IDAT") - 4
    return data[at + 8:at + 8 + struct.unpack(">I", data[at:at + 4])[0]]


@pytest.mark.parametrize("case", [
    "signature", "crc", "flipped_byte", "truncated_end", "truncated_mid", "no_iend", "bad_filter", "short_data",
    "long_data", "corrupt_zlib", "unterminated_zlib", "bad_depth", "palette_without_plte",
])
def test_corrupt_or_truncated_files_raise(case):
    good = _good()
    raw = zlib.decompress(_idat(good))
    if case == "signature":
        bad = b"\x89PNX" + good[4:]
    elif case == "crc":
        bad = good[:29] + bytes([good[29] ^ 1]) + good[30:]  # the IHDR CRC
    elif case == "flipped_byte":
        at = good.index(b"IDAT") + 10
        bad = good[:at] + bytes([good[at] ^ 0x40]) + good[at + 1:]
    elif case == "truncated_end":
        bad = good[:-5]
    elif case == "truncated_mid":
        bad = good[:len(good) // 2]
    elif case == "no_iend":
        bad = good[:-12]
    elif case == "bad_filter":
        bad = _rechunk(good, b"IDAT", zlib.compress(bytes([7]) + raw[1:]))
    elif case == "short_data":
        bad = _rechunk(good, b"IDAT", zlib.compress(raw[:-17]))
    elif case == "long_data":
        bad = _rechunk(good, b"IDAT", zlib.compress(raw + bytes(17)))
    elif case == "corrupt_zlib":
        bad = _rechunk(good, b"IDAT", b"\x78\x9c\xff\xff" + zlib.compress(raw)[4:])
    elif case == "unterminated_zlib":
        bad = _rechunk(good, b"IDAT", zlib.compress(raw)[:-4])
    elif case == "bad_depth":
        bad = _rechunk(good, b"IHDR", struct.pack(">IIBBBBB", 16, 16, 4, 2, 0, 0, 0))
    else:
        bad = _rechunk(good, b"IHDR", struct.pack(">IIBBBBB", 16, 16, 8, 3, 0, 0, 0))
    with pytest.raises(ValueError):
        decode_png(bad)


def _write_tree(root, rng):
    """Two classes of 12×10 images, each PNG kind that loads as [12, 10, 1]
    (grey at every depth, palettes, interlaced, tRNS) beside Pillow-written ones."""
    os.makedirs(root)
    for ci, cls in enumerate(("a_cls", "b_cls")):
        os.makedirs(os.path.join(root, cls))
        for i, (colour, depth) in enumerate([(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (3, 2), (3, 8)]):
            samples, palette, t = _kind_image(rng, colour, depth, 12, 10, trns=bool(i % 2))
            data = encode_png(samples, depth, colour, interlace=(i + ci) % 2, filters=(i % 5, 4, 1),
                              palette=palette, trns=t)
            with open(os.path.join(root, cls, f"img_{i}.png"), "wb") as f:
                f.write(data)
        Image.fromarray(rng.integers(0, 256, (12, 10), dtype=np.uint8)).save(os.path.join(root, cls, "pil.PNG"))


def test_load_image_folder_without_pillow_equals_the_jax_loader_with_it(tmp_path, monkeypatch):
    root = str(tmp_path / "port")
    _write_tree(root, np.random.default_rng(3))
    shutil.copytree(root, str(tmp_path / "jax"))
    want = jax_load_image_folder(str(tmp_path / "jax"))
    monkeypatch.setitem(sys.modules, "PIL", None)
    got = load_image_folder(root)
    assert got.images.dtype == np.uint8 and got.images.shape == want.images.shape == (16, 12, 10, 1)
    assert np.array_equal(got.images, want.images)
    assert np.array_equal(got.labels, want.labels) and got.class_names == list(want.class_names)
    cached = load_image_folder(root)  # through the _cache.npz it wrote
    assert np.array_equal(cached.images, got.images)


def test_other_extensions_need_pillow_and_name_it(tmp_path, monkeypatch):
    root = tmp_path / "bmp"
    (root / "cls").mkdir(parents=True)
    img = np.random.default_rng(4).integers(0, 256, (6, 5), dtype=np.uint8)
    Image.fromarray(img).save(root / "cls" / "x.bmp")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        load_image_folder(str(root))
    monkeypatch.delitem(sys.modules, "PIL")
    assert np.array_equal(load_image_folder(str(root)).images[0, :, :, 0], img)


def test_read_png_reads_a_file(tmp_path):
    samples, _, _ = _kind_image(np.random.default_rng(5), 2, 8, 7, 9, False)
    path = tmp_path / "x.png"
    path.write_bytes(encode_png(samples, 8, 2, filters=(3,)))
    assert np.array_equal(read_png(str(path)), samples.astype(np.uint8))

"""The port's zstd decoder and CRC32C (``native/zstd.cc``), on the CPU.

Frames written by the ``zstandard`` package (the reference encoder, used
here only) decode to their input byte for byte: empty and one-byte
inputs, RLE and raw blocks, Huffman literals, text, levels −5 to 19 with
and without the content checksum and the content size, several frames
in a row with a skippable frame between, frames of many blocks, and
token streams whose matches use all three repeat offsets; plus a
hypothesis round trip. A flipped checksum, a truncated frame and a
frame that needs a dictionary raise with the reason. CRC32C is held
against the published check vectors (RFC 3720 B.4).
"""

import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from midi_vae_tpu_torch.native import zstd
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

zstandard = pytest.importorskip("zstandard")

_RNG = np.random.default_rng(0)
_TEXT = open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "README.md"), "rb").read()
INPUTS = {
    "empty": b"",
    "one_byte": b"\x07",
    "zeros_1mib": bytes(1 << 20),
    "random_300kb": _RNG.integers(0, 256, 300_000, dtype=np.uint8).tobytes(),
    "f32_normal": _RNG.normal(size=60_000).astype(np.float32).tobytes(),
    "text": _TEXT[:50_000],
    "text_600kb": (_TEXT * (600_000 // len(_TEXT) + 1))[:600_000],
}


def _compress(data: bytes, level: int = 3, checksum: bool = False, content_size: bool = True) -> bytes:
    return zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                    write_content_size=content_size).compress(data)


@pytest.mark.parametrize("checksum", [False, True], ids=["no_checksum", "checksum"])
@pytest.mark.parametrize("level", [-5, 1, 3, 19])
@pytest.mark.parametrize("name", list(INPUTS))
def test_decodes_what_zstandard_encodes(name, level, checksum):
    data = INPUTS[name]
    if level == 19 and len(data) > 100_000:
        data = data[:100_000]  # level 19 is slow to encode; the other levels cover the large inputs
    assert zstd.decompress(_compress(data, level, checksum)) == data


def test_frames_without_content_size_and_many_blocks():
    data = INPUTS["text_600kb"]
    frame = _compress(data, 3, checksum=True, content_size=False)
    assert len(data) > 4 * 128 * 1024
    assert zstd.decompress(frame) == data


def test_streamed_frame_of_many_blocks():
    data = INPUTS["f32_normal"] * 4
    cobj = zstandard.ZstdCompressor(level=1).compressobj()
    frame = b"".join(cobj.compress(data[i:i + 70_000]) for i in range(0, len(data), 70_000)) + cobj.flush()
    assert zstd.decompress(frame) == data


def test_concatenated_frames_and_a_skippable_frame():
    a, b = INPUTS["text"], INPUTS["f32_normal"][:10_000]
    skippable = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"hello"
    stream = _compress(a, 1) + skippable + _compress(b, 9, checksum=True) + _compress(b"", 3)
    assert zstd.decompress(stream) == a + b


def _token_stream(seed: int) -> bytes:
    """Words of a small random vocabulary in random order: matches at a few
    recurring distances, so the encoder reaches for all three repeat
    offsets (the swaps of RFC 8878 3.1.2.5 that plain text seldom shows)."""
    rng = np.random.default_rng(seed)
    vocab = [bytes(rng.integers(97, 123, int(rng.integers(3, 9)), dtype=np.uint8))
             for _ in range(int(rng.integers(2, 12)))]
    sep = bytes(rng.integers(0, 256, 1, dtype=np.uint8))
    return b"".join(vocab[t] + (sep if rng.random() < 0.3 else b"")
                    for t in rng.integers(0, len(vocab), int(rng.integers(200, 3000))))


@pytest.mark.parametrize("seed,level", [(1, 1), (3, 3), (5, 9), (11, 19), (14, 19), (43, 19)])
def test_token_streams_exercise_the_repeat_offsets(seed, level):
    data = _token_stream(seed)
    assert zstd.decompress(_compress(data, level)) == data


@settings(max_examples=60, deadline=None)
@given(data=st.binary(max_size=4000), level=st.integers(-3, 12), repeat=st.integers(1, 40), checksum=st.booleans())
def test_round_trip_of_generated_inputs(data, level, repeat, checksum):
    data = data * repeat  # repetition gives the match finder work
    assert zstd.decompress(_compress(data, level, checksum)) == data


def test_a_flipped_checksum_raises():
    frame = bytearray(_compress(INPUTS["text"], 3, checksum=True))
    frame[-1] ^= 0x01
    with pytest.raises(ValueError, match="checksum mismatch"):
        zstd.decompress(bytes(frame))


@pytest.mark.parametrize("keep", [0.0, 0.3, 0.9, -1])
def test_a_truncated_frame_raises(keep):
    frame = _compress(INPUTS["f32_normal"], 3, checksum=False, content_size=False)
    cut = len(frame) - 1 if keep == -1 else int(len(frame) * keep)
    with pytest.raises(ValueError, match="zstd: "):
        zstd.decompress(frame[:cut])


def test_a_wrong_content_size_raises():
    frame = bytearray(_compress(b"x" * 100, 3))
    assert frame[4] == 0x20  # single segment, one-byte content size
    frame[5] = 101  # the window of a single-segment frame is its content size: 101 still holds the block
    with pytest.raises(ValueError, match="frame content size 101 but 100 bytes decoded"):
        zstd.decompress(bytes(frame))


def test_a_dictionary_frame_raises():
    samples = [bytes(f"record {i} of {j}: value={i * j}", "ascii") * 3 for i in range(200) for j in range(3)]
    dictionary = zstandard.train_dictionary(1024, samples)
    frame = zstandard.ZstdCompressor(dict_data=dictionary).compress(samples[7])
    assert zstandard.get_frame_parameters(frame).dict_id == dictionary.dict_id() != 0
    with pytest.raises(ValueError, match="dictionary"):
        zstd.decompress(frame)


def test_not_a_frame_raises():
    with pytest.raises(ValueError, match="bad magic"):
        zstd.decompress(b"\x00" * 16)
    with pytest.raises(ValueError, match="empty input"):
        zstd.decompress(b"")


@pytest.mark.parametrize("data,want", [
    (b"123456789", 0xE3069283),
    (bytes(32), 0x8A9136AA),
    (b"\xff" * 32, 0x62A8AB43),
    (bytes(range(32)), 0x46DD794E),
    (bytes(range(31, -1, -1)), 0x113FDB5C),
    (b"", 0),
], ids=["check", "zeros", "ones", "ascending", "descending", "empty"])
def test_crc32c_vectors(data, want):
    assert zstd.crc32c(data) == want

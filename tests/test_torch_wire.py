"""The port's npy wire (``midi_vae_tpu_torch/serving/wire.py``, a copy of
``midi_vae_tpu/serving/wire.py``) against the JAX package's and against
``np.save``/``np.load``, on generated arrays: every dtype the server and
client send (bool, ints, uints, floats, complex, either byte order, fixed
strings), 0-d to 4-d, empty, C and Fortran order, npy versions 1.0 and
2.0. Each way round: port → JAX, JAX → port, port → ``np.load``,
``np.save`` → port, and the port's bytes equal the JAX package's.
Malformed bodies (cut, grown, bytes changed in the header, object dtypes,
a header that declares more than the body carries) raise ``ValueError``
in both, or parse to the same array in both.
"""

import io
import re

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from midi_vae_tpu.serving import wire as jax_wire
from midi_vae_tpu_torch.serving import wire
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

DTYPES = st.one_of(hnp.boolean_dtypes(), hnp.integer_dtypes(endianness="="), hnp.unsigned_integer_dtypes(),
                   hnp.floating_dtypes(endianness="<"), hnp.floating_dtypes(endianness=">"),
                   hnp.complex_number_dtypes(), hnp.byte_string_dtypes(max_len=4),
                   hnp.unicode_string_dtypes(max_len=4))
ARRAYS = hnp.arrays(dtype=DTYPES, shape=hnp.array_shapes(min_dims=0, max_dims=4, min_side=0, max_side=5))


def assert_same_array(got, want):
    assert type(got) is np.ndarray and got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == np.ascontiguousarray(want).tobytes()


def npy_save(arr, version=None) -> bytes:
    buf = io.BytesIO()
    np.lib.format.write_array(buf, arr, version=version, allow_pickle=False)
    return buf.getvalue()


@settings(max_examples=150, deadline=None, derandomize=True, database=None)
@given(arr=ARRAYS, fortran=st.booleans())
def test_arrays_cross_both_wires_and_numpy_both_ways(arr, fortran):
    arr = np.asfortranarray(arr) if fortran and arr.ndim else arr
    body = wire.npy_dumps(arr)
    assert body == jax_wire.npy_dumps(arr)
    sent = np.ascontiguousarray(arr)  # what both wires send: a 0-d array goes as shape (1,)
    assert_same_array(jax_wire.npy_loads(body), sent)
    assert_same_array(wire.npy_loads(jax_wire.npy_dumps(arr)), sent)
    assert_same_array(np.load(io.BytesIO(body), allow_pickle=False), sent)
    for version in (None, (1, 0), (2, 0)):
        saved = npy_save(arr, version)  # np.save keeps a Fortran array's order in its header
        assert_same_array(wire.npy_loads(saved), arr)
        assert_same_array(jax_wire.npy_loads(saved), arr)


_ADDRESS = re.compile(r"0x[0-9a-f]+")


def outcome(loads, body):
    try:
        return loads(body)
    except ValueError as e:
        return e


def assert_same_outcome(body):
    want, got = outcome(jax_wire.npy_loads, body), outcome(wire.npy_loads, body)
    if isinstance(want, ValueError):  # the same message, up to the addresses of objects it names
        assert isinstance(got, ValueError) and _ADDRESS.sub("", str(got)) == _ADDRESS.sub("", str(want))
    else:
        assert_same_array(got, want)


@settings(max_examples=150, deadline=None, derandomize=True, database=None)
@given(arr=ARRAYS, cut=st.integers(0, 200), grow=st.binary(max_size=9), at=st.integers(0, 127),
       byte=st.integers(0, 255), kind=st.sampled_from(["cut", "grow", "header_byte", "body_byte"]))
def test_malformed_bodies_raise_or_parse_alike(arr, cut, grow, at, byte, kind):
    body = bytearray(wire.npy_dumps(arr))
    header_end = len(body) - arr.nbytes
    if kind == "cut":
        body = body[: max(0, len(body) - 1 - cut)]
    elif kind == "grow":
        body += grow or b"\x00"
    elif kind == "header_byte":
        body[at % header_end] = byte
    elif arr.nbytes:
        body[header_end + at % arr.nbytes] = byte
    assert_same_outcome(bytes(body))


def npy_header(header: str) -> bytes:
    """A version-1.0 ``.npy`` prefix around ``header``, padded as numpy pads it."""
    pad = -(10 + len(header) + 1) % 64
    text = (header + " " * pad + "\n").encode("latin1")
    return b"\x93NUMPY\x01\x00" + len(text).to_bytes(2, "little") + text


REFUSED = {
    "empty": b"",
    "not_npy": b"PK\x03\x04 not an npy body",
    "version_3": npy_save(np.arange(3))[:6] + b"\x03\x00" + npy_save(np.arange(3))[8:],
    "object_dtype": npy_header("{'descr': '|O', 'fortran_order': False, 'shape': (1,), }") + b"\x00" * 8,
    "huge_shape": npy_header("{'descr': '<f4', 'fortran_order': False, 'shape': (4096, 4096, 4096), }") + b"\x00" * 16,
    "short_payload": npy_save(np.arange(10, dtype=np.int32))[:-4],
    "long_payload": npy_save(np.arange(10, dtype=np.int32)) + b"\x00\x00\x00\x00",
    "header_not_a_dict": npy_header("[1, 2, 3]"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_bodies_both_wires_refuse(name):
    body = REFUSED[name]
    with pytest.raises(ValueError):
        jax_wire.npy_loads(body)
    with pytest.raises(ValueError):
        wire.npy_loads(body)
    assert_same_outcome(body)

"""The port's ``.msgpack`` decoder (``midi_vae_tpu_torch/io/flax_msgpack.py``)
against ``flax.serialization.msgpack_restore``, which it stands in for on
the GPU machine (no flax, no msgpack there), on generated inputs:

- pytrees ``flax.serialization.msgpack_serialize`` writes: nested dicts
  and lists of ndarrays (int8–64, uint8–64, float16/32/64, complex64/128,
  bool; 0-d, empty and up to 3-d), numpy scalars, Python ints over the
  whole msgpack range, floats, complex, str, bytes, bool and None; every
  leaf bitwise, of the same type;
- arrays flax chunks (its ``MAX_CHUNK_SIZE`` lowered, and a 4.8 MB array);
- bfloat16 leaves, which come back as the float32 arrays of the same
  values (numpy has no bfloat16): bit for bit on their upper half, zero
  below;
- ext types flax does not know (``msgpack.ExtType``), map keys msgpack
  refuses, truncated, corrupt and over-long inputs.
"""

import struct

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
from flax import serialization
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from midi_vae_tpu_torch.io import flax_msgpack
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

DTYPES = ["int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64", "float16", "float32", "float64",
          "complex64", "complex128", "bool"]


def assert_same_tree(got, want, path="tree"):
    """The same structure, types and bits."""
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_tree(g, w, f"{path}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes(), path
        if isinstance(want, np.ndarray):
            assert got.flags.writeable == want.flags.writeable, path
    elif isinstance(want, (float, complex)):
        assert struct.pack("<2d", *[complex(got).real, complex(got).imag]) == struct.pack(
            "<2d", *[complex(want).real, complex(want).imag]), path
    else:
        assert got == want, path


ARRAYS = hnp.arrays(dtype=st.sampled_from(DTYPES).map(np.dtype),
                    shape=hnp.array_shapes(min_dims=0, max_dims=3, min_side=0, max_side=5))
NP_SCALARS = st.sampled_from(DTYPES).flatmap(lambda d: hnp.from_dtype(np.dtype(d)).map(np.dtype(d).type))
LEAVES = st.one_of(ARRAYS, NP_SCALARS, st.integers(-(2**63), 2**64 - 1), st.floats(), st.complex_numbers(),
                   st.text(max_size=8), st.binary(max_size=8), st.booleans(), st.none())
TREES = st.recursive(LEAVES, lambda inner: st.one_of(st.lists(inner, max_size=3),
                                                     st.dictionaries(st.text(max_size=6), inner, max_size=4)),
                     max_leaves=10)


@settings(max_examples=150, deadline=None, derandomize=True, database=None)
@given(tree=st.dictionaries(st.text(max_size=6), TREES, max_size=5))
def test_generated_pytrees_restore_as_flax_restores_them(tree):
    blob = serialization.msgpack_serialize(tree)
    assert_same_tree(flax_msgpack.msgpack_restore(blob), serialization.msgpack_restore(blob))


@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(tree=st.dictionaries(st.text(max_size=6), st.one_of(ARRAYS, st.dictionaries(st.text(max_size=3), ARRAYS)),
                            max_size=4),
       chunk=st.sampled_from([1, 7, 16, 64]))
def test_chunked_arrays_restore_as_flax_restores_them(tree, chunk):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(serialization, "MAX_CHUNK_SIZE", chunk)
        blob = serialization.msgpack_serialize(tree)
    assert_same_tree(flax_msgpack.msgpack_restore(blob), serialization.msgpack_restore(blob))


def test_a_large_chunked_leaf_restores_as_flax_restores_it(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 2**20)
    big = np.random.default_rng(0).standard_normal((1200, 1000)).astype(np.float32)  # 4.8 MB, 5 chunks
    blob = serialization.msgpack_serialize({"params": {"w": big, "b": big[0]}})
    assert b"__msgpack_chunked_array__" in blob
    got = flax_msgpack.msgpack_restore(blob)
    assert_same_tree(got, serialization.msgpack_restore(blob))
    assert np.array_equal(got["params"]["w"], big)


@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(values=hnp.arrays(np.float32, hnp.array_shapes(min_dims=0, max_dims=3, min_side=0, max_side=6)))
def test_bfloat16_leaves_come_back_as_float32_of_the_same_bits(values):
    leaf = jnp.asarray(values, jnp.bfloat16)
    blob = serialization.msgpack_serialize({"a": leaf, "s": {"x": leaf.reshape(-1)[:1]}})
    want = serialization.msgpack_restore(blob)
    got = flax_msgpack.msgpack_restore(blob)
    for g, w in ((got["a"], want["a"]), (got["s"]["x"], want["s"]["x"])):
        assert g.dtype == np.float32 and w.dtype == jnp.bfloat16 and g.shape == w.shape
        bits = g.view(np.uint32)
        assert np.array_equal((bits >> 16).astype(np.uint16), np.asarray(w).view(np.uint16))
        assert not (bits & 0xFFFF).any()


@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(code=st.integers(0, 127).filter(lambda c: c not in (1, 2, 3)), data=st.binary(max_size=20))
def test_unknown_ext_types_come_back_as_msgpack_returns_them(code, data):
    blob = msgpack.packb({"x": msgpack.ExtType(code, data), "y": [msgpack.ExtType(code, data)]})
    want = serialization.msgpack_restore(blob)
    got = flax_msgpack.msgpack_restore(blob)
    assert got == want and got["x"] == msgpack.ExtType(code, data)
    assert (got["x"].code, got["x"].data) == (code, data)


def test_msgpack_timestamps_come_back_as_their_ext_bytes():
    """A chosen difference: msgpack decodes ext -1 into its ``Timestamp``;
    the port returns ``ExtType(-1, data)`` (flax never writes one)."""
    blob = msgpack.packb({"t": msgpack.Timestamp(1_700_000_000, 5)})
    want = serialization.msgpack_restore(blob)["t"]
    got = flax_msgpack.msgpack_restore(blob)["t"]
    assert got.code == -1 and msgpack.Timestamp.from_bytes(got.data) == want


REFUSED = {
    "int_map_key": msgpack.packb({0: 1}),
    "nil_map_key": msgpack.packb({None: 1}),
    "float_map_key_nested": msgpack.packb({"a": {1.5: 2}}),
    "truncated": serialization.msgpack_serialize({"w": np.arange(6, dtype=np.float32)})[:-3],
    "trailing_bytes": msgpack.packb({"a": 1}) + b"\x00",
    "never_used_byte": b"\x81\xa1a\xc1",
    "bad_utf8": b"\x81\xa1a\xa2\xff\xfe",
    "empty": b"",
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_inputs_msgpack_refuses_raise(name):
    with pytest.raises(ValueError):
        serialization.msgpack_restore(REFUSED[name])
    with pytest.raises(ValueError):
        flax_msgpack.msgpack_restore(REFUSED[name])


@settings(max_examples=80, deadline=None, derandomize=True, database=None)
@given(tree=st.dictionaries(st.text(max_size=4), TREES, min_size=1, max_size=3), cut=st.floats(0, 1))
def test_truncated_checkpoints_raise_in_both(tree, cut):
    blob = serialization.msgpack_serialize(tree)
    short = blob[: int(len(blob) * cut * 0.999)]
    with pytest.raises(Exception):
        serialization.msgpack_restore(short)
    with pytest.raises(ValueError):
        flax_msgpack.msgpack_restore(short)

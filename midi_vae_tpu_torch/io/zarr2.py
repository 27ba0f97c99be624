"""zarr v2 arrays over a key-value store (``io/ocdbt.py``): the arrays of a
JAX package Orbax checkpoint.

An array ``name`` is a JSON ``name/.zarray`` (shape, chunks, dtype, order,
fill_value, compressor, filters, dimension_separator) and one value per
chunk, ``name/<i>.<j>...`` (``name/0`` for a 0-d array), each chunk the
C-order bytes of a full chunk, zstd-compressed or stored raw. The chunk
grid is put back together with the edge chunks cut to the shape and a
missing chunk read as ``fill_value`` (zarr's rule; ``null`` reads as
zero, as tensorstore writes it). An unknown dtype, order, filter or
compressor raises ``ValueError``.

Leaves come back as numpy arrays, as ``io/flax_msgpack.py`` returns them;
a ``bfloat16`` array comes back as a ``torch.bfloat16`` tensor, since
numpy has no such type without ``ml_dtypes``.
"""

from __future__ import annotations

import itertools
import json
import math
from typing import Union

import numpy as np
import torch

from midi_vae_tpu_torch.native import zstd

_DTYPES = {
    "<f4": np.float32, "<f8": np.float64, "<i4": np.int32, "<i8": np.int64, "|u1": np.uint8, "|b1": np.bool_,
    "bfloat16": np.uint16,  # the bits, viewed as torch.bfloat16 at the end
}
_SPECIAL_FILLS = {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}


def _fill(meta: dict, dtype: np.dtype, name: str):
    value = meta.get("fill_value")
    if value is None:
        return 0
    if isinstance(value, str):
        if value not in _SPECIAL_FILLS:
            raise ValueError(f"{name}: fill_value {value!r} is not a number")
        value = _SPECIAL_FILLS[value]
    if meta["dtype"] == "bfloat16":  # the bits of the fill rounded to bfloat16
        return int(torch.tensor(value, dtype=torch.bfloat16).view(torch.int16).item()) & 0xFFFF
    return np.asarray(value).astype(dtype)


def read_array(store, name: str) -> Union[np.ndarray, torch.Tensor]:
    """The array ``name`` of ``store`` (anything with ``read(key) -> bytes``
    and ``key in store``)."""
    meta = json.loads(store.read(f"{name}/.zarray"))
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr_format {meta.get('zarr_format')}, this reader knows 2")
    dtype_name = meta.get("dtype")
    if dtype_name not in _DTYPES:
        raise ValueError(f"{name}: unsupported dtype {dtype_name!r}")
    if meta.get("order", "C") != "C":
        raise ValueError(f"{name}: order {meta.get('order')!r}, this reader knows 'C'")
    if meta.get("filters"):
        raise ValueError(f"{name}: filters {meta['filters']!r} are not supported")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"{name}: compressor {compressor.get('id')!r}, this reader knows zstd or none")
    sep = meta.get("dimension_separator", ".")
    if sep not in (".", "/"):
        raise ValueError(f"{name}: dimension_separator {sep!r}")
    dtype = np.dtype(_DTYPES[dtype_name])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks) or any(c <= 0 for c in chunks):
        raise ValueError(f"{name}: chunks {list(chunks)} do not fit shape {list(shape)}")
    out = np.full(shape, _fill(meta, dtype, name), dtype=dtype)
    chunk_bytes = math.prod(chunks) * dtype.itemsize
    grid = [range(math.ceil(s / c)) for s, c in zip(shape, chunks)]
    for index in itertools.product(*grid):
        key = f"{name}/{sep.join(map(str, index)) if index else '0'}"
        if key not in store:
            continue
        raw = store.read(key)
        if compressor is not None:
            raw = zstd.decompress(raw)
        if len(raw) != chunk_bytes:
            raise ValueError(f"{key}: {len(raw)} bytes, a chunk of {list(chunks)} {dtype_name} holds {chunk_bytes}")
        chunk = np.frombuffer(raw, dtype=dtype).reshape(chunks)
        start = [i * c for i, c in zip(index, chunks)]
        region = tuple(slice(a, min(a + c, s)) for a, c, s in zip(start, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    if dtype_name == "bfloat16":
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out

"""The binary serving wire format: ``.npy`` bodies over HTTP (counterpart
of ``midi_vae_tpu/serving/wire.py``, the same numpy code).

numpy only, shared by the server, the client and the tests: a client
process needs no torch to talk to the server. Tensor-carrying endpoints
speak ``.npy`` when the request is ``Content-Type: application/x-npy``
(or ``application/octet-stream``) or asks for it with ``Accept:
application/x-npy``.
"""

from __future__ import annotations

import io
import math

import numpy as np

NPY_CONTENT_TYPE = "application/x-npy"
BINARY_CONTENT_TYPES = (NPY_CONTENT_TYPE, "application/octet-stream")


def npy_dumps(arr: np.ndarray) -> bytes:
    """Serialise an array to ``.npy`` bytes (the binary wire format)."""
    buf = io.BytesIO()
    np.lib.format.write_array(buf, np.ascontiguousarray(arr), allow_pickle=False)
    return buf.getvalue()


def npy_loads(body: bytes) -> np.ndarray:
    """Parse ``.npy`` bytes from an untrusted request body.

    ``allow_pickle=False``: the body never deserialises objects. The
    header is validated before the array is materialised: ``read_array``
    allocates the header's declared size up front, so a short body
    declaring a huge shape would exhaust memory despite the body-size cap.
    Requiring declared bytes == carried bytes bounds the allocation by the
    (capped) body size. Any malformed body raises ``ValueError``.
    """
    buf = io.BytesIO(body)
    try:
        version = np.lib.format.read_magic(buf)
        if version == (1, 0):
            shape, _, dtype = np.lib.format.read_array_header_1_0(buf)
        elif version == (2, 0):
            shape, _, dtype = np.lib.format.read_array_header_2_0(buf)
        else:
            raise ValueError(f"unsupported npy format version {version}")
    except Exception as e:  # noqa: BLE001 - any malformed header is a bad request
        raise ValueError(f"malformed npy body: {e}") from None
    if dtype.hasobject:
        raise ValueError("npy body must not carry object dtypes")
    # python-int math: a crafted header's dims must not overflow the product
    declared = math.prod(shape) * dtype.itemsize
    payload = len(body) - buf.tell()
    if declared != payload:
        raise ValueError(
            f"npy header declares {declared} data bytes but the body carries {payload}"
        )
    buf.seek(0)
    return np.lib.format.read_array(buf, allow_pickle=False)

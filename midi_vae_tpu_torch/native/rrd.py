"""ctypes bindings of the threaded RRD loader (``native/rollloader.cc``).

:class:`NativeDataset` maps an RRD file (the layout of
``data/sources.py`` ``write_rrd``); :class:`NativeLoader` walks it in
batches assembled on a C++ thread pool: a seeded Fisher–Yates shuffle
with ``std::mt19937_64`` (the JAX package's loader, so both give the same
order for a ``(seed, shuffle)``), rows copied from the mapping into a ring
of batch buffers, an eval tail zero-padded. The library is built with
g++ at first use (``native/_build.py``); a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Iterator, Optional, Tuple

import numpy as np

from midi_vae_tpu_torch.native._build import library


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = library("rollloader")
    lib.rrd_open.restype = ctypes.c_void_p
    lib.rrd_open.argtypes = [ctypes.c_char_p]
    lib.rrd_info.restype = ctypes.c_int
    lib.rrd_info.argtypes = [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_int64)] * 4
    lib.rrd_close.argtypes = [ctypes.c_void_p]
    lib.rrd_loader_create.restype = ctypes.c_void_p
    lib.rrd_loader_create.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.rrd_loader_set_indices.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_long]
    lib.rrd_loader_start_epoch.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int]
    lib.rrd_loader_num_batches.restype = ctypes.c_long
    lib.rrd_loader_num_batches.argtypes = [ctypes.c_void_p]
    lib.rrd_loader_next.restype = ctypes.c_long
    lib.rrd_loader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64)]
    lib.rrd_loader_destroy.argtypes = [ctypes.c_void_p]
    return lib


def _address(buf, shape: Tuple[int, ...], itemsize: int) -> int:
    """Address of the first byte of a C-contiguous numpy array or CPU tensor
    of ``shape`` and item size ``itemsize``; raises for anything else, since
    the C side writes that many bytes there."""
    if hasattr(buf, "data_ptr"):
        ok = buf.device.type == "cpu" and buf.is_contiguous() and buf.element_size() == itemsize
        address = buf.data_ptr()
    else:
        ok = buf.flags.c_contiguous and buf.flags.writeable and buf.itemsize == itemsize
        address = buf.ctypes.data
    if not ok or tuple(buf.shape) != shape:
        raise ValueError(f"batch buffer must be a writable C-contiguous CPU array of {shape} x {itemsize} bytes")
    return address


class NativeDataset:
    """An RRD file mapped by the native runtime (read-only, zero-copy)."""

    def __init__(self, path: str):
        self._lib = _lib()
        self._handle = self._lib.rrd_open(path.encode())
        if not self._handle:
            raise FileNotFoundError(f"cannot open RRD file (missing, bad magic or truncated): {path}")
        vals = [ctypes.c_int64() for _ in range(4)]
        self._lib.rrd_info(self._handle, *[ctypes.byref(v) for v in vals])
        self.n, self.h, self.w, self.c = (v.value for v in vals)

    def __len__(self) -> int:
        return self.n

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.rrd_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


class NativeLoader:
    """Threaded batch iterator over a :class:`NativeDataset`: ``epoch``
    yields ``(images uint8 [B, H, W, C], labels int64 [B], n_valid)``.

    ``indices`` restricts the epochs to a row subset (a split); the order
    of an epoch is a function of ``(seed, shuffle)`` alone.
    """

    def __init__(
        self,
        dataset: NativeDataset,
        batch_size: int,
        *,
        drop_last: bool = True,
        n_threads: int = 2,
        prefetch_depth: int = 3,
        indices: Optional[np.ndarray] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self._lib = dataset._lib
        self._handle = self._lib.rrd_loader_create(dataset._handle, batch_size, int(drop_last), n_threads, prefetch_depth)
        if not self._handle:
            raise ValueError(f"cannot create a loader of batch size {batch_size}")
        self.set_indices(np.arange(len(dataset)) if indices is None else indices)

    def set_indices(self, indices: np.ndarray) -> None:
        """Serve the rows ``indices`` from the next epoch on (the C side copies them)."""
        idx = np.ascontiguousarray(indices, dtype=np.uint64)
        if idx.size and int(idx.max()) >= len(self.dataset):
            raise IndexError(f"row {int(idx.max())} out of range for {len(self.dataset)} rows")
        self._lib.rrd_loader_set_indices(self._handle, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), len(idx))
        n = len(idx)
        self.num_samples_total = n
        self.num_batches = n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def epoch(self, seed: int, shuffle: bool = True, buffers: Optional[Callable[[], Tuple]] = None) -> Iterator:
        """The batches of one epoch. ``buffers()`` returns the contiguous
        ``(images, labels)`` pair (numpy arrays or CPU tensors, pinned ones
        say) that the next batch is copied into; by default each batch gets
        fresh numpy arrays."""
        if self.num_samples_total == 0:  # the C side reads no subset as "every row"
            return
        self._lib.rrd_loader_start_epoch(self._handle, seed & 0xFFFF_FFFF_FFFF_FFFF, int(shuffle))
        ds = self.dataset
        while True:
            if buffers is None:
                images = np.empty((self.batch_size, ds.h, ds.w, ds.c), np.uint8)
                labels = np.empty(self.batch_size, np.int64)
            else:
                images, labels = buffers()
            valid = self._lib.rrd_loader_next(
                self._handle,
                ctypes.cast(_address(images, (self.batch_size, ds.h, ds.w, ds.c), 1), ctypes.POINTER(ctypes.c_uint8)),
                ctypes.cast(_address(labels, (self.batch_size,), 8), ctypes.POINTER(ctypes.c_int64)),
            )
            if valid <= 0:
                return
            yield images, labels, int(valid)

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.rrd_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()

"""The VQ quantizer's nearest-code search and its EMA sums as hand-written
CUDA C++ kernels (``csrc/vq_search.cu``), with their plain PyTorch
version beside them.

These kernels replace no TPU kernel: the JAX package leaves the quantizer
to XLA (``midi_vae_tpu/models/vq.py``). Run eagerly on the card, the plain
version writes the whole [N, K] distance matrix several times over (the
f64 cross term, its f32 copy, 2·cross, the two norm terms, then the
argmin's read), ~12 GiB a call at N = 524,288 vectors and K = 512 codes,
and then scatter-adds the EMA counts and sums with float atomics.

What bounds them, and what the design does about it: the work is 2·N·K·D
f64 operations against a few bytes a vector, so once [N, K] stays on the
chip the f64 units bound it. One launch searches: each block holds the
codebook (or a tile of it) in shared memory as f64, each warp 32 vectors
in registers; the cross terms are f64 tensor-core products (``mma.sync``
m16n8k16), rounded to f32, and the distance, the running argmin, the index
and the code gather happen in registers. In training the same launch
sums each block's counts and sums in shared memory (shared-memory
atomics, no global ones) and writes them as the block's partial row; a
second, small launch sums the partial rows over the blocks in a fixed
order. The source's note says more.

The rules of ``models/vq.py`` hold on both paths: every cross term in
f64, rounded to f32; the distance ``(‖z‖² − 2·cross) + ‖e‖²`` in f32, each
step rounded as PyTorch rounds it, with ‖z‖² and ‖e‖² from the plain
version's own expressions; the first index on a tie. The kernels' f64 sums
over D run in the tensor cores' order, cuBLAS's in an order of its own, so an
index may differ from the plain version's where two codes' f32 distances
differ by a rounding of the cross term; the counts are exact, the sums the
same in another order.

:func:`nearest_codes` and :func:`code_sums` take the kernels for CUDA
tensors with an f32 codebook (:func:`takes_kernels`), their plain version
for everything else: :func:`distances_plain` + ``argmin`` +
``index_select``, and :func:`code_sums_plain`'s ``index_add_``. A launch
raises on a CUDA error; nothing falls back. Both launches are called as
``torch.library`` operators (``midi_vae_tpu_torch::vq_nearest_codes``,
``::vq_code_sums``), eagerly as under ``torch.export`` or
``torch.compile``, so that an exported program records them; it runs them
once this module is imported. Launch counts: ``nearest_codes.launches``
and ``code_sums.launches``; a :func:`nearest_codes` call that takes the
kernels also counts ``vq.fused_calls`` (``io/tracing.py``). The library
is built by ``ops/cuda_lib.py`` at the first launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from midi_vae_tpu_torch.io import tracing
from midi_vae_tpu_torch.ops.fused_elbo import _current_stream

_NAMESPACE = "midi_vae_tpu_torch"  # of the torch.library operators
MAX_DIM = 1024  # code dimensions a shared-memory tile takes, at most


# ================================================================ the plain version


def distances_plain(flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """[N, D] f32 vectors → [N, K] squared distances to the codes, f32: the
    cross term in f64, rounded to f32."""
    cross = (flat.double() @ codebook.double().T).float()
    return torch.sum(flat * flat, dim=1, keepdim=True) - 2.0 * cross + torch.sum(codebook * codebook, dim=1)[None, :]


def nearest_codes_plain(flat: torch.Tensor, codebook: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(indices [N] int64, z_q = codebook[indices] [N, D]): ``argmin`` of
    :func:`distances_plain`, the first index on a tie."""
    idx = torch.argmin(distances_plain(flat, codebook), dim=1)
    return idx, codebook.index_select(0, idx)


def code_sums_plain(flat: torch.Tensor, idx: torch.Tensor, num_codes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(counts [K], sums [K, D]) of the vectors each code was picked for:
    ones and vectors scatter-added (``index_add_``), f32, with no host
    sync (``bincount`` would read the indices' range back)."""
    counts = flat.new_zeros(num_codes).index_add_(0, idx, flat.new_ones(idx.shape[0]))
    sums = flat.new_zeros(num_codes, flat.shape[1]).index_add_(0, idx, flat)
    return counts, sums


# ================================================================ the kernels


def takes_kernels(flat: torch.Tensor, codebook: torch.Tensor) -> bool:
    """Whether :func:`nearest_codes` launches the kernels: CUDA tensors with
    an f32 codebook (every model dtype keeps its quantizer's buffers in
    f32; an f64 model's are f64 and take the plain version, as on the CPU)."""
    return flat.is_cuda and codebook.is_cuda and codebook.dtype == torch.float32


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """csrc/vq_search.cu, built and loaded (first launch only), with the C
    signatures declared."""
    from midi_vae_tpu_torch.ops import cuda_lib

    lib = cuda_lib.library("vq_search")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.vq_search_capacity.argtypes = [i32, i32, i32, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.vq_search_capacity.restype = i32
    lib.vq_search.argtypes = [ptr, ptr, ptr, ptr, i64, i32, i32, ptr, ptr, ptr, i32, i32, ptr]
    lib.vq_search.restype = i32
    lib.vq_code_sums.argtypes = [ptr, i32, i32, i32, ptr, i32, ptr]
    lib.vq_code_sums.restype = i32
    lib.vq_error_string.argtypes = [i32]
    lib.vq_error_string.restype = ctypes.c_char_p
    return lib


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({_lib().vq_error_string(err).decode()})")


@functools.lru_cache(maxsize=None)
def _capacity(k: int, d: int, device_index: int) -> Tuple[int, int]:
    """(blocks of the search the card holds at once, vectors a block's
    tile covers) for ``k`` codes of dimension ``d``."""
    blocks, tile = ctypes.c_int(0), ctypes.c_int(0)
    err = _lib().vq_search_capacity(k, d, device_index, ctypes.byref(blocks), ctypes.byref(tile))
    _check(err, "vq_search_capacity")
    if blocks.value <= 0:
        raise ValueError(f"the search takes no codebook of dimension {d}")
    return blocks.value, tile.value


def search_blocks(n: int, k: int, d: int, device_index: int) -> int:
    """Blocks of the search for ``n`` vectors: at most as many as the card
    holds at once, each walking the same number of tiles to within one.
    Fixed by the shape and the card, and so is the order of the sums."""
    most, tile = _capacity(k, d, device_index)
    tiles = -(-n // tile)
    return -(-tiles // -(-tiles // most)) if tiles else 1


def _check_inputs(flat: torch.Tensor, codebook: torch.Tensor) -> None:
    if flat.ndim != 2 or codebook.ndim != 2 or flat.shape[1] != codebook.shape[1]:
        raise ValueError(f"need flat [N, D] and codebook [K, D], got {tuple(flat.shape)} and {tuple(codebook.shape)}")
    if flat.dtype != torch.float32 or codebook.dtype != torch.float32:
        raise TypeError(f"the kernels take f32 vectors and codebook, got {flat.dtype} and {codebook.dtype}")
    if flat.device != codebook.device:
        raise ValueError(f"tensors on different devices: {flat.device} and {codebook.device}")
    k, d = codebook.shape
    if not 1 <= d <= MAX_DIM or k < 1 or k * (d + 1) >= 2**31:
        raise ValueError(f"the kernels take 1..{MAX_DIM} dimensions and an int32-sized codebook, "
                         f"got {tuple(codebook.shape)}")


def _launch_search(flat, codebook, zz, ee, train: bool):
    n, d = flat.shape
    k = codebook.shape[0]
    dev = flat.device
    idx = torch.empty(n, dtype=torch.int64, device=dev)
    z_q = torch.empty((n, d), dtype=torch.float32, device=dev)
    blocks = search_blocks(n, k, d, dev.index)
    partials = torch.empty((blocks if train else 0, k, d + 1), dtype=torch.float32, device=dev)
    err = _lib().vq_search(flat.data_ptr(), codebook.data_ptr(), zz.data_ptr(), ee.data_ptr(), n, k, d,
                           idx.data_ptr(), z_q.data_ptr(), partials.data_ptr() if train else None, blocks,
                           dev.index, _current_stream(dev.index))
    _check(err, "vq_search")
    nearest_codes.launches += 1
    return idx, z_q, partials


def _launch_sums(partials: torch.Tensor) -> torch.Tensor:
    blocks, k, row = partials.shape
    out = torch.empty((k, row), dtype=torch.float32, device=partials.device)
    err = _lib().vq_code_sums(partials.data_ptr(), blocks, k, row - 1, out.data_ptr(), partials.device.index,
                              _current_stream(partials.device.index))
    _check(err, "vq_code_sums")
    code_sums.launches += 1
    return out


# ================================================================ operators

# Registered with torch.library, so that torch.export and torch.compile record the kernels' calls (register_fake
# gives the outputs' shapes) and an exported program runs them once this module is imported. Eager calls take
# the same operators.


@torch.library.custom_op(f"{_NAMESPACE}::vq_nearest_codes", mutates_args=(), device_types="cuda")
def _nearest_codes_op(flat: torch.Tensor, codebook: torch.Tensor, zz: torch.Tensor, ee: torch.Tensor,
                      train: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return _launch_search(flat, codebook, zz, ee, train)


@torch.library.custom_op(f"{_NAMESPACE}::vq_code_sums", mutates_args=(), device_types="cuda")
def _code_sums_op(partials: torch.Tensor) -> torch.Tensor:
    return _launch_sums(partials)


@_nearest_codes_op.register_fake
def _(flat, codebook, zz, ee, train):
    n, d = flat.shape
    k = codebook.shape[0]
    blocks = search_blocks(int(n), int(k), int(d), flat.device.index) if train else 0
    return (flat.new_empty(n, dtype=torch.int64), flat.new_empty((n, d)),
            flat.new_empty((blocks, k, d + 1)))


@_code_sums_op.register_fake
def _(partials):
    return partials.new_empty(partials.shape[1:])


# ================================================================ the calls


def nearest_codes(
    flat: torch.Tensor, codebook: torch.Tensor, *, train: bool
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(indices [N] int64, z_q [N, D] f32, partials) of the nearest codes
    of ``flat`` [N, D] in ``codebook`` [K, D] (no autograd). On the kernels
    (:func:`takes_kernels`), ``partials`` is the search's per-block partial
    counts and sums in training, for :func:`code_sums`, and an empty tensor
    in eval; on the plain version it is None."""
    if not takes_kernels(flat, codebook):
        idx, z_q = nearest_codes_plain(flat, codebook)
        return idx, z_q, None
    _check_inputs(flat, codebook)
    flat = flat.detach().contiguous()
    codebook = codebook.detach().contiguous()
    # the plain version's own expressions, so both norms round as there
    zz = torch.sum(flat * flat, dim=1)
    ee = torch.sum(codebook * codebook, dim=1)
    tracing.count("vq.fused_calls", 1)
    return _nearest_codes_op(flat, codebook, zz, ee, bool(train))


def code_sums(
    flat: torch.Tensor, idx: torch.Tensor, partials: Optional[torch.Tensor], num_codes: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(counts [K], sums [K, D]) of the vectors each code was picked for, f32:
    the partials of a training :func:`nearest_codes` on the kernels summed
    over the search's blocks (a second launch), else
    :func:`code_sums_plain`."""
    if partials is None:
        return code_sums_plain(flat, idx, num_codes)
    both = _code_sums_op(partials)
    return both[:, 0], both[:, 1:]


nearest_codes.launches = 0
code_sums.launches = 0

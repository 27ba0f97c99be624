"""The least work of one call of the VQ-VAE's quantizer in training,
whatever implements it: the nearest of K codes for each of N vectors of
dimension D, and one EMA update of the codebook.

- Operations: the cross term z·e of every vector with every code, N·K·D
  multiply-adds in f64 (the port's semantics: no TF32 setting may mis-rank
  near-ties), at the FP64 tensor-core peak. The norms, the argmin and the
  update are O(N·D + N·K) and left out.
- Bytes: z_e read once in its dtype, the three buffers (codebook, counts,
  sums) read once and written once in f32, the indices (int32 holds any
  code) and z_q (f32) written once.
"""

from __future__ import annotations

from bench_cuda import peaks

PEAK_F64_FLOPS = 67e12  # H100 SXM data sheet, FP64 tensor core, dense


def least_work(n: int, k: int, d: int, z_bytes: int) -> tuple:
    """(bytes, f64 operations) of one training call over ``n`` vectors."""
    buffers = 4 * (2 * k * d + k)
    nbytes = n * d * z_bytes + 2 * buffers + n * 4 + n * d * 4
    return nbytes, 2 * n * k * d


def least_seconds(n: int, k: int, d: int, z_bytes: int) -> float:
    """The least time of a call: bytes at the HBM rate or operations at the
    f64 peak, whichever is longer."""
    nbytes, ops = least_work(n, k, d, z_bytes)
    return max(nbytes / peaks.HBM_BYTES_PER_S, ops / PEAK_F64_FLOPS)

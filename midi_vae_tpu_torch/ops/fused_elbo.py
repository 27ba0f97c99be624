"""Hopper kernels for the ELBO hot path (counterpart of
``midi_vae_tpu/ops/fused_elbo.py``).

The JAX package has three Pallas TPU kernels here; each becomes a
hand-written kernel for the H100, with a plain PyTorch version of the same
function beside it:

- **K1** ``_bce_partial_kernel`` (+ ``_sum_partials_kernel``), Triton,
  replaces ``_bce_fwd_kernel`` (midi_vae_tpu/ops/fused_elbo.py:125): the
  mean of the clamped binary cross-entropy over reconstruction logits.
- **K2** ``_bce_grad_kernel``, Triton, replaces ``_bce_grad_kernel``
  (midi_vae_tpu/ops/fused_elbo.py:141): its gradient w.r.t. the logits.
- **K3** ``k3_reparam_kl_fwd_kernel`` and ``k3_reparam_kl_bwd_kernel``,
  CUDA C++ in ``csrc/reparam_kl.cu``, replace ``_reparam_kl_kernel``
  (midi_vae_tpu/ops/fused_elbo.py:48) and its VJP ``_reparam_kl_bwd``
  (:106): z = mu + eps·exp(log_var/2) with eps drawn in the kernel, the
  KL, and their gradients.

What bounds them on the card, and what the design does about it:

- K1 and K2 read every logit and target once (6 B per element for bf16
  logits and f32 targets; K2 also writes 2 B) and do a few dozen flops per
  element, far below the card's ~20 flops/byte f32 balance point: they are
  bound by device-memory bytes. Both are one pass with no intermediate
  tensor in device memory. Triton's masked loads cover the ragged tail,
  so there is none of the TPU version's zero padding and log 2 correction.
  K2 writes d_logits in the logits' own dtype (no f32 buffer and cast),
  and rounds each f32 step as the plain version does (libdevice's exp,
  IEEE divide, no fused multiply-add), so the two agree bit for bit even
  where p ≈ t cancels; the extra instructions cost nothing in a pass
  that waits on memory.
- K1 is a grid-strided reduction: each of at most ``_BCE_MAX_PROGRAMS``
  programs walks its tiles in a fixed order into an f32 register vector
  and writes one partial; a second one-program pass sums the partials.
  No float atomics, so repeated runs agree bit for bit.
- K3 works on [B, D] (20,480 elements on the flagship step, ~0.1 MB): it
  is bound by launch latency, not by the card. Its forward is one launch
  of one thread-block cluster that draws eps, writes z and the finished
  KL; its backward is one elementwise launch; each is reached through one
  ``ctypes`` call (the source's note says more). Its draw is
  Philox-4x32-10 keyed by a seed the caller derives on the host, so no
  device to host sync is needed (a counter offset lets a rank of a
  data-parallel step draw its rows of the global batch's noise), and
  :func:`k3_eps_plain` is the same draw
  in PyTorch: the CPU and the card give the same noise for the same seed.

Each wrapper (:func:`bce_mean`, :func:`bce_mean_grad`, :func:`reparam_kl`,
:func:`reparam_kl_grad`) launches its kernel for CUDA tensors and counts
the launch in its ``launches`` attribute; for CPU tensors it runs the plain
version, and for any other device it raises. Triton is imported, and the
CUDA C++ library built (``ops/cuda_lib.py``), only when a kernel is first
launched; where Triton caches what it builds is Triton's own setting
(``TRITON_CACHE_DIR``), which this module leaves alone.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

_LOG_CLAMP = -100.0  # torch binary_cross_entropy clamps log terms at -100

_BCE_BLOCK = 4096  # elements per tile of K1/K2
_BCE_MAX_PROGRAMS = 1024  # K1 programs (and partials); fixed per n, so the sum order is fixed
_MAX_ELEMENTS = 2**30  # kernel offsets are int32; K3's Philox counter word is offset + the flat index

# Philox-4x32-10 (Salmon et al., SC'11; Random123's philox4x32): multipliers and key increments
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF


# ================================================================ plain versions


def _bce_terms_plain(logits: torch.Tensor, targets: torch.Tensor):
    """f32 (logits, targets, log σ(l), log(1−σ(l))) without the clamp."""
    l32 = logits.float()
    t32 = targets.float()
    return l32, t32, -torch.nn.functional.softplus(-l32), -torch.nn.functional.softplus(l32)


def bce_mean_plain(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean clamped BCE over all elements, in f32 (the function of K1)."""
    _, t32, log_p, log_1mp = _bce_terms_plain(logits, targets)
    bce = -(t32 * log_p.clamp_min(_LOG_CLAMP) + (1.0 - t32) * log_1mp.clamp_min(_LOG_CLAMP))
    return bce.sum() / logits.numel()


def bce_mean_grad_plain(logits: torch.Tensor, targets: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """g · ∂(mean clamped BCE)/∂logits in the logits' dtype (the function of K2).

    The log terms that hit the −100 clamp carry no gradient, as in the
    JAX kernel (m1, m2 below)."""
    l32, t32, log_p, log_1mp = _bce_terms_plain(logits, targets)
    p = torch.sigmoid(l32)
    m1 = (log_p > _LOG_CLAMP).float()
    m2 = (log_1mp > _LOG_CLAMP).float()
    scale = g.float() * (1.0 / logits.numel())
    return (scale * (-(t32 * (1.0 - p) * m1 - (1.0 - t32) * p * m2))).to(logits.dtype)


def reparam_kl_plain(
    mu: torch.Tensor, log_var: torch.Tensor, eps: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(z, kl) for a given eps (the function of K3 once eps is drawn).

    z = mu + eps·exp(log_var/2) in mu's dtype; kl = −0.5·Σ(1 + lv − mu² − e^lv)/B in f32.
    """
    mu32, lv32 = mu.float(), log_var.float()
    z = (mu32 + eps.float() * torch.exp(0.5 * lv32)).to(mu.dtype)
    kl = -0.5 * torch.sum(1.0 + lv32 - mu32 * mu32 - torch.exp(lv32)) / mu.shape[0]
    return z, kl


def _mulhilo32(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of a·b for a 32-bit constant ``a`` and 32-bit
    words ``b`` held in int64: b is split in 16-bit halves so that no
    product leaves int64 (torch has no full uint32 arithmetic)."""
    t = a * (b >> 16)  # < 2**48
    s = ((t & 0xFFFF) << 16) + a * (b & 0xFFFF)  # < 2**49; a·b = (t >> 16)·2**32 + s
    return (t >> 16) + (s >> 32), s & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox-4x32-10 of counter (c0, c1, c2, c3) under key (k0, k1): the four
    output words. Counter words are int64 tensors of 32-bit values (or ints);
    the key is two ints."""
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _MASK32, (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo32(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def k3_uniforms_plain(shape, seed: int, device="cpu", offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's uniforms (u1 in (0, 1], u2 in [0, 1)) for a tensor of ``shape``:
    Philox words 0 and 1 of counter (offset + flat index, 0, 0, 0) under key
    (seed, 0), top 24 bits, as midi_vae_tpu/ops/fused_elbo.py:60-63 maps its
    bits."""
    idx = torch.arange(offset, offset + math.prod(shape), dtype=torch.int64, device=device)
    w0, w1, _, _ = philox4x32_10(idx, 0, 0, 0, int(seed), 0)
    u1 = (w0 >> 8).to(torch.float32) * 2.0**-24 + 2.0**-25
    u2 = (w1 >> 8).to(torch.float32) * 2.0**-24
    return u1.reshape(shape), u2.reshape(shape)


def k3_eps_plain(shape, seed: int, device="cpu", offset: int = 0) -> torch.Tensor:
    """The f32 noise K3 draws for ``shape``, ``seed`` and counter ``offset``
    (Box-Muller, as midi_vae_tpu/ops/fused_elbo.py:64), on any device: rows
    [r·b, (r+1)·b) of a [N·b, D] draw are ``offset`` = r·b·D."""
    u1, u2 = k3_uniforms_plain(shape, seed, device, offset)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)


def reparam_kl_bwd_plain(
    mu: torch.Tensor,
    log_var: torch.Tensor,
    z: torch.Tensor,
    g_z: torch.Tensor,
    g_kl: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d_mu, d_lv) of K3 in the dtypes of mu and log_var (the function of K3's
    backward; midi_vae_tpu/ops/fused_elbo.py:106-114), in f32:
    ∂z/∂mu = 1, ∂z/∂lv = (z − mu)/2; ∂kl/∂mu = mu/B, ∂kl/∂lv = −0.5·(1 − e^lv)/B.
    ``g_kl=None`` means the KL got no gradient: its terms are left out."""
    mu32, gz = mu.float(), g_z.float()
    inv_b = 1.0 / mu.shape[0]
    d_mu = gz
    d_lv = gz * 0.5 * (z.float() - mu32)
    if g_kl is not None:
        g = g_kl.float()
        d_mu = d_mu + g * mu32 * inv_b
        d_lv = d_lv + g * (-0.5) * (1.0 - torch.exp(log_var.float())) * inv_b
    return d_mu.to(mu.dtype), d_lv.to(log_var.dtype)


# ================================================================ Triton kernels


@functools.lru_cache(maxsize=None)
def _kernels():
    """Define the Triton kernels (imports triton; first launch only)."""
    import triton
    import triton.language as tl
    from triton.language.extra import libdevice

    @triton.jit
    def _bce_partial_kernel(l_ptr, t_ptr, part_ptr, n, BLOCK: tl.constexpr):
        # K1, stage 1: program pid sums tiles pid, pid + P, pid + 2P, ...
        pid = tl.program_id(0)
        stride = tl.num_programs(0) * BLOCK
        acc = tl.zeros([BLOCK], dtype=tl.float32)
        for start in range(pid * BLOCK, n, stride):
            offs = start + tl.arange(0, BLOCK)
            m = offs < n
            l = tl.load(l_ptr + offs, mask=m, other=0.0).to(tl.float32)
            t = tl.load(t_ptr + offs, mask=m, other=0.0).to(tl.float32)
            # softplus(∓l) = max(∓l, 0) + log(1 + e^−|l|)
            common = tl.log(1.0 + tl.exp(-tl.abs(l)))
            log_p = tl.maximum(-(tl.maximum(-l, 0.0) + common), -100.0)
            log_1mp = tl.maximum(-(tl.maximum(l, 0.0) + common), -100.0)
            bce = -(t * log_p + (1.0 - t) * log_1mp)
            acc += tl.where(m, bce, 0.0)
        tl.store(part_ptr + pid, tl.sum(acc, axis=0))

    @triton.jit
    def _sum_partials_kernel(part_ptr, out_ptr, n_part, div, BLOCK: tl.constexpr):
        # stage 2 of K1: one program, fixed order
        offs = tl.arange(0, BLOCK)
        p = tl.load(part_ptr + offs, mask=offs < n_part, other=0.0)
        tl.store(out_ptr, tl.sum(p, axis=0) / div)

    @triton.jit
    def _bce_grad_kernel(l_ptr, t_ptr, g_ptr, out_ptr, n, inv_n, BLOCK: tl.constexpr):
        # K2: elementwise, one tile per program, stored in the logits' dtype.
        # Each f32 step is rounded as the plain version's (IEEE exp and
        # divide, no fused multiply-add): where p ≈ t the result cancels,
        # and any other rounding would move it by many of its own ulps.
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        l = tl.load(l_ptr + offs, mask=m, other=0.0).to(tl.float32)
        t = tl.load(t_ptr + offs, mask=m, other=0.0).to(tl.float32)
        scale = libdevice.mul_rn(tl.load(g_ptr).to(tl.float32), inv_n)
        p = libdevice.div_rn(1.0, libdevice.add_rn(1.0, libdevice.exp(-l)))
        # log σ(l) > −100 exactly when l > −100 (softplus(−l) = −l beyond 20), and
        # log(1 − σ(l)) > −100 when l < 100: the masks of the clamped terms
        m1 = (l > -100.0).to(tl.float32)
        m2 = (l < 100.0).to(tl.float32)
        pos = libdevice.mul_rn(libdevice.mul_rn(t, libdevice.add_rn(1.0, -p)), m1)
        neg = libdevice.mul_rn(libdevice.mul_rn(libdevice.add_rn(1.0, -t), p), m2)
        d = libdevice.mul_rn(scale, -libdevice.add_rn(pos, -neg))
        tl.store(out_ptr + offs, d.to(out_ptr.dtype.element_ty), mask=m)

    return {
        "triton": triton,
        "bce_partial": _bce_partial_kernel,
        "sum_partials": _sum_partials_kernel,
        "bce_grad": _bce_grad_kernel,
    }


# ================================================================ CUDA C++ kernels

# dtype → code of csrc/reparam_kl.cu
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_FLOAT_DTYPES = tuple(_DTYPE_CODES)


@functools.lru_cache(maxsize=None)
def _k3_lib() -> ctypes.CDLL:
    """csrc/reparam_kl.cu, built and loaded (first launch only), with the C
    signatures declared: every pointer and the stream as c_void_p."""
    from midi_vae_tpu_torch.ops import cuda_lib

    lib = cuda_lib.library("reparam_kl")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.k3_reparam_kl_fwd.argtypes = [
        ptr, i32, ptr, i32, ptr, ptr, ctypes.c_longlong, ctypes.c_uint, ctypes.c_uint, f32, i32, ptr
    ]
    lib.k3_reparam_kl_fwd.restype = i32
    lib.k3_reparam_kl_bwd.argtypes = [
        ptr, i32, ptr, i32, ptr, i32, ptr, i32, ptr, ptr, ptr, ctypes.c_longlong, f32, i32, ptr
    ]
    lib.k3_reparam_kl_bwd.restype = i32
    lib.k3_error_string.argtypes = [i32]
    lib.k3_error_string.restype = ctypes.c_char_p
    return lib


def _current_stream(device_index: int) -> int:
    """The handle of PyTorch's current stream on the device, as an int: the
    raw getter Triton's launcher uses, which builds no ``torch.cuda.Stream``
    object as ``torch.cuda.current_stream(device).cuda_stream`` does."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def _raise_on_cuda_error(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({lib.k3_error_string(err).decode()})")


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors (plain
    version); raises for mixed devices or any other device."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and {t.device}")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel and no plain path for device {dev}")


def _check_float_same_shape(*tensors: torch.Tensor) -> None:
    shape = tensors[0].shape
    for t in tensors:
        if t.shape != shape:
            raise ValueError(f"shape mismatch: {tuple(shape)} vs {tuple(t.shape)}")
        if t.dtype not in _FLOAT_DTYPES:
            raise TypeError(f"kernel takes float32/bfloat16/float16, got {t.dtype}")


def _check_kernel_inputs(*tensors: torch.Tensor) -> None:
    _check_float_same_shape(*tensors)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("kernel takes contiguous tensors")
    if tensors[0].numel() == 0 or tensors[0].numel() >= _MAX_ELEMENTS:
        raise ValueError(f"kernel takes 1..{_MAX_ELEMENTS - 1} elements, got {tensors[0].numel()}")


def _sum_partials(k, partials: torch.Tensor, out: torch.Tensor, div: float) -> None:
    n_part = partials.numel()
    k["sum_partials"][(1,)](
        partials, out, n_part, div, BLOCK=max(k["triton"].next_power_of_2(n_part), 16), num_warps=4
    )


def bce_mean(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean clamped BCE as an f32 0-d tensor: K1 on CUDA, the plain version on CPU."""
    if not _on_cuda(logits, targets):
        return bce_mean_plain(logits, targets)
    _check_kernel_inputs(logits, targets)
    k = _kernels()
    n = logits.numel()
    n_prog = min(-(-n // _BCE_BLOCK), _BCE_MAX_PROGRAMS)
    partials = torch.empty(n_prog, dtype=torch.float32, device=logits.device)
    out = torch.empty((), dtype=torch.float32, device=logits.device)
    with torch.cuda.device(logits.device):
        k["bce_partial"][(n_prog,)](logits, targets, partials, n, BLOCK=_BCE_BLOCK, num_warps=8)
        _sum_partials(k, partials, out, float(n))
    bce_mean.launches += 1
    return out


def bce_mean_grad(logits: torch.Tensor, targets: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """g · ∂bce_mean/∂logits in the logits' dtype: K2 on CUDA, the plain version on CPU."""
    if not _on_cuda(logits, targets, g):
        return bce_mean_grad_plain(logits, targets, g)
    _check_kernel_inputs(logits, targets)
    if g.numel() != 1:
        raise ValueError(f"g must be a scalar, got shape {tuple(g.shape)}")
    k = _kernels()
    n = logits.numel()
    g32 = g.reshape(()).float().contiguous()
    out = torch.empty_like(logits)
    with torch.cuda.device(logits.device):
        k["bce_grad"][(-(-n // _BCE_BLOCK),)](
            logits, targets, g32, out, n, 1.0 / n, BLOCK=_BCE_BLOCK, num_warps=8
        )
    bce_mean_grad.launches += 1
    return out


def reparam_kl(
    mu: torch.Tensor, log_var: torch.Tensor, seed: int, offset: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(z, kl) with eps ~ N(0, I) keyed by ``seed`` from Philox counter
    ``offset`` on: K3's forward on CUDA, the plain version with
    :func:`k3_eps_plain`'s draw on CPU — the same noise on both for the same
    seed and offset."""
    if mu.ndim != 2:
        raise ValueError(f"mu must be [B, D], got shape {tuple(mu.shape)}")
    seed, offset = int(seed), int(offset)
    if not 0 <= seed < 2**31:
        raise ValueError(f"seed must be in [0, 2**31), got {seed}")
    if offset < 0 or offset + mu.numel() > 2**32:
        raise ValueError(f"offset + elements must stay within the 32-bit counter, got {offset} + {mu.numel()}")
    if not _on_cuda(mu, log_var):
        return reparam_kl_plain(mu, log_var, k3_eps_plain(mu.shape, seed, mu.device, offset))
    _check_kernel_inputs(mu, log_var)
    lib = _k3_lib()
    device = mu.device.index
    z = torch.empty_like(mu)
    kl = torch.empty((), dtype=torch.float32, device=mu.device)
    err = lib.k3_reparam_kl_fwd(
        mu.data_ptr(), _DTYPE_CODES[mu.dtype], log_var.data_ptr(), _DTYPE_CODES[log_var.dtype],
        z.data_ptr(), kl.data_ptr(), mu.numel(), seed, offset, 1.0 / mu.shape[0], device, _current_stream(device),
    )
    _raise_on_cuda_error(lib, err, "K3 forward")
    reparam_kl.launches += 1
    return z, kl


def reparam_kl_grad(
    mu: torch.Tensor,
    log_var: torch.Tensor,
    z: torch.Tensor,
    g_z: torch.Tensor,
    g_kl: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d_mu, d_lv) of :func:`reparam_kl` given the gradients of z and kl (None:
    the KL got none): K3's backward on CUDA, the plain version on CPU."""
    _check_float_same_shape(mu, log_var, z, g_z)
    if g_kl is not None and (g_kl.numel() != 1 or g_kl.dtype not in _FLOAT_DTYPES):
        raise ValueError(f"g_kl must be a float scalar, got shape {tuple(g_kl.shape)} {g_kl.dtype}")
    if not _on_cuda(mu, log_var, z, g_z, *(() if g_kl is None else (g_kl,))):
        return reparam_kl_bwd_plain(mu, log_var, z, g_z, g_kl)
    _check_kernel_inputs(mu, log_var, z, g_z)
    lib = _k3_lib()
    device = mu.device.index
    g_kl32 = None if g_kl is None else g_kl.reshape(()).float().contiguous()
    d_mu = torch.empty_like(mu)
    d_lv = torch.empty_like(log_var)
    err = lib.k3_reparam_kl_bwd(
        mu.data_ptr(), _DTYPE_CODES[mu.dtype], log_var.data_ptr(), _DTYPE_CODES[log_var.dtype],
        z.data_ptr(), _DTYPE_CODES[z.dtype], g_z.data_ptr(), _DTYPE_CODES[g_z.dtype],
        None if g_kl32 is None else g_kl32.data_ptr(), d_mu.data_ptr(), d_lv.data_ptr(), mu.numel(),
        1.0 / mu.shape[0], device, _current_stream(device),
    )
    _raise_on_cuda_error(lib, err, "K3 backward")
    reparam_kl_grad.launches += 1
    return d_mu, d_lv


bce_mean.launches = 0
bce_mean_grad.launches = 0
reparam_kl.launches = 0
reparam_kl_grad.launches = 0

# kernel key → wrapper, in the order of the kernel table in PERF.md
KERNEL_WRAPPERS = {"K1": bce_mean, "K2": bce_mean_grad, "K3": reparam_kl, "K3-bwd": reparam_kl_grad}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


# ================================================================ autograd


class _FusedReparamKL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mu, log_var, seed, offset):
        z, kl = reparam_kl(mu, log_var, seed, offset)
        ctx.save_for_backward(mu, log_var, z)
        ctx.set_materialize_grads(False)  # the model drops kl: no zero tensor for its gradient
        return z, kl

    @staticmethod
    def backward(ctx, g_z, g_kl):
        mu, log_var, z = ctx.saved_tensors
        if g_z is None:  # only kl got a gradient
            g_z = torch.zeros_like(z)
        d_mu, d_lv = reparam_kl_grad(mu, log_var, z, g_z.contiguous(), g_kl)
        return d_mu, d_lv, None, None


def fused_reparam_kl(
    mu: torch.Tensor, log_var: torch.Tensor, seed: int, offset: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(z, kl), z = mu + eps·exp(log_var/2), kl the batch-mean Gaussian KL — K3's
    forward (eps from Philox counter ``offset`` on), and K3's backward (the
    JAX package's custom VJP) as backward."""
    return _FusedReparamKL.apply(mu, log_var, seed, offset)


class _FusedBCEMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets):
        ctx.save_for_backward(logits, targets)
        return bce_mean(logits, targets)

    @staticmethod
    def backward(ctx, g):
        logits, targets = ctx.saved_tensors
        return bce_mean_grad(logits, targets, g), None


def fused_bce_mean(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean clamped BCE over all elements (K1), with K2 as its backward.
    Targets get no gradient, as in the JAX kernel."""
    return _FusedBCEMean.apply(logits, targets)


def fused_elbo_terms(logits, targets, mu, log_var, kld_weight):
    """Loss terms via the fused kernels: (loss, recon, kl).

    KL is recomputed from (mu, log_var) in f32 — the reparameterization z
    comes from :func:`fused_reparam_kl` inside the model — as in
    midi_vae_tpu/ops/fused_elbo.py:239-251.
    """
    recon = fused_bce_mean(logits, targets)
    mu32, lv32 = mu.float(), log_var.float()
    kl = -0.5 * torch.mean(torch.sum(1.0 + lv32 - mu32**2 - torch.exp(lv32), dim=-1))
    loss = recon + kld_weight * kl
    return loss, recon, kl

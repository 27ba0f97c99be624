"""BatchNorm + LeakyReLU of the conv blocks as one operation, forward and
backward, in hand-written Triton kernels.

These kernels replace no TPU kernel: the JAX package leaves BatchNorm and
the activation after it to XLA's fusion (``midi_vae_tpu/models/vae.py``
``_apply_norm``). Run eagerly on the card, the same arithmetic is some
forty elementwise and reduction passes a layer in f32, forward and
backward (an f32 copy of x, x·x, two means, the variance, the normalised
value, the cast, the activation, and autograd's replay of each), and at
batch 2048 those passes fill most of the device's time.

What bounds them, and what the design does about it: BatchNorm and the
activation do a few operations per element, far below the card's balance
point, so device-memory bytes bound them. The design moves each element
as few times as its data dependencies allow (16 bytes an element for
bf16, forward and backward together): the forward reads x once for the
per-channel sums and once more to write y; the backward reads x and dy
once for the two per-channel sums and once more to write dx. Nothing of
activation size is kept in f32: autograd saves x in its own dtype and
three f32 [C] vectors (the batch mean, the inverse std, and whether the
variance took a gradient), and the backward recomputes the normalised
value and the activation's mask from them. Each pass reads x, dy, y and
dx through their own (n, h, w, c) strides, so the channels-last views the
conv blocks hand over (``DeconvBlock``'s crop among them) are not copied;
channels are the contiguous axis there and each program works on a tile
of 128 pixels by 32 channels.

Six kernels, each for any layer shape (sizes and strides are runtime
arguments; Triton specializes only on the dtypes, on a stride of 1, and on
sizes and strides divisible by 16):

- ``_bn_stats_kernel``: per channel, f32 partial sums of x and x² over a
  fixed set of pixel tiles per program; ``_bn_finalize_kernel`` sums the
  partials in a fixed order into the mean and the variance (flax's
  ``E[x²] − E[x]²``, clamped at 0), moves the running averages in place
  (train mode, outside a remat recompute), and writes the saved vectors;
  in eval mode it reads the running averages instead;
- ``_bn_apply_kernel``: ``(x − mean)·(rstd·scale) + bias`` in f32, rounded
  to the output dtype, then LeakyReLU on that rounded value;
- ``_bn_grad_stats_kernel`` and ``_bn_grad_finalize_kernel``: Σdz and Σdz·x̂
  (dz the activation's gradient, x̂ the normalised x), which are ∂bias
  and ∂scale and the two terms of the closed-form ∂x;
- ``_bn_grad_apply_kernel``: ``dx = rstd·scale·(dz − Σdz/M − x̂·Σdz·x̂/M)``
  (train mode; in eval mode ``rstd·scale·dz``), where the variance
  term is dropped in channels whose variance was clamped, as autograd
  drops it.

No float atomics and a fixed number of programs per shape: the same
input gives bitwise the same output. No host sync and no host read of a
device value, and every buffer comes from ``torch.empty`` on the current
stream, so the kernels can be captured in a CUDA graph. The normalise
step rounds each operation as the plain version does (IEEE multiply and
add, no fused multiply-add), so given the same statistics the forward's
output is the plain version's bit for bit.

The kernels are also registered as ``torch.library`` operators (the two
statistics steps, the apply step, whose gradient is the backward's
operator, and the backward), which :func:`batch_norm_leaky_relu` calls
while ``torch.export`` or ``torch.compile`` traces it, so that they record
the kernels' calls; an exported program runs them once this module is
imported. Called eagerly, it launches the same kernels under one
``torch.autograd.Function``, whose host time a layer is a third of the
operators' dispatch. It takes CUDA tensors only and raises for any
other: its plain version is the port's ``BatchNorm`` followed by
``F.leaky_relu`` (``models/vae.py``, whose ``norm_leaky_relu`` chooses
between the two). The apply kernel's launches count in
:func:`batch_norm_leaky_relu`'s ``launches``, the backward's in
:func:`batch_norm_leaky_relu_grad`'s (:func:`launch_counts`). Triton is
imported only at the first launch.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from midi_vae_tpu_torch.ops.fused_elbo import _FLOAT_DTYPES

_BLOCK_P = 128  # pixels of a tile
_BLOCK_C = 32  # channels of a tile
_BLOCK_G = 64  # partial rows a finalize step sums
_REDUCE_PROGRAMS = 2048  # programs of a reduction kernel (pixel groups × channel blocks), at most
_MAX_OFFSET = 2**31  # element offsets are int32
_NAMESPACE = "midi_vae_tpu_torch"  # of the torch.library operators
KERNEL_DTYPES = _FLOAT_DTYPES  # of x and of the output


# ================================================================ Triton kernels


@functools.lru_cache(maxsize=None)
def _kernels():
    """Define the Triton kernels (imports triton; first launch only)."""
    import triton
    import triton.language as tl
    from triton.language.extra import libdevice

    pixel_args = ["P", "HW", "W", "n_tiles"]  # sizes that change from layer to layer: no specialization

    @triton.jit
    def _pixel_offsets(p, HW, W, sN, sH, sW):
        # element offset of pixel p (flat over n, h, w) under strides (sN, sH, sW)
        n = p // HW
        r = p - n * HW
        h = r // W
        return n * sN + h * sH + (r - h * W) * sW

    @triton.jit
    def _normalize(x, mean, mul, bias):
        # (x − mean)·mul + bias in f32, each step rounded as the plain version rounds it
        return libdevice.add_rn(libdevice.mul_rn(x - mean[None, :], mul[None, :]), bias[None, :])

    @triton.jit(do_not_specialize=pixel_args)
    def _bn_stats_kernel(x_ptr, part_ptr, P, HW, W, n_tiles, C, sN, sH, sW, sC,
                      BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr):
        # program (g, cb) sums pixel tiles g, g + G, g + 2G, ... of channel block cb into partial row g
        pid = tl.program_id(0)
        n_cb = tl.cdiv(C, BLOCK_C)
        cb, g = pid % n_cb, pid // n_cb
        G = tl.num_programs(0) // n_cb
        cols = cb * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        acc = tl.zeros([BLOCK_P, BLOCK_C], dtype=tl.float32)
        acc2 = tl.zeros([BLOCK_P, BLOCK_C], dtype=tl.float32)
        for t in range(g, n_tiles, G):
            p = t * BLOCK_P + tl.arange(0, BLOCK_P)
            off = _pixel_offsets(p, HW, W, sN, sH, sW)
            m = (p < P)[:, None] & cmask[None, :]
            x = tl.load(x_ptr + off[:, None] + cols[None, :] * sC, mask=m, other=0.0).to(tl.float32)
            acc += x
            acc2 += x * x
        row = part_ptr + g * 2 * C + cols
        tl.store(row, tl.sum(acc, axis=0), mask=cmask)
        tl.store(row + C, tl.sum(acc2, axis=0), mask=cmask)

    @triton.jit
    def _sum_partials(part_ptr, G, C, cols, cmask, BLOCK_G: tl.constexpr, BLOCK_C: tl.constexpr):
        # the two partial rows of every program, summed over g in a fixed order
        s = tl.zeros([BLOCK_G, BLOCK_C], dtype=tl.float32)
        s2 = tl.zeros([BLOCK_G, BLOCK_C], dtype=tl.float32)
        for g0 in range(0, G, BLOCK_G):
            rows = g0 + tl.arange(0, BLOCK_G)
            m = (rows < G)[:, None] & cmask[None, :]
            ptrs = part_ptr + rows[:, None] * 2 * C + cols[None, :]
            s += tl.load(ptrs, mask=m, other=0.0)
            s2 += tl.load(ptrs + C, mask=m, other=0.0)
        return tl.sum(s, axis=0), tl.sum(s2, axis=0)

    @triton.jit(do_not_specialize=["G"])
    def _bn_finalize_kernel(part_ptr, rm_ptr, rv_ptr, stats_ptr, G, C, inv_m, momentum, keep, eps, train, update,
                         BLOCK_G: tl.constexpr, BLOCK_C: tl.constexpr):
        # stats rows: mean, rstd, and 1.0 where the variance takes a gradient (train mode, not clamped)
        cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        if train:
            s, s2 = _sum_partials(part_ptr, G, C, cols, cmask, BLOCK_G, BLOCK_C)
            mean = libdevice.mul_rn(s, inv_m)
            raw = libdevice.add_rn(libdevice.mul_rn(s2, inv_m), -libdevice.mul_rn(mean, mean))
            var = tl.maximum(raw, 0.0)
            gate = tl.where(raw >= 0.0, 1.0, 0.0)
            if update:
                rm = tl.load(rm_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
                rv = tl.load(rv_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
                rm = libdevice.add_rn(libdevice.mul_rn(momentum, rm), libdevice.mul_rn(keep, mean))
                rv = libdevice.add_rn(libdevice.mul_rn(momentum, rv), libdevice.mul_rn(keep, var))
                tl.store(rm_ptr + cols, rm.to(rm_ptr.dtype.element_ty), mask=cmask)
                tl.store(rv_ptr + cols, rv.to(rv_ptr.dtype.element_ty), mask=cmask)
        else:
            mean = tl.load(rm_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
            var = tl.load(rv_ptr + cols, mask=cmask, other=1.0).to(tl.float32)
            gate = tl.zeros([BLOCK_C], dtype=tl.float32)
        tl.store(stats_ptr + cols, mean, mask=cmask)
        tl.store(stats_ptr + C + cols, libdevice.rsqrt(libdevice.add_rn(var, eps)), mask=cmask)
        tl.store(stats_ptr + 2 * C + cols, gate, mask=cmask)

    @triton.jit(do_not_specialize=pixel_args)
    def _bn_apply_kernel(x_ptr, y_ptr, stats_ptr, w_ptr, b_ptr, slope, P, HW, W, n_tiles, C,
                      sxN, sxH, sxW, sxC, syN, syH, syW, syC, BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr):
        pid = tl.program_id(0)
        n_cb = tl.cdiv(C, BLOCK_C)
        cb, t = pid % n_cb, pid // n_cb
        cols = cb * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        p = t * BLOCK_P + tl.arange(0, BLOCK_P)
        m = (p < P)[:, None] & cmask[None, :]
        mean = tl.load(stats_ptr + cols, mask=cmask, other=0.0)
        rstd = tl.load(stats_ptr + C + cols, mask=cmask, other=0.0)
        mul = libdevice.mul_rn(rstd, tl.load(w_ptr + cols, mask=cmask, other=0.0).to(tl.float32))
        bias = tl.load(b_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        OUT = y_ptr.dtype.element_ty
        x = tl.load(x_ptr + _pixel_offsets(p, HW, W, sxN, sxH, sxW)[:, None] + cols[None, :] * sxC,
                    mask=m, other=0.0).to(tl.float32)
        pre = _normalize(x, mean, mul, bias).to(OUT).to(tl.float32)
        y = tl.where(pre > 0.0, pre, libdevice.mul_rn(pre, slope))
        tl.store(y_ptr + _pixel_offsets(p, HW, W, syN, syH, syW)[:, None] + cols[None, :] * syC,
                 y.to(OUT), mask=m)

    @triton.jit(do_not_specialize=pixel_args)
    def _bn_grad_stats_kernel(x_ptr, dy_ptr, part_ptr, stats_ptr, w_ptr, b_ptr, slope, P, HW, W, n_tiles, C,
                           sxN, sxH, sxW, sxC, sdN, sdH, sdW, sdC, BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr):
        # partial rows of Σdz and Σdz·x̂, pixel tiles assigned as in _bn_stats_kernel
        pid = tl.program_id(0)
        n_cb = tl.cdiv(C, BLOCK_C)
        cb, g = pid % n_cb, pid // n_cb
        G = tl.num_programs(0) // n_cb
        cols = cb * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        mean = tl.load(stats_ptr + cols, mask=cmask, other=0.0)
        rstd = tl.load(stats_ptr + C + cols, mask=cmask, other=0.0)
        mul = libdevice.mul_rn(rstd, tl.load(w_ptr + cols, mask=cmask, other=0.0).to(tl.float32))
        bias = tl.load(b_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        OUT = dy_ptr.dtype.element_ty
        acc = tl.zeros([BLOCK_P, BLOCK_C], dtype=tl.float32)
        acc2 = tl.zeros([BLOCK_P, BLOCK_C], dtype=tl.float32)
        for t in range(g, n_tiles, G):
            p = t * BLOCK_P + tl.arange(0, BLOCK_P)
            m = (p < P)[:, None] & cmask[None, :]
            x = tl.load(x_ptr + _pixel_offsets(p, HW, W, sxN, sxH, sxW)[:, None] + cols[None, :] * sxC,
                        mask=m, other=0.0).to(tl.float32)
            dy = tl.load(dy_ptr + _pixel_offsets(p, HW, W, sdN, sdH, sdW)[:, None] + cols[None, :] * sdC,
                         mask=m, other=0.0).to(tl.float32)
            # LeakyReLU's backward on the rounded pre-activation, rounded to the output dtype as autograd's is
            pre = _normalize(x, mean, mul, bias).to(OUT).to(tl.float32)
            dz = tl.where(pre > 0.0, dy, libdevice.mul_rn(dy, slope).to(OUT).to(tl.float32))
            acc += dz
            acc2 += dz * ((x - mean[None, :]) * rstd[None, :])
        row = part_ptr + g * 2 * C + cols
        tl.store(row, tl.sum(acc, axis=0), mask=cmask)
        tl.store(row + C, tl.sum(acc2, axis=0), mask=cmask)

    @triton.jit(do_not_specialize=["G"])
    def _bn_grad_finalize_kernel(part_ptr, stats_ptr, coef_ptr, dw_ptr, db_ptr, G, C, inv_m, train,
                              BLOCK_G: tl.constexpr, BLOCK_C: tl.constexpr):
        # ∂bias = Σdz, ∂scale = Σdz·x̂; coef rows: the mean term Σdz/M and the variance term Σdz·x̂/M of ∂x
        cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        s, s2 = _sum_partials(part_ptr, G, C, cols, cmask, BLOCK_G, BLOCK_C)
        tl.store(db_ptr + cols, s, mask=cmask)
        tl.store(dw_ptr + cols, s2, mask=cmask)
        gate = tl.load(stats_ptr + 2 * C + cols, mask=cmask, other=0.0)
        tl.store(coef_ptr + cols, s * inv_m * train, mask=cmask)
        tl.store(coef_ptr + C + cols, s2 * inv_m * gate, mask=cmask)

    @triton.jit(do_not_specialize=pixel_args)
    def _bn_grad_apply_kernel(x_ptr, dy_ptr, dx_ptr, stats_ptr, coef_ptr, w_ptr, b_ptr, slope, P, HW, W, n_tiles, C,
                           sxN, sxH, sxW, sxC, sdN, sdH, sdW, sdC, soN, soH, soW, soC,
                           BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr):
        pid = tl.program_id(0)
        n_cb = tl.cdiv(C, BLOCK_C)
        cb, t = pid % n_cb, pid // n_cb
        cols = cb * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        p = t * BLOCK_P + tl.arange(0, BLOCK_P)
        m = (p < P)[:, None] & cmask[None, :]
        mean = tl.load(stats_ptr + cols, mask=cmask, other=0.0)
        rstd = tl.load(stats_ptr + C + cols, mask=cmask, other=0.0)
        mul = libdevice.mul_rn(rstd, tl.load(w_ptr + cols, mask=cmask, other=0.0).to(tl.float32))
        bias = tl.load(b_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        a = tl.load(coef_ptr + cols, mask=cmask, other=0.0)
        b = tl.load(coef_ptr + C + cols, mask=cmask, other=0.0)
        OUT = dy_ptr.dtype.element_ty
        x = tl.load(x_ptr + _pixel_offsets(p, HW, W, sxN, sxH, sxW)[:, None] + cols[None, :] * sxC,
                    mask=m, other=0.0).to(tl.float32)
        dy = tl.load(dy_ptr + _pixel_offsets(p, HW, W, sdN, sdH, sdW)[:, None] + cols[None, :] * sdC,
                     mask=m, other=0.0).to(tl.float32)
        pre = _normalize(x, mean, mul, bias).to(OUT).to(tl.float32)
        dz = tl.where(pre > 0.0, dy, libdevice.mul_rn(dy, slope).to(OUT).to(tl.float32))
        xhat = (x - mean[None, :]) * rstd[None, :]
        dx = mul[None, :] * (dz - a[None, :] - xhat * b[None, :])
        tl.store(dx_ptr + _pixel_offsets(p, HW, W, soN, soH, soW)[:, None] + cols[None, :] * soC,
                 dx.to(dx_ptr.dtype.element_ty), mask=m)

    return {
        "stats": _bn_stats_kernel,
        "finalize": _bn_finalize_kernel,
        "apply": _bn_apply_kernel,
        "grad_stats": _bn_grad_stats_kernel,
        "grad_finalize": _bn_grad_finalize_kernel,
        "grad_apply": _bn_grad_apply_kernel,
    }


# ================================================================ wrappers


def _strides(t: torch.Tensor) -> Tuple[int, int, int, int]:
    """(n, h, w, c) element strides of an NCHW tensor, checked to keep every offset in int32."""
    if t.numel() and sum((s - 1) * abs(st) for s, st in zip(t.shape, t.stride())) >= _MAX_OFFSET:
        raise ValueError(f"tensor of shape {tuple(t.shape)}, strides {t.stride()}: offsets beyond int32")
    n, c, h, w = t.stride()
    return n, h, w, c


def _check_inputs(x: torch.Tensor, weight: torch.Tensor, *per_channel: torch.Tensor) -> None:
    if x.ndim != 4:
        raise ValueError(f"x must be NCHW, got shape {tuple(x.shape)}")
    if x.dtype not in _FLOAT_DTYPES:
        raise TypeError(f"kernels take float32/bfloat16/float16, got {x.dtype}")
    if x.numel() == 0 or x.shape[0] * x.shape[2] * x.shape[3] >= _MAX_OFFSET:
        raise ValueError(f"kernels take 1..{_MAX_OFFSET - 1} pixels, got shape {tuple(x.shape)}")
    for t in (weight, *per_channel):
        if t.shape != (x.shape[1],) or t.dtype not in _FLOAT_DTYPES:
            raise ValueError(f"per-channel tensors must be float [{x.shape[1]}], got {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("per-channel tensors must be contiguous")


def _grid_sizes(x: torch.Tensor) -> Tuple[int, int, int, int, int]:
    """(pixels, h·w, w, pixel tiles, channel blocks) of NCHW ``x``."""
    b, c, h, w = x.shape
    pixels = b * h * w
    return pixels, h * w, w, -(-pixels // _BLOCK_P), -(-c // _BLOCK_C)


def _reduce_programs(n_tiles: int, n_cb: int) -> int:
    """Pixel groups of a reduction kernel: fixed by the shape, so the sum order is too."""
    return max(1, min(n_tiles, _REDUCE_PROGRAMS // n_cb))


def _launch_stats(x, running_mean, running_var, train: bool, update: bool, momentum: float, eps: float):
    """The f32 [3, C] the apply and backward kernels read (mean, rstd,
    variance gate): of the batch ``x`` in train mode, moving the running
    averages in place with ``update``; of the running averages otherwise."""
    if train:
        _check_inputs(x, running_mean, running_var)
    k = _kernels()
    c = running_mean.shape[0]
    n_cb = -(-c // _BLOCK_C)
    stats = torch.empty((3, c), dtype=torch.float32, device=running_mean.device)
    groups, inv_m = 0, 1.0
    if train:
        pixels, hw, w, n_tiles, _ = _grid_sizes(x)
        groups, inv_m = _reduce_programs(n_tiles, n_cb), 1.0 / pixels
    partials = torch.empty((max(groups, 1), 2, c), dtype=torch.float32, device=running_mean.device)
    with torch.cuda.device(running_mean.device):
        if train:
            k["stats"][(groups * n_cb,)](x, partials, pixels, hw, w, n_tiles, c, *_strides(x),
                                         BLOCK_P=_BLOCK_P, BLOCK_C=_BLOCK_C, num_warps=8)
        k["finalize"][(n_cb,)](partials, running_mean, running_var, stats, groups, c, inv_m, momentum,
                               1.0 - momentum, eps, int(train), int(update),
                               BLOCK_G=_BLOCK_G, BLOCK_C=_BLOCK_C, num_warps=4)
    return stats


def _launch_apply(x, weight, bias, stats, dtype: torch.dtype, slope: float):
    """y, laid out as ``torch.empty_like(x)`` lays it out: the apply kernel."""
    _check_inputs(x, weight, bias)
    k = _kernels()
    pixels, hw, w, n_tiles, n_cb = _grid_sizes(x)
    y = torch.empty_like(x, dtype=dtype)
    with torch.cuda.device(x.device):
        k["apply"][(n_tiles * n_cb,)](x, y, stats, weight, bias, slope, pixels, hw, w, n_tiles, x.shape[1],
                                      *_strides(x), *_strides(y), BLOCK_P=_BLOCK_P, BLOCK_C=_BLOCK_C, num_warps=8)
    batch_norm_leaky_relu.launches += 1
    return y


def batch_norm_leaky_relu_grad(x, dy, weight, bias, stats, *, train: bool, slope: float):
    """(dx, d_weight, d_bias) of :func:`batch_norm_leaky_relu` given the
    gradient ``dy`` of its output and the forward's ``stats``: the backward
    kernels (CUDA tensors only). dx is in x's dtype and laid out as
    ``torch.empty_like(x)`` lays it out; the parameter gradients are f32."""
    if dy.shape != x.shape:
        raise ValueError(f"dy shape {tuple(dy.shape)} differs from x's {tuple(x.shape)}")
    _check_inputs(x, weight, bias)
    k = _kernels()
    pixels, hw, w, n_tiles, n_cb = _grid_sizes(x)
    c = x.shape[1]
    groups = _reduce_programs(n_tiles, n_cb)
    dx = torch.empty_like(x)
    dw = torch.empty(c, dtype=torch.float32, device=x.device)
    db = torch.empty(c, dtype=torch.float32, device=x.device)
    partials = torch.empty((groups, 2, c), dtype=torch.float32, device=x.device)
    coef = torch.empty((2, c), dtype=torch.float32, device=x.device)
    sx, sd = _strides(x), _strides(dy)
    with torch.cuda.device(x.device):
        k["grad_stats"][(groups * n_cb,)](x, dy, partials, stats, weight, bias, slope, pixels, hw, w, n_tiles, c,
                                          *sx, *sd, BLOCK_P=_BLOCK_P, BLOCK_C=_BLOCK_C, num_warps=8)
        k["grad_finalize"][(n_cb,)](partials, stats, coef, dw, db, groups, c, 1.0 / pixels, float(train),
                                    BLOCK_G=_BLOCK_G, BLOCK_C=_BLOCK_C, num_warps=4)
        k["grad_apply"][(n_tiles * n_cb,)](x, dy, dx, stats, coef, weight, bias, slope, pixels, hw, w, n_tiles, c,
                                           *sx, *sd, *_strides(dx), BLOCK_P=_BLOCK_P, BLOCK_C=_BLOCK_C, num_warps=8)
    batch_norm_leaky_relu_grad.launches += 1
    return dx, dw, db


# ================================================================ the eager call


class _BatchNormLeakyReLU(torch.autograd.Function):
    """The kernels under one autograd node: the eager call. The operators
    below launch the same kernels, at about three times the host time a
    layer (their dispatch, ~0.2 ms a forward and backward on a CPU core),
    which an eager step pays on every layer."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, train, update, momentum, eps, dtype, slope):
        stats = _launch_stats(x, running_mean, running_var, train, update, momentum, eps)
        ctx.save_for_backward(x, weight, bias, stats)
        ctx.train, ctx.slope = train, slope
        return _launch_apply(x, weight, bias, stats, dtype, slope)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, bias, stats = ctx.saved_tensors
        dx, dw, db = batch_norm_leaky_relu_grad(x, dy, weight, bias, stats, train=ctx.train, slope=ctx.slope)
        return dx, dw.to(weight.dtype), db.to(bias.dtype), None, None, None, None, None, None, None, None


# ================================================================ operators

# Registered with torch.library, so that torch.export and torch.compile record the kernels' calls (their
# register_fake gives the outputs' shapes) and an exported program runs them once this module is imported.


@torch.library.custom_op(f"{_NAMESPACE}::batch_norm_train_stats", mutates_args=("running_mean", "running_var"),
                         device_types="cuda")
def _train_stats(x: torch.Tensor, running_mean: torch.Tensor, running_var: torch.Tensor, update: bool,
                 momentum: float, eps: float) -> torch.Tensor:
    return _launch_stats(x, running_mean, running_var, True, update, momentum, eps)


@torch.library.custom_op(f"{_NAMESPACE}::batch_norm_eval_stats", mutates_args=(), device_types="cuda")
def _eval_stats(running_mean: torch.Tensor, running_var: torch.Tensor, eps: float) -> torch.Tensor:
    return _launch_stats(None, running_mean, running_var, False, False, 0.0, eps)


@torch.library.custom_op(f"{_NAMESPACE}::batch_norm_leaky_relu", mutates_args=(), device_types="cuda")
def _apply(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, stats: torch.Tensor, train: bool,
           dtype: torch.dtype, slope: float) -> torch.Tensor:
    return _launch_apply(x, weight, bias, stats, dtype, slope)


@torch.library.custom_op(f"{_NAMESPACE}::batch_norm_leaky_relu_grad", mutates_args=(), device_types="cuda")
def _grad(x: torch.Tensor, dy: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, stats: torch.Tensor,
          train: bool, slope: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return batch_norm_leaky_relu_grad(x, dy, weight, bias, stats, train=train, slope=slope)


@_train_stats.register_fake
def _(x, running_mean, running_var, update, momentum, eps):
    return running_mean.new_empty((3, running_mean.shape[0]), dtype=torch.float32)


@_eval_stats.register_fake
def _(running_mean, running_var, eps):
    return running_mean.new_empty((3, running_mean.shape[0]), dtype=torch.float32)


@_apply.register_fake
def _(x, weight, bias, stats, train, dtype, slope):
    return torch.empty_like(x, dtype=dtype)


@_grad.register_fake
def _(x, dy, weight, bias, stats, train, slope):
    c = x.shape[1]
    return torch.empty_like(x), x.new_empty(c, dtype=torch.float32), x.new_empty(c, dtype=torch.float32)


def _save(ctx, inputs, output):
    x, weight, bias, stats, train, _, slope = inputs
    ctx.save_for_backward(x, weight, bias, stats)
    ctx.train, ctx.slope = train, slope


def _backward(ctx, dy):
    # the closed form takes the batch statistics' dependence on x in train mode, so stats take no gradient
    x, weight, bias, stats = ctx.saved_tensors
    dx, dw, db = _grad(x, dy, weight, bias, stats, ctx.train, ctx.slope)
    return dx, dw.to(weight.dtype), db.to(bias.dtype), None, None, None, None


def _on_one_card(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cuda" for t in tensors) and len({t.device for t in tensors}) == 1


_apply.register_autograd(_backward, setup_context=_save)


def batch_norm_leaky_relu(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    *,
    train: bool,
    update: bool,
    momentum: float,
    eps: float,
    dtype: torch.dtype,
    slope: float,
) -> torch.Tensor:
    """LeakyReLU(``slope``) of flax's BatchNorm over the channels of NCHW
    ``x``, with its gradient, on the kernels (CUDA tensors only; the plain
    version is ``models/vae.py``'s ``BatchNorm`` followed by
    ``F.leaky_relu``). Train: the batch's statistics, and with ``update``
    the running averages moved in place (``momentum`` of the old value).
    Eval: the running averages. Computed in f32, rounded to ``dtype``."""
    tensors = (x, weight, bias, running_mean, running_var)
    if not _on_one_card(*tensors):
        raise ValueError(f"the kernels take tensors on one CUDA device, got {sorted({str(t.device) for t in tensors})}")
    train, update, momentum, eps, slope = bool(train), bool(update), float(momentum), float(eps), float(slope)
    if not torch.compiler.is_compiling():
        return _BatchNormLeakyReLU.apply(x, weight, bias, running_mean, running_var, train, update, momentum, eps,
                                         dtype, slope)
    # torch.export or torch.compile: the operators, which they record
    if train:
        stats = _train_stats(x.detach(), running_mean, running_var, update, momentum, eps)
    else:
        stats = _eval_stats(running_mean, running_var, eps)
    return _apply(x, weight, bias, stats, train, dtype, slope)


batch_norm_leaky_relu.launches = 0
batch_norm_leaky_relu_grad.launches = 0

# kernel key → the function whose ``launches`` count it (the forward's apply kernel, the backward)
KERNEL_WRAPPERS = {"BN": batch_norm_leaky_relu, "BN-bwd": batch_norm_leaky_relu_grad}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def add_launch_counts(counts: dict) -> None:
    """Add ``counts`` (as :func:`launch_counts` gives them) to the counters:
    launches a CUDA graph's replay makes (``train/graphs.py``)."""
    for name, n in counts.items():
        KERNEL_WRAPPERS[name].launches += n

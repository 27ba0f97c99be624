"""Hopper kernels for the ELBO hot path (counterpart of
``midi_vae_tpu/ops/fused_elbo.py``).

The JAX package has three Pallas TPU kernels here; each becomes a
hand-written Triton kernel for the H100, with a plain PyTorch version of
the same function beside it:

- **K1** ``_bce_partial_kernel`` (+ ``_sum_partials_kernel``) replaces
  ``_bce_fwd_kernel`` (midi_vae_tpu/ops/fused_elbo.py:125): the mean of the
  clamped binary cross-entropy over reconstruction logits.
- **K2** ``_bce_grad_kernel`` replaces ``_bce_grad_kernel``
  (midi_vae_tpu/ops/fused_elbo.py:141): its gradient w.r.t. the logits.
- **K3** ``_reparam_kl_kernel`` (+ ``_sum_partials_kernel``) replaces
  ``_reparam_kl_kernel`` (midi_vae_tpu/ops/fused_elbo.py:48): z = mu +
  eps·exp(log_var/2) with eps drawn in the kernel, and the KL sum.

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
- K3 works on [B, D] (20,480 elements on the flagship step, ~0.2 MB): it is
  bound by launch latency, not by the card. It draws eps with Triton's
  Philox ``tl.randn(seed, offset)`` (in place of the TPU's on-core random
  bits), keyed by a seed the caller derives on the host, so no device to
  host sync is needed. It rounds z as the plain version does, as K2
  does. Its KL partials are reduced as in K1. Its backward is plain
  tensor math, as the JAX VJP is (``_reparam_kl_bwd``).

Each wrapper (:func:`bce_mean`, :func:`bce_mean_grad`, :func:`reparam_kl`)
launches its kernel for CUDA tensors and counts the launch in its
``launches`` attribute; for CPU tensors it runs the plain version, and for
any other device it raises. Triton is imported only when a kernel is first
launched; where it caches what it builds is Triton's own setting
(``TRITON_CACHE_DIR``), which this module leaves alone.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

_LOG_CLAMP = -100.0  # torch binary_cross_entropy clamps log terms at -100

_BCE_BLOCK = 4096  # elements per tile of K1/K2
_BCE_MAX_PROGRAMS = 1024  # K1 programs (and partials); fixed per n, so the sum order is fixed
_REPARAM_BLOCK = 1024  # elements per program of K3
_MAX_ELEMENTS = 2**30  # kernel offsets are int32


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
        # stage 2 of K1 and K3: one program, fixed order
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

    @triton.jit(do_not_specialize=["seed"])  # a new seed every step: no recompile for seeds ≡ 0 mod 16
    def _reparam_kl_kernel(mu_ptr, lv_ptr, z_ptr, part_ptr, n, seed, BLOCK: tl.constexpr):
        # K3: eps ~ N(0, 1) from Philox keyed by (seed, flat index)
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        mu = tl.load(mu_ptr + offs, mask=m, other=0.0).to(tl.float32)
        lv = tl.load(lv_ptr + offs, mask=m, other=0.0).to(tl.float32)
        eps = tl.randn(seed, offs)
        # z rounded step by step as the plain version's (IEEE exp, no fused
        # multiply-add), so the two agree where mu and eps·σ nearly cancel
        z = libdevice.add_rn(mu, libdevice.mul_rn(eps, libdevice.exp(0.5 * lv)))
        tl.store(z_ptr + offs, z.to(z_ptr.dtype.element_ty), mask=m)
        term = tl.where(m, 1.0 + lv - mu * mu - tl.exp(lv), 0.0)
        tl.store(part_ptr + pid, -0.5 * tl.sum(term, axis=0))

    return {
        "triton": triton,
        "bce_partial": _bce_partial_kernel,
        "sum_partials": _sum_partials_kernel,
        "bce_grad": _bce_grad_kernel,
        "reparam_kl": _reparam_kl_kernel,
    }


_FLOAT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


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


def _check_kernel_inputs(*tensors: torch.Tensor) -> None:
    shape = tensors[0].shape
    for t in tensors:
        if t.shape != shape:
            raise ValueError(f"shape mismatch: {tuple(shape)} vs {tuple(t.shape)}")
        if t.dtype not in _FLOAT_DTYPES:
            raise TypeError(f"kernel takes float32/bfloat16/float16, got {t.dtype}")
        if not t.is_contiguous():
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


def reparam_kl(mu: torch.Tensor, log_var: torch.Tensor, seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(z, kl) with eps ~ N(0, I) keyed by ``seed``: K3 on CUDA; on CPU the
    plain version with eps from a CPU ``torch.Generator`` seeded with ``seed``.

    The two devices draw different eps from the same seed (Philox in the
    kernel, torch's CPU generator here); both are standard normal.
    """
    if mu.ndim != 2:
        raise ValueError(f"mu must be [B, D], got shape {tuple(mu.shape)}")
    seed = int(seed)
    if not 0 <= seed < 2**31:
        raise ValueError(f"seed must be in [0, 2**31), got {seed}")
    if not _on_cuda(mu, log_var):
        gen = torch.Generator(device="cpu").manual_seed(seed)
        return reparam_kl_plain(mu, log_var, torch.randn(mu.shape, generator=gen, dtype=torch.float32))
    _check_kernel_inputs(mu, log_var)
    k = _kernels()
    n = mu.numel()
    n_prog = -(-n // _REPARAM_BLOCK)
    z = torch.empty_like(mu)
    partials = torch.empty(n_prog, dtype=torch.float32, device=mu.device)
    kl = torch.empty((), dtype=torch.float32, device=mu.device)
    with torch.cuda.device(mu.device):
        k["reparam_kl"][(n_prog,)](mu, log_var, z, partials, n, seed, BLOCK=_REPARAM_BLOCK, num_warps=4)
        _sum_partials(k, partials, kl, float(mu.shape[0]))
    reparam_kl.launches += 1
    return z, kl


bce_mean.launches = 0
bce_mean_grad.launches = 0
reparam_kl.launches = 0

# K-number → wrapper, in the order of the kernel table in PERF.md
KERNEL_WRAPPERS = {"K1": bce_mean, "K2": bce_mean_grad, "K3": reparam_kl}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


# ================================================================ autograd


class _FusedReparamKL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mu, log_var, seed):
        z, kl = reparam_kl(mu, log_var, seed)
        ctx.save_for_backward(mu, log_var, z)
        return z, kl

    @staticmethod
    def backward(ctx, g_z, g_kl):
        # midi_vae_tpu/ops/fused_elbo.py:106-114, in f32:
        # ∂z/∂mu = 1, ∂z/∂lv = (z − mu)/2; ∂kl/∂mu = mu/B, ∂kl/∂lv = −0.5·(1 − e^lv)/B
        mu, log_var, z = ctx.saved_tensors
        batch = mu.shape[0]
        mu32, lv32, gz = mu.float(), log_var.float(), g_z.float()
        g_kl = g_kl.float()
        d_mu = gz + g_kl * mu32 / batch
        d_lv = gz * 0.5 * (z.float() - mu32) + g_kl * (-0.5) * (1.0 - torch.exp(lv32)) / batch
        return d_mu.to(mu.dtype), d_lv.to(log_var.dtype), None


def fused_reparam_kl(mu: torch.Tensor, log_var: torch.Tensor, seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(z, kl), z = mu + eps·exp(log_var/2), kl the batch-mean Gaussian KL — K3
    forward, the JAX package's custom VJP as backward."""
    return _FusedReparamKL.apply(mu, log_var, seed)


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

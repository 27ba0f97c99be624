"""Smoke run of the PyTorch/H100 port on one CUDA device.

    python3 chip_smoke.py

From the repository root. It

1. prints the card (name and power limit, as ``nvidia-smi`` reports them)
   and the torch/triton versions;
2. builds the CUDA C++ kernels of ``midi_vae_tpu_torch/csrc/`` with
   ``nvcc``, one process per source, all at once (into this checkout's
   ``build/kernels/`` unless ``MIDI_VAE_TORCH_KERNEL_DIR`` is set), and
   prints each build's time and ptxas report (registers, shared memory,
   spills);
3. builds the Triton kernels K1 and K2 of
   ``midi_vae_tpu_torch/ops/fused_elbo.py`` (into ``build/triton/`` unless
   ``TRITON_CACHE_DIR`` is set), holds each against its plain PyTorch
   version on the card at the flagship shapes, the train CLI's batch of
   100, a ragged shape and a saturated one, and times kernel, plain
   version and the library yardstick with CUDA events;
4. holds K3 (CUDA C++) against its plain version: its noise, read back
   from K3 itself (with mu = 0 and log_var = 0 in f32 it writes z = eps
   exactly), against the plain Philox draw; its z and KL against the whole
   plain function at the flagship shape, the train CLI's [100, 10] and
   [8, 10] (a reconstruction grid), a ragged one and one past a single
   CTA's reach; its backward against the plain backward at the flagship
   shape and [100, 10], with and without a KL gradient; and times both;
5. trains the flagship FoldedVAE (fold 8, hidden (48, 64, 128, 256),
   latent 10, bf16, batch 2048 of 128×128 synthetic piano rolls, AdamW
   under OneCycle, β 2.5e-4) through the fused kernels, checks that each
   kernel ran once per step, that the loss is finite and falls, and that
   one unfused step on the same weights and batch, given the plain draw
   of the first fused step's seed, gives the same loss; then profiles
   three more steps (device time by kernel and by layer, and the device's
   busy share of the step);
6. reconstructs a batch in eval mode (posterior mean), and checks the
   model on the card against the same model on the CPU at a small batch;
7. drives the train CLI, ``midi_vae_tpu_torch.cli.train.cli``, in this
   process on ``configs/folded.yaml`` (the ``midi-synthetic`` corpus,
   generated under ``build/tmp/``; runs under ``build/cli_models/``):
   two of three epochs with ``--fused --bce-targets normalized``, checking
   that the loss falls, both checkpoints are written and each kernel
   launched exactly as often as the run's steps and eval batches need;
   the resume of that run from its latest checkpoint to epoch 3 with the
   counters carried over and the final sweeps; and one epoch of the config
   as written (raw targets, ``output_bias_init: auto``, unfused) with
   finite metrics; times the fused step alone at the CLI's batch of 100,
   with a profile (the device's busy share at that batch); and holds the
   host loader (pinned buffers, side-stream copies) against the
   device-resident one, batch for batch;
8. drives the inference side on that fused run's ``best_model.pt``
   (FoldedVAE at full width, served in f32 as the JAX package serves it):
   the generate CLI's four modes with ``.mid`` export (PNGs written, the
   files read back, values finite in [0, 1]); the evaluate CLI with IWAE-16
   (checked against IWAE-1), MIG, latents and JSON; then ``serve`` on the
   card and on the CPU, driven by ``ServingClient`` over both wires: served
   reconstructions, encodings, interpolations and samples against the
   loaded model on the card and against the CPU server (1e-4), 16 client
   threads at once (every answer checked, requests coalesced), and the
   latencies (first request per bucket, sequential single-roll p50/p99
   and its parts, /sample, under load); no fused-ELBO kernel may launch in
   any of it;
9. prints one ``{"kernels": [...]}`` line, the card line again, and as the
   last line ``{"ok": true, "device": {...}}``.

Any failed check raises and the script exits non-zero; so does a machine
without a CUDA device. TF32 is off for every comparison (cuDNN and
cuBLAS), so f32 on the card is f32.
"""

from __future__ import annotations

import copy
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from midi_vae_tpu_torch.data.synthetic import make_pianoroll_batch
from midi_vae_tpu_torch.losses.schedules import kl_weight_schedule
from midi_vae_tpu_torch.models.registry import build_model
from midi_vae_tpu_torch.models.vae import param_group_label
from midi_vae_tpu_torch.ops import cuda_lib
from midi_vae_tpu_torch.ops import fused_elbo as ops
from midi_vae_tpu_torch.train.optim import build_optimizer
from midi_vae_tpu_torch.train.state import create_train_state, derive_step_seed, make_train_step

FLAGSHIP = dict(in_channels=1, latent_dim=10, input_dim=128, hidden_dims=(48, 64, 128, 256), fold=8)
BATCH = 2048
CLI_BATCH = 100  # configs/folded.yaml's batch_size
TRAIN_STEPS = 30
KL_WEIGHT = 2.5e-4  # bench.py's constant β
OPTIMIZER = dict(optimizer="AdamW", lr=1e-3, scheduler="OneCycle", total_steps=10000)  # bench.py:127-138
TIMING_LAUNCHES = 25
SERVE_THREADS, SERVE_REQUESTS = 16, 8  # concurrent clients, requests each
SEQUENTIAL_REQUESTS = 100

# H100 SXM data sheet: HBM rate and the f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# operations per element, counted from the kernels' bodies (exp, log, sqrt, cos as one
# each); K3's draw is Philox-4x32-10 (~60 integer operations) plus Box-Muller
OPS_PER_ELEMENT = {"K1": 23, "K2": 23, "K3": 80, "K3-bwd": 3}

TRITON_SOURCE = "midi_vae_tpu_torch/ops/fused_elbo.py"
K3_SOURCE = "midi_vae_tpu_torch/csrc/reparam_kl.cu"
# key → (name, route, source, TPU kernel it replaces, fragments of its device kernels' names)
KERNEL_INFO = {
    "K1": ("K1 _bce_partial_kernel+_sum_partials_kernel (fused BCE mean)", "triton", TRITON_SOURCE,
           "midi_vae_tpu/ops/fused_elbo.py:125", ("_bce_partial_kernel", "_sum_partials_kernel")),
    "K2": ("K2 _bce_grad_kernel (fused BCE gradient)", "triton", TRITON_SOURCE,
           "midi_vae_tpu/ops/fused_elbo.py:141", ("_bce_grad_kernel",)),
    "K3": ("K3 k3_reparam_kl_fwd_kernel (reparam + KL, one cluster launch)", "cuda", K3_SOURCE,
           "midi_vae_tpu/ops/fused_elbo.py:48", ("k3_reparam_kl_fwd_kernel",)),
    "K3-bwd": ("K3-bwd k3_reparam_kl_bwd_kernel (reparam + KL backward)", "cuda", K3_SOURCE,
               "midi_vae_tpu/ops/fused_elbo.py:106", ("k3_reparam_kl_bwd_kernel",)),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, launches: int = TIMING_LAUNCHES, rounds: int = 5) -> float:
    """Per-launch time: CUDA events around ``launches`` back-to-back calls,
    divided by their number; the median of ``rounds`` such windows after
    warm-up. A call shorter than its host-side launch cost reads as that
    cost (the device waits for the host)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per_launch = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        per_launch.append(start.elapsed_time(end) / launches)
    return statistics.median(per_launch)


def bound_ms(key: str, n_elements: int, n_bytes: int):
    """(least time on the card, what bounds it): bytes over the HBM rate vs
    operations over the f32 rate, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_elements * OPS_PER_ELEMENT[key] / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k3_eps(shape, seed: int, dev) -> torch.Tensor:
    """The f32 noise K3 draws for a [B, D] input with ``seed``: with mu = 0 and
    log_var = 0 in f32 its z = 0 + eps·exp(0) is eps exactly."""
    zeros = torch.zeros(shape, dtype=torch.float32, device=dev)
    return ops.reparam_kl(zeros, zeros, seed)[0]


def ulp(x: torch.Tensor) -> torch.Tensor:
    """Spacing of numbers of x's dtype at |x|, as f32 (subnormals flushed up to the least normal)."""
    info = torch.finfo(x.dtype)
    _, e = torch.frexp(x.float().abs().clamp_min(info.tiny))
    return torch.ldexp(torch.full_like(x, info.eps, dtype=torch.float32), e - 1)


# ================================================================= kernels


def check_bce(logits, targets, g, label):
    """K1 and K2 against their plain versions on one input; returns the max errors."""
    k1 = ops.bce_mean(logits, targets)
    k1_again = ops.bce_mean(logits, targets)
    p1 = ops.bce_mean_plain(logits, targets)
    err1 = abs(float(k1) - float(p1))
    check(torch.equal(k1, k1_again), f"K1 repeat not bitwise equal ({label})")
    check(err1 <= 1e-4 * abs(float(p1)), f"K1 {float(k1)} vs plain {float(p1)} ({label})")
    k2 = ops.bce_mean_grad(logits, targets, g)
    p2 = ops.bce_mean_grad_plain(logits, targets, g)
    check(k2.dtype == logits.dtype and k2.shape == logits.shape, f"K2 dtype/shape ({label})")
    diff = (k2.float() - p2.float()).abs()
    # at most 1 ulp of the logits' dtype, taken at the larger of the two values
    beyond = int((diff > ulp(torch.maximum(k2.abs(), p2.abs()))).sum())
    check(beyond == 0, f"K2 vs plain ({label}): {beyond} elements more than 1 ulp apart, max diff {float(diff.max())}")
    log(
        f"  {label}: K1 {float(k1):.7f} plain {float(p1):.7f} |err| {err1:.3e}; K2 max |err| {float(diff.max()):.3e}, "
        f"{int((k2 != p2).sum())} of {diff.numel()} not bitwise equal, {beyond} beyond 1 ulp"
    )
    return err1, float(diff.max())


def build_phase() -> None:
    """Build the CUDA C++ kernels (one nvcc per source, all at once); print
    each build's time and ptxas report."""
    t0 = time.perf_counter()
    built = cuda_lib.build()
    log(f"  {len(built)} CUDA librar{'y' if len(built) == 1 else 'ies'} in {time.perf_counter() - t0:.2f} s "
        f"({cuda_lib.NVCC_FLAGS})")
    for name, b in built.items():
        check(b.path.is_file(), f"no library at {b.path}")
        seconds = "found built" if b.seconds is None else f"nvcc {b.seconds:.2f} s"
        log(f"  {name}: {seconds}, {b.path}")
        for line in b.ptxas.splitlines():
            if any(k in line for k in ("Compiling entry", "Used", "spill")):
                log(f"    {line.strip()}")


def kernels_phase(dev):
    """K1 and K2 against their plain versions on the card, and their timings."""
    gen = torch.Generator(device=dev).manual_seed(0)
    shape = (BATCH, 128, 128, 1)
    logits = (3.0 * torch.randn(shape, generator=gen, device=dev)).to(torch.bfloat16)
    targets, _ = make_pianoroll_batch(gen, BATCH, device=dev)
    g = torch.full((), 2.5, device=dev)
    n = logits.numel()

    build = {}
    for key, fn in (
        ("K1", lambda: ops.bce_mean(logits, targets)),
        ("K2", lambda: ops.bce_mean_grad(logits, targets, g)),
    ):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        build[key] = time.perf_counter() - t0

    cache = Path(os.environ["TRITON_CACHE_DIR"])  # build/triton/ unless the caller set it
    n_files = sum(1 for p in cache.rglob("*") if p.is_file())
    log(f"  Triton build cache: {cache} ({n_files} files)")
    check(n_files > 0, f"no Triton build output under {cache}")

    errs = {}
    errs["K1"], errs["K2"] = check_bce(logits, targets, g, f"flagship {list(shape)} bf16 logits, f32 targets")
    ragged_l = 3.0 * torch.randn((3, 5, 7, 1), generator=gen, device=dev)
    ragged_t = torch.rand((3, 5, 7, 1), generator=gen, device=dev) - 0.5
    cli_shape = (CLI_BATCH, 128, 128, 1)
    cli_t, _ = make_pianoroll_batch(gen, CLI_BATCH, device=dev)
    for label, (lg, tg) in {
        f"train CLI batch {list(cli_shape)} bf16 logits, f32 targets": (
            (3.0 * torch.randn(cli_shape, generator=gen, device=dev)).to(torch.bfloat16), cli_t - 0.5,
        ),
        "ragged [3,5,7,1] f32": (ragged_l, ragged_t),
        "ragged [3,5,7,1] bf16": (ragged_l.to(torch.bfloat16), ragged_t),
        "saturated ±150 f32": (
            torch.tensor([[150.0, -150.0, 0.5, -0.5]] * 32, device=dev),
            torch.tensor([[0.0, 1.0, 0.3, 0.7]] * 32, device=dev),
        ),
    }.items():
        e1, e2 = check_bce(lg, tg, g, label)
        errs["K1"], errs["K2"] = max(errs["K1"], e1), max(errs["K2"], e2)

    log("  first-launch (build + run) s: " + ", ".join(f"{k} {v:.2f}" for k, v in build.items()))

    # timings: kernel, plain version, library yardstick (one PyTorch call, used nowhere in the port)
    lib_logits = logits.detach().requires_grad_(True)
    lib_loss = F.binary_cross_entropy_with_logits(lib_logits, targets)
    times = {
        "K1": (
            time_ms(lambda: ops.bce_mean(logits, targets)),
            time_ms(lambda: ops.bce_mean_plain(logits, targets)),
            time_ms(lambda: F.binary_cross_entropy_with_logits(logits, targets)),
        ),
        "K2": (
            time_ms(lambda: ops.bce_mean_grad(logits, targets, g)),
            time_ms(lambda: ops.bce_mean_grad_plain(logits, targets, g)),
            time_ms(lambda: torch.autograd.grad(lib_loss, lib_logits, grad_outputs=g, retain_graph=True)),
        ),
    }
    sizes = {
        "K1": (n, n * (logits.element_size() + targets.element_size()) + 4),
        "K2": (n, n * (2 * logits.element_size() + targets.element_size()) + 4),
    }
    return errs, times, sizes


def check_k3(mu, lv, seed: int, label: str) -> float:
    """K3's forward against the whole plain function (draw included) on one
    input: z within 1 ulp of its dtype, KL rel <= 1e-5, repeat runs bitwise
    equal. Returns the larger max error."""
    z, kl = ops.reparam_kl(mu, lv, seed)
    z_again, kl_again = ops.reparam_kl(mu, lv, seed)
    check(torch.equal(z, z_again) and torch.equal(kl, kl_again), f"K3 repeat not bitwise equal ({label})")
    z_plain, kl_plain = ops.reparam_kl_plain(mu, lv, ops.k3_eps_plain(mu.shape, seed, mu.device))
    check(z.dtype == mu.dtype and z.shape == mu.shape and kl.shape == (), f"K3 dtype/shape ({label})")
    kl_err = abs(float(kl) - float(kl_plain))
    check(kl_err <= 1e-5 * abs(float(kl_plain)), f"K3 KL {float(kl)} vs plain {float(kl_plain)} ({label})")
    z_diff = (z.float() - z_plain.float()).abs()
    # at most 1 ulp of z's dtype, taken at the larger of the two values
    beyond = int((z_diff > ulp(torch.maximum(z.abs(), z_plain.abs()))).sum())
    check(bool(torch.isfinite(z).all()) and beyond == 0,
          f"K3 z vs plain ({label}): {beyond} elements more than 1 ulp apart, max diff {float(z_diff.max())}")
    log(f"  K3 {label}: KL {float(kl):.6f} plain {float(kl_plain):.6f} rel err {kl_err / abs(float(kl_plain)):.3e}; "
        f"z max |err| {float(z_diff.max()):.3e}, {int((z != z_plain).sum())} of {z.numel()} not bitwise equal, "
        f"{beyond} beyond 1 ulp; repeat bitwise equal")
    return max(kl_err, float(z_diff.max()))


def check_k3_grad(mu, lv, z, g_z, g_kl, label: str) -> float:
    """K3's backward against its plain version: each gradient within 1 ulp of its dtype."""
    got = ops.reparam_kl_grad(mu, lv, z, g_z, g_kl)
    want = ops.reparam_kl_bwd_plain(mu, lv, z, g_z, g_kl)
    worst = 0.0
    for name, k, p in zip(("d_mu", "d_lv"), got, want):
        check(k.dtype == p.dtype and k.shape == p.shape, f"K3 backward {name} dtype/shape ({label})")
        diff = (k.float() - p.float()).abs()
        beyond = int((diff > ulp(torch.maximum(k.abs(), p.abs()))).sum())
        check(bool(torch.isfinite(k).all()) and beyond == 0,
              f"K3 backward {name} ({label}): {beyond} elements beyond 1 ulp, max diff {float(diff.max())}")
        log(f"  K3 backward {label}: {name} max |err| {float(diff.max()):.3e}, {int((k != p).sum())} of {k.numel()} "
            f"not bitwise equal, {beyond} beyond 1 ulp")
        worst = max(worst, float(diff.max()))
    return worst


def k3_phase(dev):
    """K3's draw, forward and backward against their plain versions on the
    card, and their timings."""
    gen = torch.Generator(device=dev).manual_seed(3)
    shape = (BATCH, FLAGSHIP["latent_dim"])
    mu = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    lv = (0.3 * torch.randn(shape, generator=gen, device=dev)).to(torch.bfloat16)
    t0 = time.perf_counter()
    ops.reparam_kl(mu, lv, 1234)
    torch.cuda.synchronize()
    first_launch = time.perf_counter() - t0

    # the draw: K3's eps read back against the plain Philox draw on the card
    eps, eps_plain = k3_eps(shape, 1234, dev), ops.k3_eps_plain(shape, 1234, dev)
    eps_diff = (eps - eps_plain).abs()
    beyond = int((eps_diff > 2 * ulp(torch.maximum(eps.abs(), eps_plain.abs()))).sum())
    check(bool(torch.isfinite(eps).all()) and beyond == 0,
          f"K3 eps vs plain draw: {beyond} elements beyond 2 f32 ulp, max diff {float(eps_diff.max())}")
    log(f"  K3 eps {list(shape)} vs plain Philox draw: max |err| {float(eps_diff.max()):.3e}, "
        f"{int((eps != eps_plain).sum())} of {eps.numel()} not bitwise equal, {beyond} beyond 2 f32 ulp")

    errs = [check_k3(mu, lv, 1234, f"flagship {list(shape)} bf16")]
    ragged = torch.randn((3, 7), generator=gen, device=dev)
    ragged_lv = 0.3 * torch.randn((3, 7), generator=gen, device=dev)
    errs.append(check_k3(ragged, ragged_lv, 5, "ragged [3,7] f32"))
    errs.append(check_k3(ragged.half(), ragged_lv.half(), 5, "ragged [3,7] f16"))
    # the train CLI's shapes: its batch (train steps, eval batches) and a reconstruction grid's 8 samples
    cli = {}
    for b in (CLI_BATCH, 8):
        cli[b] = (torch.randn((b, shape[1]), generator=gen, device=dev).to(torch.bfloat16),
                  (0.3 * torch.randn((b, shape[1]), generator=gen, device=dev)).to(torch.bfloat16))
        errs.append(check_k3(*cli[b], 11, f"train CLI [{b},{shape[1]}] bf16"))
    big = torch.randn((65536, 16), generator=gen, device=dev).to(torch.bfloat16)
    errs.append(check_k3(big, (0.3 * torch.randn((65536, 16), generator=gen, device=dev)).to(torch.bfloat16), 77,
                         "[65536,16] bf16, 128 elements per thread"))
    mu_s = torch.full((4096, 16), 2.0, device=dev)
    lv_s = torch.full((4096, 16), math.log(0.25), device=dev)
    z_s, _ = ops.reparam_kl(mu_s, lv_s, 7)
    z_mean, z_std = float(z_s.mean()), float(z_s.std())
    check(abs(z_mean - 2.0) < 0.01 and abs(z_std - 0.5) < 0.01, f"K3 z mean {z_mean} std {z_std}")
    check(torch.equal(ops.reparam_kl(mu_s, lv_s, 7)[0], z_s), "K3 same seed, different z")
    check(not torch.equal(ops.reparam_kl(mu_s, lv_s, 8)[0], z_s), "K3 another seed, same z")
    log(f"  K3 z over [4096,16] mean {z_mean:.5f} std {z_std:.5f}; same seed same z, another seed another z")

    z, _ = ops.reparam_kl(mu, lv, 1234)
    g_z = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    bwd_errs = [
        check_k3_grad(mu, lv, z, g_z, None, "flagship bf16, no g_kl"),
        check_k3_grad(mu, lv, z, g_z, torch.full((), 5.0, device=dev), "flagship bf16, g_kl 5"),
    ]
    mu_c, lv_c = cli[CLI_BATCH]
    z_c, _ = ops.reparam_kl(mu_c, lv_c, 11)
    g_zc = torch.randn(mu_c.shape, generator=gen, device=dev).to(torch.bfloat16)
    for g_kl, what in ((None, "no g_kl"), (torch.full((), 5.0, device=dev), "g_kl 5")):
        bwd_errs.append(check_k3_grad(mu_c, lv_c, z_c, g_zc, g_kl, f"train CLI {list(mu_c.shape)} bf16, {what}"))
    log(f"  K3 first launch (run only; built above) {first_launch:.3f} s")

    n = mu.numel()
    times = {
        "K3": (
            time_ms(lambda: ops.reparam_kl(mu, lv, 1234)),
            time_ms(lambda: ops.reparam_kl_plain(mu, lv, ops.k3_eps_plain(shape, 1234, dev))),
            None,
        ),
        "K3-bwd": (
            time_ms(lambda: ops.reparam_kl_grad(mu, lv, z, g_z)),
            time_ms(lambda: ops.reparam_kl_bwd_plain(mu, lv, z, g_z)),
            None,
        ),
    }
    sizes = {
        # mu, log_var read, z written, kl (4 B) written
        "K3": (n, n * 3 * mu.element_size() + 4),
        # the main path's backward has no g_kl: mu, z, g_z read, d_mu, d_lv written (log_var is not needed)
        "K3-bwd": (n, n * 5 * mu.element_size()),
    }
    return {"K3": max(errs), "K3-bwd": max(bwd_errs)}, times, sizes


# ================================================================= train


def train_phase(dev):
    model = build_model("FoldedVAE", dtype=torch.bfloat16, fused_reparam=True, seed=0, device=dev, **FLAGSHIP)
    init_weights = copy.deepcopy(model.state_dict())
    data_gen = torch.Generator(device=dev).manual_seed(1)
    x0, _ = make_pianoroll_batch(data_gen, BATCH, device=dev)
    epoch_seed = 0
    kl_schedule = kl_weight_schedule("constant", KL_WEIGHT)

    # reference: one unfused step from the same weights and batch, given the
    # plain draw of the first fused step's seed (K3 draws the same, k3_phase)
    ref = build_model("FoldedVAE", dtype=torch.bfloat16, fused_reparam=True, seed=0, device=dev, **FLAGSHIP)
    ref.load_state_dict(init_weights)
    eps = ops.k3_eps_plain((BATCH, FLAGSHIP["latent_dim"]), derive_step_seed(epoch_seed, 0), dev)
    ref_state = create_train_state(ref, build_optimizer(ref, param_group_label, **OPTIMIZER))
    _, ref_lo, _ = make_train_step(kl_schedule, fused_loss=False)(ref_state, x0, epoch_seed, eps=eps)
    ref_loss = ref_lo.loss.item()
    del ref, ref_state

    # the main path: fused steps through K1/K2/K3, launch counts from 0
    state = create_train_state(model, build_optimizer(model, param_group_label, **OPTIMIZER))
    step = make_train_step(kl_schedule, fused_loss=True)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    losses, step_ms = [], []
    x = x0
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if i:
            x, _ = make_pianoroll_batch(data_gen, BATCH, device=dev)
        state, lo, grad_norm = step(state, x, epoch_seed)
        losses.append(lo.loss.item())  # reading the loss to the host closes the window
        step_ms.append((time.perf_counter() - t0) * 1e3)
        check(math.isfinite(losses[-1]) and math.isfinite(grad_norm.item()), f"step {i}: loss {losses[-1]}")
    counts = ops.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30

    log(f"  losses: first {losses[0]:.6f}, last five {[round(v, 6) for v in losses[-5:]]}")
    check(statistics.mean(losses[-5:]) < losses[0], "loss did not fall over the run")
    for key, c in counts.items():
        check(c == TRAIN_STEPS, f"{key} launched {c} times in {TRAIN_STEPS} fused steps")
    rel = abs(losses[0] - ref_loss) / abs(ref_loss)
    log(f"  first fused step loss {losses[0]:.7f} vs unfused step with the plain draw {ref_loss:.7f}: rel {rel:.2e}")
    check(rel <= 1e-3, "fused and unfused first-step losses differ")
    med = statistics.median(step_ms)
    log(f"  launches in {TRAIN_STEPS} fused steps: {counts}; peak memory {peak_gib:.2f} GiB")
    log(f"  throughput {BATCH * TRAIN_STEPS / sum(step_ms) * 1e3:.1f} samples/s ({BATCH * TRAIN_STEPS} samples "
        f"in {sum(step_ms):.3f} ms); step time median {med:.3f} ms, min {min(step_ms):.3f} ms, "
        f"max {max(step_ms):.3f} ms over {TRAIN_STEPS} steps, bf16, batch {BATCH}, incl. batch generation "
        f"[{card_line()}]")
    device_ms = profile_steps(state, step, data_gen, epoch_seed, dev, med)
    return model, counts, device_ms


# kernel-name fragments → layer, for the profile's breakdown (first match wins)
OUR_KERNELS = tuple(f for info in KERNEL_INFO.values() for f in info[4])
LAYERS = (
    ("K1-K3 (Triton, CUDA C++)", OUR_KERNELS),
    ("convs and dense (cuDNN, cuBLAS)", ("xmma", "cutlass", "gemm", "conv", "wgrad", "dgrad", "nvjet", "splitK")),
    ("AdamW (foreach)", ("multi_tensor_apply",)),
    ("batch generation (scatter, random)", ("scatter", "distribution", "random")),
    ("reductions (BatchNorm statistics, grad norm, loss)", ("reduce_kernel",)),
)


def profile_steps(state, step, data_gen, epoch_seed, dev, step_ms: float, n_steps: int = 3, batch: int = BATCH) -> dict:
    """Device time by kernel and by layer over a few more fused steps
    (torch.profiler), and the device's busy share of ``step_ms``, the
    median step time measured without the profiler (whose own host cost
    lengthens the profiled window). Returns each of our kernels' device ms
    per step (one call per step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            x, _ = make_pianoroll_batch(data_gen, batch, device=dev)
            state, lo, _ = step(state, x, epoch_seed)
        lo.loss.item()
        wall_us = (time.perf_counter() - t0) * 1e6

    def is_annotation(e) -> bool:
        # user annotations such as "Optimizer.step#AdamW.step" span kernels that
        # are listed on their own; kernel names may hold '#' too, as in
        # "{lambda(float)#1}", but never without a parenthesis
        return bool(getattr(e, "is_user_annotation", False)) or ("#" in e.key and "(" not in e.key)

    kernels = sorted(
        (
            e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0 and not is_annotation(e)
        ),
        key=lambda e: e.self_device_time_total, reverse=True,
    )
    busy_ms = sum(e.self_device_time_total for e in kernels) / n_steps / 1e3
    log(f"  profile of {n_steps} steps: device busy {busy_ms:.3f} ms/step, {busy_ms / step_ms:.1%} of the "
        f"{step_ms:.3f} ms median step ({wall_us / n_steps / 1e3:.3f} ms/step under the profiler), "
        f"{sum(e.count for e in kernels) // n_steps} kernels/step")
    by_layer: dict = {}
    for e in kernels:
        layer = next((name for name, frags in LAYERS if any(f in e.key for f in frags)), "other elementwise and copies")
        by_layer[layer] = by_layer.get(layer, 0.0) + e.self_device_time_total / n_steps / 1e3
    log("  device time by layer: " + "; ".join(
        f"{name} {ms:.4f} ms/step ({ms / busy_ms:.1%})" for name, ms in sorted(by_layer.items(), key=lambda kv: -kv[1])
    ))
    log("  kernels by device time:")
    for i, e in enumerate(kernels):
        if i < 15 or any(f in e.key for f in OUR_KERNELS):
            ms = e.self_device_time_total / n_steps / 1e3
            log(f"    {ms:8.4f} ms/step {ms / busy_ms:6.1%} x{e.count // n_steps:<4d} {e.key[:100]}")
    return {
        key: sum(e.self_device_time_total for e in kernels if any(f in e.key for f in info[4])) / n_steps / 1e3
        for key, info in KERNEL_INFO.items()
    }


# ============================================================= reconstruct


def reconstruct_phase(model, dev):
    """Eval-mode posterior-mean reconstruction of a batch; then the model on
    the card vs the same weights on the CPU, f32, small batch."""
    x, _ = make_pianoroll_batch(torch.Generator(device=dev).manual_seed(2), BATCH, device=dev)
    with torch.no_grad():
        recon = model.decode(model.encode(x, train=False).mu, train=False)
    check(recon.shape == (BATCH, 128, 128, 1), f"reconstruction shape {tuple(recon.shape)}")
    check(bool(torch.isfinite(recon).all()), "reconstruction not finite")
    check(float(recon.min()) >= 0.0 and float(recon.max()) <= 1.0, "reconstruction outside [0, 1]")

    small = x[:4].contiguous()
    eps = torch.randn((4, 10), generator=torch.Generator().manual_seed(3))
    gpu = build_model("FoldedVAE", seed=5, device=dev, **FLAGSHIP)
    cpu = build_model("FoldedVAE", seed=5, device="cpu", **FLAGSHIP)
    with torch.no_grad():
        errs = []
        out_g = gpu(small, train=True, eps=eps.to(dev))
        out_c = cpu(small.cpu(), train=True, eps=eps)
        errs.append(float((out_g.logits.cpu() - out_c.logits).abs().max()))
        rec_g = gpu.decode(gpu.encode(small, train=False).mu, train=False)
        rec_c = cpu.decode(cpu.encode(small.cpu(), train=False).mu, train=False)
        errs.append(float((rec_g.cpu() - rec_c).abs().max()))
    log(f"  card vs CPU, f32 batch 4: train logits max |err| {errs[0]:.3e}, eval reconstruction {errs[1]:.3e}")
    check(max(errs) <= 1e-4, "model on the card disagrees with the CPU")


# ===================================================================== cli


def expected_cli_launches(r: dict, epochs: int) -> dict:
    """Kernel launches of a fused CLI run of ``epochs`` epochs, from the
    forwards the run reports: K1, K2 and K3's backward once per train step;
    K3's forward once per train step, once per reconstruction grid and once
    per eval batch (the eval forward samples z, as the JAX package's does)."""
    f = r["forwards"]
    check(f["train_steps"] == r["steps_per_epoch"] * epochs,
          f"{f['train_steps']} train steps in {epochs} epochs of {r['steps_per_epoch']}")
    steps = f["train_steps"]
    return {"K1": steps, "K2": steps, "K3": steps + f["grid"] + f["eval_batches"], "K3-bwd": steps}


def log_cli_run(label: str, r: dict, card: str) -> None:
    c = r["corpus"]
    log(f"  {label}: corpus {c['train']} train / {c['val']} val / {c['test']} test windows, fetched in "
        f"{r['timings']['fetch_s']:.3f} s; {r['steps_per_epoch']} steps per epoch at batch {CLI_BATCH}; run "
        f"{r['duration_total']:.3f} s [{card}]")
    for h in r["history"]:
        t = h["train"]
        samples = r["steps_per_epoch"] * CLI_BATCH
        phases = ", ".join(f"{k} {v:.3f} s" for k, v in t["phase_s"].items())
        log(f"    epoch {h['epoch']}: train loss {t['loss']:.6f}, {t['throughput']:.1f} samples/s "
            f"({samples / t['throughput']:.3f} s for {samples} samples; {phases}) [{card}]")


def small_batch_steps(state, dev, card: str, batch: int = CLI_BATCH, n_steps: int = 20) -> None:
    """The CLI's fused step at its batch, alone: the median of ``n_steps``
    steps closed by reading the loss, then a profile of three more (the
    device's busy share at this batch)."""
    step = make_train_step(kl_weight_schedule("constant", KL_WEIGHT), fused_loss=True)
    data_gen = torch.Generator(device=dev).manual_seed(4)
    step_ms = []
    for _ in range(n_steps):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        x, _ = make_pianoroll_batch(data_gen, batch, device=dev)
        state, lo, _ = step(state, x, 0)
        lo.loss.item()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(step_ms)
    log(f"  fused step alone at batch {batch}: median {med:.3f} ms, min {min(step_ms):.3f} ms over {n_steps} steps "
        f"({batch / med * 1e3:.1f} samples/s) [{card}]")
    profile_steps(state, step, data_gen, 0, dev, med, batch=batch)


def loader_phase(dev, card: str) -> None:
    """The host loader (pinned buffers, copies on a side stream) against the
    device-resident one on the card: the same batches, bitwise, for a train
    epoch of the pianoroll stack (random shifts and scales) and an eval
    epoch; and each loader's time per batch."""
    from midi_vae_tpu_torch.data.fetch import fetch_dataset
    from midi_vae_tpu_torch.data.pipeline import make_loader
    from midi_vae_tpu_torch.data.transforms import get_transform

    spec_train, spec_eval = get_transform("pianoroll", 128, {"normalization": "midi-synthetic"})
    train, _, test, _ = fetch_dataset("midi-synthetic", transform_train=spec_train, transform_eval=spec_eval, device=dev)
    for ds, is_train in ((train, True), (test, False)):
        loaders = {p: make_loader(ds, CLI_BATCH, train=is_train, seed=0, device=dev, placement=p) for p in ("host", "device")}
        batches = {p: list(ldr.epoch(2)) for p, ldr in loaders.items()}
        same = all(torch.equal(a.x, b.x) and torch.equal(a.y, b.y) and torch.equal(a.mask, b.mask)
                   for a, b in zip(batches["host"], batches["device"]))
        check(len(batches["host"]) == len(batches["device"]) and same,
              f"host and device-resident loaders disagree ({'train' if is_train else 'eval'})")
        ms = {}
        for p, ldr in loaders.items():
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            n = sum(1 for _ in ldr.epoch(3))
            torch.cuda.synchronize(dev)
            ms[p] = (time.perf_counter() - t0) * 1e3 / n
        log(f"  {'train' if is_train else 'eval'} epoch, {len(batches['host'])} batches of {CLI_BATCH}: host loader and "
            f"device-resident loader bitwise equal; {ms['host']:.3f} vs {ms['device']:.3f} ms per batch [{card}]")


def cli_phase(dev, root: Path, card: str) -> dict:
    """The train CLI on ``configs/folded.yaml``: a fused run of two of three
    epochs, its resume, and one epoch of the config as written. Returns the
    kernel launches of the fused run."""
    from midi_vae_tpu_torch.cli import train as train_cli

    models = root / "build" / "cli_models"
    shutil.rmtree(models, ignore_errors=True)
    tmp = root / "build" / "tmp"  # the synthetic corpus is generated anew, inside the checkout
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    tempfile.tempdir = str(tmp)
    config = str(root / "configs" / "folded.yaml")
    fused = ["--config", config, "--fused", "--bce-targets", "normalized", "--epochs", "3", "--seed", "0"]

    ops.reset_launch_counts()
    r1 = train_cli.cli(fused + ["--stop-after-epochs", "2", "--models-dir", str(models), "--run-name", "cli",
                                "--run-id", "fused"])
    counts = ops.launch_counts()
    log_cli_run("fused, epochs 1-2 of 3", r1, card)
    want = expected_cli_launches(r1, 2)
    log(f"  launches {counts}, expected {want}")
    check(counts == want, f"fused CLI run launched {counts}, expected {want}")
    losses = [h["train"]["loss"] for h in r1["history"]]
    check(len(losses) == 2 and all(math.isfinite(v) for v in losses) and losses[1] < losses[0],
          f"train loss did not fall from epoch 1 to 2: {losses}")
    run_dir = models / "midi-synthetic" / "cli__fused"
    latest, best = run_dir / "checkpoint_latest.pt", run_dir / "best_model.pt"
    check(latest.is_file() and best.is_file(), f"checkpoints missing under {run_dir}")
    log(f"  epoch losses {losses}; {latest.name} and {best.name} written")

    small_batch_steps(r1["state"], dev, card)
    loader_phase(dev, card)

    ops.reset_launch_counts()
    r2 = train_cli.cli(fused + ["--checkpoint", str(latest)])
    counts2 = ops.launch_counts()
    log_cli_run("resumed, epoch 3", r2, card)
    check(r2["start_epoch"] == 3 and [h["epoch"] for h in r2["history"]] == [3], "resume did not run epoch 3 alone")
    check(r2["total_step"] == r1["total_step"] + r1["steps_per_epoch"], f"total_step {r2['total_step']}")
    check(r2["n_samples_seen"] == r1["n_samples_seen"] + r1["steps_per_epoch"] * CLI_BATCH,
          f"n_samples_seen {r2['n_samples_seen']}")
    check(all(k in r2 for k in ("final_test", "final_train")), "final sweeps missing after the resume")
    want2 = expected_cli_launches(r2, 1)
    check(counts2 == want2, f"resumed CLI run launched {counts2}, expected {want2}")
    log(f"  resumed at epoch 3: total_step {r1['total_step']} -> {r2['total_step']}, n_samples_seen "
        f"{r1['n_samples_seen']} -> {r2['n_samples_seen']}; launches {counts2}; final test "
        f"cross-entropy {r2['final_test']['cross-entropy']:.6f}")

    ops.reset_launch_counts()
    r3 = train_cli.cli(["--config", config, "--epochs", "1", "--seed", "0", "--models-dir", str(models),
                        "--run-name", "cli", "--run-id", "as-written"])
    log_cli_run("configs/folded.yaml as written (raw targets, auto bias, unfused), 1 epoch", r3, card)
    metrics = [r3["train"]["loss"]] + [r3[p][k] for p in ("test", "final_test", "final_train")
                                       for k in ("cross-entropy", "bce-objective", "kl", "mse", "mae")]
    check(all(math.isfinite(v) for v in metrics), f"non-finite metrics in the as-written run: {metrics}")
    check(ops.launch_counts() == {k: 0 for k in ops.KERNEL_WRAPPERS}, "the unfused run launched a kernel")
    log(f"  as written: train loss {r3['train']['loss']:.6f}, final test bce-objective "
        f"{r3['final_test']['bce-objective']:.6f}, active units {r3['final_test']['active-units']}; no kernel launched")
    return counts


# =================================================================== serve


def quantile_ms(seconds: list, q: int) -> float:
    """The q-th percentile (1..99) of host-clock seconds, in ms."""
    return statistics.quantiles([s * 1e3 for s in seconds], n=100, method="inclusive")[q - 1]


def timed(fn, n: int) -> list:
    """Host-clock seconds of ``n`` calls of ``fn``, each call closed by its own result."""
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return out


def device_ms_per_call(fn, dev, n: int = 20):
    """(device ms, kernels) per call of ``fn``: the kernels' device time and
    count in a torch.profiler trace of ``n`` calls, over ``n``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize(dev)
    kernels = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
        and not ("#" in e.key and "(" not in e.key)
    ]
    return sum(e.self_device_time_total for e in kernels) / n / 1e3, sum(e.count for e in kernels) / n


def generate_and_evaluate(ckpt: Path, out: Path, card: str) -> None:
    """The generate CLI's four modes (with .mid export, the threshold
    calibrated once) and the evaluate CLI (IWAE-16 and IWAE-1, MIG, latents,
    JSON) on the checkpoint, in this process."""
    import numpy as np

    from midi_vae_tpu_torch.cli import evaluate as evaluate_cli
    from midi_vae_tpu_torch.cli import generate as generate_cli
    from midi_vae_tpu_torch.midi.smf import read_smf

    modes = {
        "sample": (["-n", "16", "--export-threshold", "auto"], 16),
        "reconstruct": (["-n", "16"], 32),  # input | reconstruction pairs
        "interpolate": (["--steps", "8", "--slerp"], 8),
        "traverse": (["--steps", "8"], FLAGSHIP["latent_dim"] * 8),
    }
    for mode, (extra, n) in modes.items():
        png, mid = out / f"{mode}.png", out / f"mid_{mode}"
        t0 = time.perf_counter()
        images = generate_cli.cli(["--checkpoint", str(ckpt), "--mode", mode, "--out", str(png),
                                   "--export-midi", str(mid)] + extra)
        seconds = time.perf_counter() - t0
        check(images.shape == (n, 128, 128, 1), f"generate {mode}: shape {images.shape}")
        check(bool(np.isfinite(images).all()) and images.min() >= 0.0 and images.max() <= 1.0,
              f"generate {mode}: values outside [0, 1]")
        check(png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n", f"generate {mode}: {png} is no PNG")
        files = sorted(mid.glob("*.mid"))
        notes = [read_smf(str(f)) for f in files]
        check(len(files) == n and all(len(k) == 0 or int(k.pitch.max()) < 128 for k in notes),
              f"generate {mode}: {len(files)} readable .mid files, expected {n}")
        log(f"  generate --mode {mode} {' '.join(extra)}: {list(images.shape)} in [{images.min():.4f}, "
            f"{images.max():.4f}], {png.name}, {n} .mid files ({sum(len(k) for k in notes)} notes) read back; "
            f"{seconds:.3f} s [{card}]")

    t0 = time.perf_counter()
    res = evaluate_cli.cli(["--checkpoint", str(ckpt), "--partition", "test", "--iwae-samples", "16", "--mig",
                            "--latents-out", str(out / "latents.npz"), "--json", str(out / "eval.json")])["test"]
    seconds = time.perf_counter() - t0
    one = evaluate_cli.cli(["--checkpoint", str(ckpt), "--partition", "test", "--iwae-samples", "1"])["test"]
    keys = ("cross-entropy", "mse", "mae", "kl", "f1", "mig", "iwae-16")
    check(all(math.isfinite(res[k]) for k in keys), f"evaluate: non-finite metrics {res}")
    latents = np.load(out / "latents.npz")["latents_test"]
    check(latents.shape == (res["count"], FLAGSHIP["latent_dim"]) and bool(np.isfinite(latents).all()),
          f"evaluate: latents {latents.shape}")
    check(json.loads((out / "eval.json").read_text())["test"]["count"] == res["count"], "evaluate: JSON")
    check(res["iwae-16"] >= one["iwae-1"], f"IWAE-16 {res['iwae-16']} below IWAE-1 {one['iwae-1']}")
    log(f"  evaluate --partition test ({res['count']} windows): cross-entropy {res['cross-entropy']:.6f}, "
        f"kl {res['kl']:.5f}, f1 {res['f1']:.3f} %, mig {res['mig']:.5f}, iwae-16 {res['iwae-16']:.4f} >= "
        f"iwae-1 {one['iwae-1']:.4f} nat/sample; {seconds:.3f} s [{card}]")


def serve_phase(dev, root: Path, card: str) -> None:
    """The inference side on the fused CLI run's ``best_model.pt``
    (``configs/folded.yaml`` at full width): generate and evaluate, then the
    HTTP server on the card, held against the loaded model on the card and
    against the same checkpoint served on the CPU, under sequential and
    concurrent clients, with its latencies. No kernel of ``ops/fused_elbo.py``
    may launch: the inference model draws z plainly, as the JAX package's."""
    import numpy as np

    from midi_vae_tpu_torch.cli.generate import _fetch_eval_batch, _load_model_and_state
    from midi_vae_tpu_torch.evaluation.inference import interpolate, sample_prior
    from midi_vae_tpu_torch.serving.client import ServingClient
    from midi_vae_tpu_torch.serving.server import serve
    from midi_vae_tpu_torch.serving.wire import npy_dumps, npy_loads

    t_phase = time.perf_counter()
    ckpt = root / "build" / "cli_models" / "midi-synthetic" / "cli__fused" / "best_model.pt"
    out = root / "build" / "serve"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    ops.reset_launch_counts()

    generate_and_evaluate(ckpt, out, card)

    model, cfg, size, _, dataset = _load_model_and_state(str(ckpt), device=dev)
    x_dev, _, _ = _fetch_eval_batch(dataset, None, size, 16, cfg, dev)
    x = x_dev.cpu().numpy()
    servers = {"card": serve(str(ckpt), port=0), "cpu": serve(str(ckpt), port=0, device="cpu")}
    try:
        url = {k: f"http://127.0.0.1:{h.server_address[1]}" for k, h in servers.items()}
        client = ServingClient(url["card"])
        service = servers["card"].service

        # the first request of each bucket: the card meets the batch shape for the first time
        first = {}
        for n in (1, 2, 4, 8, 16):
            first[n] = [timed(lambda: client.reconstruct(x[:n]), 1)[0], timed(lambda: client.reconstruct(x[:n]), 1)[0]]
        log("  /reconstruct npy, first and second request per bucket: " + "; ".join(
            f"{n}: {a * 1e3:.3f} / {b * 1e3:.3f} ms" for n, (a, b) in first.items()) + f" [{card}]")

        # served vs the loaded model on the card, and vs the checkpoint served on the CPU
        rows = x[:5]  # padded to bucket 8 by the server
        with torch.inference_mode():
            enc = model.encode(x_dev[:5], train=False)
            direct = {"reconstruct": model.decode(enc.mu, train=False).cpu().numpy(),
                      "encode": torch.cat([enc.mu, enc.log_var], -1).cpu().numpy(),
                      "interpolate": interpolate(model, x_dev[:1], x_dev[1:2], steps=8, mode="slerp")[:, 0].cpu().numpy(),
                      "sample": sample_prior(model, 16, 3).cpu().numpy()}
        errs = {}
        for wire in ("npy", "json"):
            got = {}
            for where in ("card", "cpu"):
                c = ServingClient(url[where], wire=wire)
                got[where] = {"reconstruct": c.reconstruct(rows), "encode": np.concatenate(c.encode(rows), axis=1),
                              "interpolate": c.interpolate(x[0], x[1], steps=8, slerp=True), "sample": c.sample(16, 3)}
            for key, want in direct.items():
                check(got["card"][key].shape == want.shape and bool(np.isfinite(got["card"][key]).all()),
                      f"served {key} ({wire}): shape {got['card'][key].shape}")
                errs[(wire, key, "direct")] = float(np.abs(got["card"][key] - want).max())
                errs[(wire, key, "cpu")] = float(np.abs(got["card"][key] - got["cpu"][key]).max())
        worst = max(errs.values())
        log("  served on the card vs the loaded model on the card / the checkpoint served on the CPU, max |err| "
            "(f32, TF32 off): " + "; ".join(f"{w} {k} {e:.3e}" for (w, k, _), e in errs.items() if _ == "direct")
            + " / " + "; ".join(f"{w} {k} {e:.3e}" for (w, k, _), e in errs.items() if _ == "cpu"))
        check(worst <= 1e-4, f"served outputs disagree: {errs}")

        # sequential single-roll requests over npy, after warm-up
        one = x[:1]
        timed(lambda: client.reconstruct(one), 10)
        seq = timed(lambda: client.reconstruct(one), SEQUENTIAL_REQUESTS)
        samples = timed(lambda: client.sample(16, 0), 20)
        # where a single-roll request's time goes: the batcher in process
        # (queue, wait window, dispatch), the dispatch alone (copy in,
        # forward, copy out), the device's share of it, the npy wire
        padded = np.ascontiguousarray(one)
        in_process = timed(lambda: service.reconstruct(one), SEQUENTIAL_REQUESTS)
        dispatch = timed(lambda: service._reconstruct_rows(padded), SEQUENTIAL_REQUESTS)
        device, n_kernels = device_ms_per_call(lambda: service._reconstruct_rows(padded), dev)
        wire = timed(lambda: npy_loads(npy_dumps(npy_loads(npy_dumps(one)))), SEQUENTIAL_REQUESTS)
        p50 = {k: quantile_ms(v, 50) for k, v in
               (("seq", seq), ("in_process", in_process), ("dispatch", dispatch), ("wire", wire))}
        log(f"  /reconstruct, 1 roll, npy, sequential ({SEQUENTIAL_REQUESTS} after 10 warm-up): p50 "
            f"{p50['seq']:.3f} ms, p99 {quantile_ms(seq, 99):.3f} ms [{card}]")
        log(f"  its parts (p50): HTTP and handler {p50['seq'] - p50['in_process']:.3f} ms (of which npy encode and "
            f"parse, both ways, {p50['wire']:.3f} ms); batcher queue and wait window "
            f"{p50['in_process'] - p50['dispatch']:.3f} ms (max_wait_ms {service.reconstruct.max_wait * 1e3:g}); "
            f"dispatch {p50['dispatch']:.3f} ms = device {device:.4f} ms ({n_kernels:.0f} kernels and copies) + host "
            f"{p50['dispatch'] - device:.3f} ms (copy in, launches, copy out) [{card}]")
        log(f"  /sample n=16, npy, sequential (20): p50 {quantile_ms(samples, 50):.3f} ms, "
            f"p99 {quantile_ms(samples, 99):.3f} ms [{card}]")

        # concurrent clients: each answer is its own request's, and requests coalesce
        before = client.healthz()
        rng = np.random.default_rng(0)
        plan = [[(int(s), int(n)) for s, n in zip(rng.integers(0, 12, SERVE_REQUESTS), rng.integers(1, 5, SERVE_REQUESTS))]
                for _ in range(SERVE_THREADS)]
        with torch.inference_mode():
            want = {(s, n): model.decode(model.encode(x_dev[s : s + n], train=False).mu, train=False).cpu().numpy()
                    for reqs in plan for s, n in reqs}
        latencies, errors = [], []

        def worker(reqs):
            c = ServingClient(url["card"])
            try:
                for s, n in reqs:
                    t0 = time.perf_counter()
                    got = c.reconstruct(x[s : s + n])
                    latencies.append(time.perf_counter() - t0)
                    if got.shape != (n, 128, 128, 1) or float(np.abs(got - want[(s, n)]).max()) > 1e-4:
                        errors.append(f"request ({s}, {n}): wrong answer")
            except Exception as e:  # noqa: BLE001 - every failure is reported below
                errors.append(repr(e))

        threads = [threading.Thread(target=worker, args=(reqs,)) for reqs in plan]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads), "concurrent clients did not finish")
        after = client.healthz()
        served_n = after["requests_served"] - before["requests_served"]
        batches = after["batches_dispatched"] - before["batches_dispatched"]
        check(not errors and len(latencies) == SERVE_THREADS * SERVE_REQUESTS, f"concurrent load: {errors[:5]}")
        check(served_n == SERVE_THREADS * SERVE_REQUESTS and batches < served_n,
              f"{served_n} requests in {batches} device batches: no coalescing")
        rolls = sum(n for reqs in plan for _, n in reqs)
        log(f"  /reconstruct under load, {SERVE_THREADS} threads x {SERVE_REQUESTS} requests of 1-4 rolls (npy): "
            f"all {served_n} correct, {batches} device batches ({served_n / batches:.2f} requests per batch), "
            f"latency p50 {quantile_ms(latencies, 50):.3f} ms, p99 {quantile_ms(latencies, 99):.3f} ms, "
            f"{rolls / wall:.1f} rolls/s over {wall:.3f} s [{card}]")
    finally:
        for h in servers.values():
            h.shutdown()
            h.server_close()
            h.service.close()

    counts = ops.launch_counts()
    check(counts == {k: 0 for k in ops.KERNEL_WRAPPERS}, f"the inference path launched a fused-ELBO kernel: {counts}")
    log(f"  launches across the serve phase (generate, evaluate, serve): {counts}; the phase took "
        f"{time.perf_counter() - t_phase:.1f} s")


# ==================================================================== main


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    check(torch.cuda.device_count() == 1, f"needs exactly one visible CUDA device, found {torch.cuda.device_count()}")
    root = Path(__file__).resolve().parent
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton"))
    os.environ.setdefault(cuda_lib.BUILD_DIR_ENV, str(root / "build" / "kernels"))
    import triton

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}), triton {triton.__version__}; TF32 off (cuDNN, cuBLAS)")

    t0 = time.perf_counter()
    log("build the CUDA C++ kernels:")
    build_phase()
    log("K1, K2 (Triton) vs plain versions on the card:")
    errs, times, sizes = kernels_phase(dev)
    log("K3 (CUDA C++) vs plain versions on the card:")
    for part, more in zip((errs, times, sizes), k3_phase(dev)):
        part.update(more)
    log(f"train ({TRAIN_STEPS} fused steps, flagship FoldedVAE):")
    model, counts, device_ms = train_phase(dev)
    log("reconstruct:")
    reconstruct_phase(model, dev)
    log("train CLI (configs/folded.yaml):")
    cli_counts = cli_phase(dev, root, card)
    log("inference (generate, evaluate, serve) on the fused run's best_model.pt:")
    serve_phase(dev, root, card)

    kernels = []
    for key, (name, route, source, replaces, _) in KERNEL_INFO.items():
        ms, plain_ms, library_ms = times[key]
        bound, bound_by = bound_ms(key, *sizes[key])
        kernels.append(
            {
                "name": name,
                "route": route,
                "source": source,
                "replaces": replaces,
                "launches": counts[key],
                "cli_launches": cli_counts[key],
                "max_abs_err": errs[key],
                "ms": ms,
                "device_ms": device_ms[key],
                "plain_ms": plain_ms,
                "bound_ms": bound,
                "bound_by": bound_by,
                "library_ms": library_ms,
            }
        )
        log(f"  {key}: {ms:.4f} ms, device {device_ms[key]:.4f} ms (plain {plain_ms:.4f}, library {library_ms}, "
            f"bound {bound:.7f} by {bound_by})")
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

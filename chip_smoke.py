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
   then runs the fused BatchNorm + LeakyReLU of ``ops/fused_norm.py``
   (Triton, forward and backward) at each of the flagship's eight BatchNorm
   layers (batch 2048, bf16, train mode): its launches, its output and
   gradients against the plain version (the port's ``BatchNorm`` and
   ``F.leaky_relu``; dx within 2e-4 of its norm, ∂scale and ∂bias within
   1e-5), and its device time beside the bytes bound, the plain version's
   and ``F.batch_norm`` + ``F.leaky_relu`` (cuDNN's BatchNorm, the library
   yardstick, used nowhere in the port); then the VQ quantizer's search and
   sums kernels (CUDA C++, ``ops/vq_search.py``) at the VQ config's 512
   codes of 16 dimensions, for N = 524,288 and 25,600 vectors (batch 2048
   and 100), train mode: one launch of each a call, indices equal to the
   plain version's but at near-ties, z_q bitwise, counts exact, sums within
   f32 reordering, and their device time beside the f64 bound
   (``bench_cuda/counts_vq.py``), the plain version's and ``torch.cdist`` +
   ``argmin``'s (the library yardstick, used nowhere in the port);
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
9. drives the two-stage VQ path of ``configs/vq16_fold8.yaml`` on the same
   ``midi-synthetic`` corpus: the train CLI on the FoldedVQVAE at full width
   for 2 of its 60 epochs (loss falls, codebook perplexity and active codes
   above 1, checkpoints written; the VQ kernels launched as its forwards
   predict: the search once a forward, the sums once a train forward), the
   VQ step alone at batch 100 (its
   device busy share and the quantizer's share of device time), the model
   on the card against the CPU (decode within 1e-4, code indices equal but
   at near-ties), the prior trainer on the config's transformer for 2 of
   its 40 epochs with 2 of its 10 augment passes (NLL falls, held-out NLL
   below log K), its resume to epoch 3 and one epoch of the PixelCNN;
   ``generate --prior`` in sample mode (top_p 1.0 and 0.9) and continue
   mode with ``.mid`` export, the forced codes checked at the sampler;
   ``evaluate --codes-out``; both priors' ancestral samplers timed (ms per
   position, launches per position); the prior's train step at batch 256;
   and ``serve`` on the card with ``--prior``: /sample against the direct
   sampler and decoder, /continue, /healthz, latencies. The fused-ELBO
   kernels launch 0 times in all of it (the VQ objective refuses them);
10. drives the training variants through the train CLI at full width:
   ``configs/folded.yaml`` with ``--fused --grad-accum 2`` for one epoch
   (K1, K2, K3 and K3's backward launch once per micro-batch, counted from
   the run's forwards; one accumulated fused step against the unfused
   step given the plain draws of both micro seeds; the step timed and
   profiled at batch 100); ``configs/vq16_fold8.yaml`` with ``--grad-accum
   2`` (the quantizer's buffers move); ``configs/beta_tc_vae.yaml`` for 2
   of its 100 epochs (loss falls; the β-TC loss on the card against the
   CPU, and MI, TC, DWKL); ``configs/conditional_mnist.yaml``'s model and
   optimizer on ``vae-lines-large-synthetic`` at 128 px, fused, for 2
   epochs, then ``generate --label``, the class sweep, ``evaluate``, and
   ``serve`` with labels over both wires and under 16 threads of mixed
   classes; a class-conditional prior over the VQ run served with a label;
   MLPVAE at (512, 256), fused, card against CPU; each optimizer for one
   epoch and AdamW under the cosine and step schedules (the logged LRs
   against torch's schedulers, each step timed); last, K1, K2, K3 and K3's
   backward against their plain versions at the shape and dtype of each
   fused run (bf16 micro-batch of 50, f32 conditional batch of 128, f32
   MLPVAE batch of 100). No fused-ELBO kernel launches on the β-TC, VQ and
   optimizer runs;
11. drives the remaining model variants at full width: the flagship fused
   step (train phase's configuration) under ``--norm batch-sub4`` for 30
   steps, under ``--remat`` for 10 and under ``--norm none`` with and
   without ``--remat`` for 10 each (K1–K3 once per step, the first fused
   step against the unfused one, samples/s beside the train phase's
   window, device busy share and BatchNorm's share of device time against
   the same step with ``--norm none``, peak memory); remat on against off
   (loss within 1e-5 relative, BatchNorm buffers identical); VanillaVAE at
   its reference widths, 128 px, through the train CLI for one epoch each
   plain, plain ``--fused``, ``--stem s2d --head d2s --fused``, ``--norm
   group`` and ``--norm none`` (card against CPU, 1e-4; the step timed at
   batch 100, each variant's device time against the plain step's); a
   reference ``state_dict`` through a torch_compat model on the card
   (bitwise back, forward against the CPU) and one ``--torch-compat``
   epoch; K1–K3 against their plain versions at the fused runs' shapes;
12. exports the fused CLI run's ``best_model.pt`` with
   ``interop/aot_export.py`` for ``cuda`` and serves it with ``serve
   --artifact``: every endpoint within 1e-5 of the checkpoint server,
   export and load times, program sizes, single-roll ``/reconstruct``
   p50/p99 beside the checkpoint server's; exports the VQ run with its
   transformer prior and serves it: the loader's code draws equal to
   ``sample_codes_autoregressive`` for the seed, ``/sample`` within 1e-5 of
   the checkpoint server with ``--prior``. No fused-ELBO kernel launches
   there;
13. trains on several ranks (``midi_vae_tpu_torch/parallel/``): the
   flagship fused step over a one-rank NCCL group for 10 steps on the auto
   and the ``shard_map`` step, each against the non-distributed step on
   the same weights and batches (losses bitwise equal or within 1e-6
   relative; K1–K3 once per step; collectives per step by kind; step time
   beside the train phase's); two ranks sharing the card over gloo at
   batch 1024 each against one rank at 2048 for 3 auto steps (first loss
   within 1e-3 relative, the parameter update within 0.1 of one rank's,
   K1–K3 once per rank per step) and 3 ``shard_map`` steps (finite, the
   ranks' parameters bitwise equal after each); the train CLI with
   ``--num-devices 1 --step-impl shard_map`` for one epoch (launches from
   its forwards) and its refusal of ``--num-devices 2`` on one card. K3 in
   two halves at Philox counter offsets 0 and b·D equals the unsplit
   launch bitwise (item 4);
14. drives the data and utility modules: builds the host C++ libraries
   (g++), writes an RRD of 16,384 rolls from the on-device generator
   (256 MiB) and runs ``data.stats`` on it; one epoch of
   ``configs/folded.yaml`` at full width, fused, on ``rrd:<file>`` with
   ``--data-placement host`` (the native threaded loader: the batches it
   served counted, K1–K3 launched as the run's forwards predict, samples/s,
   the loader's wait per batch and share of the epoch, then 20 steps of
   the stream loop timed and profiled for the device's busy share); the
   same corpus device-resident at ``--scan-steps 1`` and ``16`` (every
   per-step loss bitwise equal, samples/s and host syncs of each); the
   ``midi-synthetic`` corpus's 512 files parsed natively and in Python
   (identical note arrays, ms per file); two fresh train processes with
   one new ``--compilation-cache DIR`` (the second builds nothing); the
   backend probe, then ``serve --checkpoint`` of the stream run in a
   process of its own (probe, ``--compilation-cache``) answering one
   ``/reconstruct`` against the CPU; ``--checkpoint-backend orbax``: one
   epoch resumed for a second against two straight epochs, bitwise; the
   JAX package's ``.msgpack`` fixture evaluated, reconstructed and served
   on the card against the CPU (1e-4) and a ``--pretrained`` run from it;
   the same run's JAX Orbax directory read without JAX (every leaf bitwise
   the ``.msgpack`` fixture's; the load's time and the zstd decoder's MB/s
   on the host), then evaluated, reconstructed, served and warm-started
   from as the ``.msgpack`` was; ``--allow-download-dataset``'s MNIST
   download from a loopback server (files byte-equal, datasets equal);
15. drives the port's public surface: (i) copies what a wheel of the
   checkout ships (``pyproject.toml``'s packages and package data) into a
   fresh directory and, in a process of its own whose path holds nothing
   else of this repository, builds the host C++ libraries with g++ and K3
   with nvcc from that copy, reads the JAX Orbax fixture, parses a ``.mid``
   file, decodes a PNG and holds one K3 launch against its plain version;
   (ii) writes 1,024 on-device rolls as the ``sageev-smoke`` PNG folder
   (``write_image_folder``) and loads it back bitwise with no cache
   (``load_image_folder``, the port's PNG decoder, Pillow blocked), then
   trains a ``VanillaVAE`` subclass registered with ``register_model`` on
   it for one fused epoch through ``cli.train --model`` (launches from the
   run's forwards; K1–K3 against their plain versions at its shapes);
   (iii) ``rasterize_batch`` and ``augment_pianoroll`` on the card bitwise
   the CPU; (iv) ``examples/torch_end_to_end.py`` (64 files, 2 epochs) and
   ``examples/torch_migrate_from_reference.py`` on the card, each exiting
   0; (v) the phase's seconds;
16. reads YAML without PyYAML (blocked for the phase; the GPU machine
   has none): each ``tests/fixtures/yaml_forms/*.yaml`` through the port's
   reader, equal to the ``.json`` of what PyYAML's ``safe_load`` returned
   for it; ``tests/fixtures/folded_block.yaml`` (``configs/folded.yaml``
   with block sequences, an anchor and a merge key) resolved to the same
   ``TrainConfig``; both files trained through the train CLI, fused, one
   epoch, seed 0 (launches from the runs' forwards; first-step losses
   within 1e-6 relative; K1–K3 against their plain versions at the runs'
   shapes); the phase's seconds;
17. replays the JAX package's flagship run (``tests/fixtures/
   trajectory_folded_fold8.npz``/``.json``, recorded on the CPU by
   ``tests/fixtures/make_trajectory.py``) through the train CLI, fused,
   in float32 and then bfloat16: the seeded init rebuilt with numpy (its
   checksum checked) and saved as a port checkpoint for ``--pretrained``,
   the fixture's step, eval and augmentation draws injected, and every
   ``metrics.jsonl`` row, the counters, the final sweeps and every final
   leaf's sum and L2 norm held to the fixture within ``TRAJECTORY_TOL``;
   each float32 step held to the same step recomputed in f64 on the card
   (``F64_RTOL``); K1 and K2 once per step, K3 only for the reconstruction grids (the
   replayed draws take the plain reparameterization), K3-bwd never; each
   step's relative errors and the phase's seconds;
18. trains the stage-2 MoE prior of ``configs/vq16_fold8_moonlight_prior.yaml``
   (Moonlight-16B-A3B's block at its published widths, 5 layers, routed
   experts 0-7 of each MoE layer): stage 1 of the config for one epoch,
   then ``cli.train_prior --config`` over its checkpoint for one epoch
   (with 3 augment passes, so that the epoch holds several steps of 256):
   NLL and held-out NLL finite, the checkpoint's arch, depth and share
   reloaded by ``load_prior`` (~487 M parameters); one ``generate
   --prior`` sample; the prior trainer's peak memory and grids/s;
19. prints one ``{"fused_norm": [...]}`` line (item 4's rows, one a
   BatchNorm layer), one ``{"vq_search": [...]}`` line (item 4's VQ rows,
   one an N) and one ``{"kernels": [...]}`` line: K1–K3, then the fused
   BatchNorm's forward (``BN``) and backward (``BN-bwd``) and the VQ search
   (``VQ``, timed at N = 524,288) and sums (``VQ-sums``), whose launches
   every run of items 5, 7–17 holds to what its forwards predict (each
   conv-block BatchNorm once a forward and once a backward, twice a
   forward under remat, none in a step whose statistics span ranks; a VQ
   model's search once a forward and its sums once a train forward; the
   artifact phase holds one request on each server; ``accum_launches`` for the
   accumulated run, ``variant_launches`` for every run of item 10,
   ``model_variant_launches`` for item 11, ``artifact_launches`` for item
   12, ``parallel_launches`` for item 13, ``data_launches`` for the
   ``rrd:`` epoch and the ``--pretrained`` Orbax epoch of item 14,
   ``public_api_launches`` for the registered architecture's epoch of
   item 15, ``config_launches`` for the two epochs of item 16,
   ``trajectory_launches`` for the two runs of item 17; item 18 trains no
   fused-ELBO model and is not counted), the card line
   again, and as the last line ``{"ok": true, "device": {...}}``.

Any failed check raises and the script exits non-zero; so does a machine
without a CUDA device. TF32 is off for every comparison (cuDNN and
cuBLAS), so f32 on the card is f32.
"""

from __future__ import annotations

import copy
import importlib.util
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

import numpy as np
import torch
import torch.nn.functional as F

from midi_vae_tpu_torch.data.synthetic import make_pianoroll_batch
from midi_vae_tpu_torch.losses.schedules import kl_weight_schedule
from midi_vae_tpu_torch.models.registry import build_model
from midi_vae_tpu_torch.models.vae import BatchNorm, VanillaVAE, param_group_label
from midi_vae_tpu_torch.ops import cuda_lib, fused_norm, vq_search
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
VQ_CONFIG = "configs/vq16_fold8.yaml"
VQ_EPOCHS = 2  # of the config's 60
PRIOR_EPOCHS = 2  # of the prior section's 40, then a resume to one more
AUGMENT_PASSES = 2  # of the prior section's 10
SAMPLE_N = 16  # grids per sampler call and per /sample request
MOE_CONFIG = "configs/vq16_fold8_moonlight_prior.yaml"
MOE_AUGMENT = 3  # augment passes: the corpus's train split four times over, several steps of 256 an epoch
PRIOR_REQUESTS = 10  # timed /sample and /continue requests each

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

VQ_SOURCE = "midi_vae_tpu_torch/csrc/vq_search.cu"
# launch key → (the function whose ``launches`` count it, the kernel it counts); they replace no TPU kernel: the
# JAX package leaves the quantizer to XLA
VQ_INFO = {
    "VQ": (vq_search.nearest_codes, "VQ vq_search_kernel (nearest code, z_q and the block sums)"),
    "VQ-sums": (vq_search.code_sums, "VQ-sums vq_code_sums_kernel (the block sums summed)"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def launch_counts() -> dict:
    """Launches of K1–K3, of the fused BatchNorm + LeakyReLU (``BN``, its
    backward ``BN-bwd``) and of the VQ search and sums (``VQ``,
    ``VQ-sums``)."""
    return {**ops.launch_counts(), **fused_norm.launch_counts(), **{k: fn.launches for k, (fn, _) in VQ_INFO.items()}}


def reset_launch_counts() -> None:
    ops.reset_launch_counts()
    fused_norm.reset_launch_counts()
    for fn, _ in VQ_INFO.values():
        fn.launches = 0


def elbo_launches(counts: dict) -> dict:
    """K1–K3's part of :func:`launch_counts`."""
    return {k: counts[k] for k in ops.KERNEL_WRAPPERS}


def fused_norms(model) -> int:
    """The model's conv-block BatchNorms (``norm_leaky_relu``'s fused case)."""
    return sum(type(getattr(m, m.norm_name)) is BatchNorm for m in model.modules() if getattr(m, "norm_name", None))


def model_launches(model, train_forwards: int, other_forwards: int = 0, synced: bool = False) -> dict:
    """The launches of the fused BatchNorm and of the VQ kernels that
    forwards of ``model`` on the card predict: each conv-block BatchNorm
    once a forward (twice a train forward under remat, whose backward
    reruns it) and once a train forward's backward, none in a train
    forward whose statistics span two or more ranks (``synced``); a VQ
    model's search once a forward and its sums once a train forward (the
    statistics' all-reduce comes after them). A replayed CUDA graph counts
    as its forward."""
    n = fused_norms(model)
    train = 0 if synced else train_forwards
    vq = getattr(model, "latent_kind", "gaussian") == "vq"
    return {"BN": n * (train * (2 if getattr(model, "remat", False) else 1) + other_forwards), "BN-bwd": n * train,
            "VQ": (train_forwards + other_forwards) if vq else 0, "VQ-sums": train_forwards if vq else 0}


def expected_model_launches(r: dict) -> dict:
    """:func:`model_launches` of a train-CLI run from the forwards it reports:
    its train forwards, reconstruction grids and eval batches; the auto step
    over a mesh of two or more ranks (and any VQ step over one) syncs its
    statistics."""
    f, model = r["forwards"], r["state"].model
    synced = r["mesh"] is not None and math.prod(r["mesh"]["shape"]) > 1 and (
        r["config"]["step_impl"] == "auto" or getattr(model, "latent_kind", "gaussian") == "vq")
    return model_launches(model, f["train_forwards"], f["grid"] + f["eval_batches"], synced)


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


def k3_offset_check(mu, lv, seed: int, dev) -> None:
    """K3 split in two halves of rows, the second from Philox counter offset
    b·D (what two data-parallel ranks launch), against the unsplit launch
    (bitwise), and each half's draw against the plain draw at its offset
    (1 f32 ulp)."""
    half, d = mu.shape[0] // 2, mu.shape[1]
    z = ops.reparam_kl(mu, lv, seed)[0]
    parts = [ops.reparam_kl(mu[i * half:(i + 1) * half], lv[i * half:(i + 1) * half], seed, i * half * d)[0]
             for i in range(2)]
    check(torch.equal(torch.cat(parts), z), "K3 halves with counter offsets differ from the unsplit launch")
    worst = 0
    for i in range(2):
        zeros = torch.zeros((half, d), dtype=torch.float32, device=dev)
        eps = ops.reparam_kl(zeros, zeros, seed, i * half * d)[0]
        plain = ops.k3_eps_plain((half, d), seed, dev, i * half * d)
        beyond = int(((eps - plain).abs() > ulp(torch.maximum(eps.abs(), plain.abs()))).sum())
        worst = max(worst, beyond)
        check(beyond == 0, f"K3 half {i} (offset {i * half * d}) vs plain draw: {beyond} elements beyond 1 f32 ulp")
    log(f"  K3 {list(mu.shape)} {str(mu.dtype).replace('torch.', '')} as two halves of {half} rows at counter "
        f"offsets 0 and {half * d}: z bitwise equal to the unsplit launch; each half's draw within 1 f32 ulp of "
        f"k3_eps_plain at its offset")


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

    k3_offset_check(mu, lv, 1234, dev)
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


# ================================================================= fused BatchNorm + LeakyReLU

# (C, H, W, cropped) of the flagship's eight BatchNorm layers, encoder to head
FLAGSHIP_NORMS = ((48, 8, 8, False), (64, 8, 8, False), (128, 8, 8, False), (256, 8, 8, False),
                  (128, 8, 8, False), (64, 8, 8, False), (48, 16, 16, True), (48, 16, 16, False))
# bytes an element of bf16 BatchNorm + LeakyReLU moves at least, forward and backward:
# x read and y written, then dy and x read and dx written
NORM_BYTES_PER_ELEMENT = 10
L2_BYTES = 50e6
# launch key → the kernels it counts (they replace no TPU kernel: the JAX package leaves BatchNorm to XLA)
NORM_INFO = {
    "BN": "BN _bn_stats_kernel+_bn_finalize_kernel+_bn_apply_kernel (fused BatchNorm + LeakyReLU)",
    "BN-bwd": "BN-bwd _bn_grad_stats_kernel+_bn_grad_finalize_kernel+_bn_grad_apply_kernel (its backward)",
}


def fused_norm_phase(dev) -> list:
    """The fused BatchNorm + LeakyReLU at each flagship BatchNorm layer,
    train mode, forward and backward through autograd: launches a call,
    errors against the plain version (the port's ``BatchNorm`` and
    ``F.leaky_relu``, which take their own batch statistics, so outputs may
    differ by an ulp of bf16), and the device time of the kernels, of the
    plain version and of the library yardstick, beside the bytes bound.
    ``dy`` leans on x̂ and on a constant, so that the batch statistics'
    terms of ∂x carry weight: a backward without them would miss by far
    more than the limits. Returns one row per layer."""
    rows = []
    for c, h, w, crop in FLAGSHIP_NORMS:
        gen = torch.Generator(device=dev).manual_seed(1000 * c + h + crop)
        full = 1.5 * torch.randn(BATCH, h + crop, w + crop, c, generator=gen, device=dev) + 0.2
        x = full.to(torch.bfloat16).permute(0, 3, 1, 2)[:, :, :h, :w].detach().requires_grad_()
        noise = torch.randn(BATCH, h, w, c, generator=gen, device=dev)
        dy = (noise + 0.5 * (full[:, :h, :w] - 0.2) / 1.5 + 0.25).to(torch.bfloat16).permute(0, 3, 1, 2)
        layer = BatchNorm(c, dtype=torch.bfloat16).to(dev)
        params = (layer.weight, layer.bias)
        kw = dict(train=True, update=True, momentum=layer.momentum, eps=layer.epsilon, dtype=torch.bfloat16,
                  slope=0.01)

        def fused():
            y = fused_norm.batch_norm_leaky_relu(x, *params, layer.running_mean, layer.running_var, **kw)
            return (y, *torch.autograd.grad(y, (x, *params), dy))

        def plain():
            y = F.leaky_relu(layer(x, True), 0.01)
            return (y, *torch.autograd.grad(y, (x, *params), dy))

        def library():
            y = F.leaky_relu(F.batch_norm(x, layer.running_mean, layer.running_var, layer.weight, layer.bias,
                                          training=True, momentum=0.1, eps=layer.epsilon), 0.01)
            return (y, *torch.autograd.grad(y, (x, *params), dy))

        launches = (fused_norm.batch_norm_leaky_relu.launches, fused_norm.batch_norm_leaky_relu_grad.launches)
        got = fused()
        torch.cuda.synchronize(dev)
        calls = (fused_norm.batch_norm_leaky_relu.launches - launches[0],
                 fused_norm.batch_norm_leaky_relu_grad.launches - launches[1])
        check(calls == (1, 1), f"fused BatchNorm launches {calls} for one forward and backward")
        want = plain()
        y, y_plain = got[0].detach(), want[0].detach()
        check(y.stride() == y_plain.stride(), f"output strides {y.stride()} vs {y_plain.stride()}")
        # the plain version sums its statistics in another order: a pre-activation 1 ulp apart can end 2 ulps
        # apart once LeakyReLU scales it by 0.01 and rounds it again, and one within that rounding of 0 (|y| at
        # most 1e-5 here) can take the other slope
        larger = torch.maximum(y.abs(), y_plain.abs())
        ulps = (y.float() - y_plain.float()).abs() / ulp(larger)
        flips = int(((ulps > 2) & (larger <= 1e-5)).sum())
        y_ulps = float(ulps[larger > 1e-5].max())
        # gradients: the two sum in other orders and round dx to bf16 (1.6e-5 to 2.4e-5 of dx's norm and at most
        # 4.6e-7 of ∂scale's and ∂bias's measured with an independent dy); a ∂x without the statistics' terms
        # misses by ~sqrt(2/M) of the norm even then (2e-3 to 4e-3 here)
        errs = [float((g.double() - p.double()).norm() / p.double().norm()) for g, p in zip(got[1:], want[1:])]
        check(y_ulps <= 2 and errs[0] <= 2e-4 and max(errs[1:]) <= 1e-5,
              f"fused BatchNorm vs plain: y {y_ulps} ulp, dx {errs[0]:.3e} (limit 2e-4), dscale and dbias "
              f"{errs[1]:.3e}, {errs[2]:.3e} (limit 1e-5)")
        n = x.numel()
        row = {"shape": [BATCH, c, h, w], "cropped": crop, "elements": n, "x_mb": n * 2 / 1e6,
               "y_max_ulps": y_ulps, "y_sign_flips": flips, "dx_rel": errs[0], "dscale_rel": errs[1],
               "dbias_rel": errs[2],
               "bound_ms": n * NORM_BYTES_PER_ELEMENT / HBM_BYTES_PER_S * 1e3}
        for name, fn in (("kernel", fused), ("plain", plain), ("library", library)):
            row[f"{name}_device_ms"], row[f"{name}_kernels"] = device_ms_per_call(fn, dev)
            row[f"{name}_ms"] = time_ms(fn)
        rows.append(row)
        log(f"  [{BATCH},{c},{h},{w}]{' cropped' if crop else ''} ({row['x_mb']:.1f} MB of x"
            f"{', fits L2' if n * 2 < L2_BYTES else ''}): y within {y_ulps:.0f} ulp ({flips} near 0 take the "
            f"other slope), dx {errs[0]:.2e}, dscale "
            f"{errs[1]:.2e}, dbias {errs[2]:.2e} of the plain version's norm; device ms kernel "
            f"{row['kernel_device_ms']:.4f} ({row['kernel_kernels']:.0f} kernels), plain {row['plain_device_ms']:.4f} "
            f"({row['plain_kernels']:.0f}), library {row['library_device_ms']:.4f} ({row['library_kernels']:.0f}); "
            f"bound {row['bound_ms']:.4f}; events ms kernel {row['kernel_ms']:.4f}, plain {row['plain_ms']:.4f}, "
            f"library {row['library_ms']:.4f}")
    total = {k: sum(r[k] for r in rows) for k in ("kernel_device_ms", "plain_device_ms", "library_device_ms",
                                                  "bound_ms")}
    log(f"  the {len(rows)} layers: device ms " + ", ".join(f"{k} {v:.4f}" for k, v in total.items()))
    return rows


VQ_VECTORS = (524_288, 25_600)  # a quantizer call at batch 2048 and 100 of configs/vq16_fold8.yaml's 16×16 grid
VQ_CODES, VQ_DIM = 512, 16  # its codebook


def vq_search_phase(dev) -> list:
    """The VQ quantizer's search and sums kernels (``ops/vq_search.py``) at
    the VQ config's shapes, train mode, through ``nearest_codes`` and
    ``code_sums`` as the quantizer calls them: one launch of each a call;
    indices equal to the plain version's but at near-ties (the two codes'
    plain distances within 1e-5 relative, ``tests/test_torch_vq.py``'s
    rule), the eval search's equal to the train search's, z_q bitwise the
    codebook's rows, the counts exact, each sum within the f32 reordering
    bound of its exact value (f64); then the device time of the kernels, of
    the plain version (``nearest_codes_plain`` + ``code_sums_plain``) and of
    ``torch.cdist`` + ``argmin`` in f32 (the library yardstick, used
    nowhere in the port), beside the bound (``bench_cuda/counts_vq.py``, z_e
    in bf16). Returns one row per N."""
    from bench_cuda import counts_vq
    from midi_vae_tpu_torch.models.vq import VectorQuantizerEMA

    k, d = VQ_CODES, VQ_DIM
    cb = VectorQuantizerEMA(k, d, generator=torch.Generator().manual_seed(0)).codebook.to(dev)
    rows = []
    for n in VQ_VECTORS:
        flat = torch.randn(n, d, generator=torch.Generator(device=dev).manual_seed(n), device=dev)
        flat = flat.to(torch.bfloat16).float()  # z_e as the model hands it over

        def kernels():
            idx, z_q, partials = vq_search.nearest_codes(flat, cb, train=True)
            return (idx, z_q, *vq_search.code_sums(flat, idx, partials, k))

        def plain():
            idx, z_q = vq_search.nearest_codes_plain(flat, cb)
            return (idx, z_q, *vq_search.code_sums_plain(flat, idx, k))

        def library():
            return torch.argmin(torch.cdist(flat, cb), dim=1)

        before = launch_counts()
        idx, z_q, counts, sums = kernels()
        torch.cuda.synchronize(dev)
        calls = {key: launch_counts()[key] - before[key] for key in VQ_INFO}
        check(calls == {"VQ": 1, "VQ-sums": 1}, f"the VQ kernels launched {calls} for one train-mode call")
        want, _ = vq_search.nearest_codes_plain(flat, cb)
        rows_apart = torch.nonzero(idx != want).flatten()
        d2 = vq_search.distances_plain(flat[rows_apart], cb).double()
        a, b = d2.gather(1, idx[rows_apart, None]), d2.gather(1, want[rows_apart, None])
        gap = float(((a - b).abs() / torch.maximum(a.abs(), b.abs())).max()) if len(rows_apart) else 0.0
        check(gap <= 1e-5, f"N {n}: {len(rows_apart)} indices differ from the plain version's, the worst "
              f"{gap:.3e} apart in relative distance (near-ties are within 1e-5)")
        check(torch.equal(vq_search.nearest_codes(flat, cb, train=False)[0], idx), f"N {n}: eval search != train")
        check(idx.dtype == torch.int64 and torch.equal(z_q, cb[idx]), f"N {n}: z_q is not the codebook's rows")
        check(torch.equal(counts, torch.bincount(idx, minlength=k).float()), f"N {n}: counts not exact")
        exact = torch.zeros(k, d, dtype=torch.float64, device=dev).index_add_(0, idx, flat.double())
        size = torch.zeros(k, d, dtype=torch.float64, device=dev).index_add_(0, idx, flat.double().abs())
        # an f32 sum of m terms in any order is within γ(m - 1)·Σ|terms| of the exact sum, γ(j) = j·u / (1 - j·u)
        ju = (counts.double().clamp_min(1)[:, None] - 1) * 2**-24
        err = (sums.double() - exact).abs()
        check(bool(torch.all(err <= ju / (1 - ju) * size)), f"N {n}: sums beyond f32 reordering of the exact sums")
        row = {"n": n, "k": k, "d": d, "indices_differing": len(rows_apart), "worst_tie_gap": gap,
               "sums_rel": float(err.norm() / exact.norm()), "codes_used": int((counts > 0).sum()),
               "bound_ms": 1e3 * counts_vq.least_seconds(n, k, d, 2)}
        nbytes, flops = counts_vq.least_work(n, k, d, 2)
        row["bound_by"] = "operations" if flops / counts_vq.PEAK_F64_FLOPS >= nbytes / HBM_BYTES_PER_S else "bytes"
        for name, fn in (("kernel", kernels), ("plain", plain), ("library", library)):
            row[f"{name}_device_ms"], row[f"{name}_kernels"] = device_ms_per_call(fn, dev)
            row[f"{name}_ms"] = time_ms(fn)
        rows.append(row)
        log(f"  N {n}, K {k}, D {d}: {len(rows_apart)} indices differ from the plain version's (worst gap "
            f"{gap:.2e} relative), z_q bitwise, counts exact, sums within f32 reordering ({row['sums_rel']:.2e} of "
            f"their norm), {row['codes_used']} codes used; device ms kernel {row['kernel_device_ms']:.4f} "
            f"({row['kernel_kernels']:.0f} kernels), plain {row['plain_device_ms']:.4f} ({row['plain_kernels']:.0f}), "
            f"library {row['library_device_ms']:.4f} ({row['library_kernels']:.0f}); bound {row['bound_ms']:.4f}; "
            f"events ms kernel {row['kernel_ms']:.4f}, plain {row['plain_ms']:.4f}, library {row['library_ms']:.4f}")
    return rows


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
    reset_launch_counts()
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
    counts = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30

    log(f"  losses: first {losses[0]:.6f}, last five {[round(v, 6) for v in losses[-5:]]}")
    check(statistics.mean(losses[-5:]) < losses[0], "loss did not fall over the run")
    want = {**{k: TRAIN_STEPS for k in ops.KERNEL_WRAPPERS}, **model_launches(model, TRAIN_STEPS)}
    check(counts == want, f"launched {counts} in {TRAIN_STEPS} fused steps, expected {want}")
    rel = abs(losses[0] - ref_loss) / abs(ref_loss)
    log(f"  first fused step loss {losses[0]:.7f} vs unfused step with the plain draw {ref_loss:.7f}: rel {rel:.2e}")
    check(rel <= 1e-3, "fused and unfused first-step losses differ")
    med = statistics.median(step_ms)
    log(f"  launches in {TRAIN_STEPS} fused steps: {counts}; peak memory {peak_gib:.2f} GiB")
    log(f"  throughput {BATCH * TRAIN_STEPS / sum(step_ms) * 1e3:.1f} samples/s ({BATCH * TRAIN_STEPS} samples "
        f"in {sum(step_ms):.3f} ms); step time median {med:.3f} ms, min {min(step_ms):.3f} ms, "
        f"max {max(step_ms):.3f} ms over {TRAIN_STEPS} steps, bf16, batch {BATCH}, incl. batch generation "
        f"[{card_line()}]")
    device_ms, busy_ms = profile_steps(state, step, data_gen, epoch_seed, dev, med)
    window = {"samples_per_s": BATCH * TRAIN_STEPS / sum(step_ms) * 1e3, "median_ms": med, "busy_ms": busy_ms,
              "peak_gib": peak_gib}
    return model, counts, device_ms, window


# kernel-name fragments → layer, for the profile's breakdown (first match wins)
OUR_KERNELS = tuple(f for info in KERNEL_INFO.values() for f in info[4])
NORM_KERNELS = ("_bn_stats_kernel", "_bn_finalize_kernel", "_bn_apply_kernel", "_bn_grad_stats_kernel",
                "_bn_grad_finalize_kernel", "_bn_grad_apply_kernel")
LAYERS = (
    ("K1-K3 (Triton, CUDA C++)", OUR_KERNELS),
    ("BatchNorm + LeakyReLU (Triton, ops/fused_norm.py)", NORM_KERNELS),
    ("convs and dense (cuDNN, cuBLAS)", ("xmma", "cutlass", "gemm", "conv", "wgrad", "dgrad", "nvjet", "splitK")),
    ("AdamW (foreach)", ("multi_tensor_apply",)),
    ("batch generation (scatter, random)", ("scatter", "distribution", "random")),
    ("reductions (BatchNorm statistics, grad norm, loss)", ("reduce_kernel",)),
)


def profile_steps(state, step, data_gen, epoch_seed, dev, step_ms: float, n_steps: int = 3, batch: int = BATCH) -> tuple:
    """Device time by kernel and by layer over a few more fused steps
    (torch.profiler), and the device's busy share of ``step_ms``, the
    median step time measured without the profiler (whose own host cost
    lengthens the profiled window). Returns (each of our kernels' device ms
    per step (one call per step), the device's busy ms per step)."""
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
    }, busy_ms


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
    forwards the run reports: K1, K2 and K3's backward once per train
    forward (one per step, or one per micro-batch under ``--grad-accum``);
    K3's forward once per train forward, once per reconstruction grid and
    once per eval batch (the eval forward samples z, as the JAX package's
    does); the fused BatchNorm and the VQ kernels as
    :func:`expected_model_launches`."""
    f = r["forwards"]
    check(f["train_steps"] == r["steps_per_epoch"] * epochs,
          f"{f['train_steps']} train steps in {epochs} epochs of {r['steps_per_epoch']}")
    fwd = f["train_forwards"]
    return {"K1": fwd, "K2": fwd, "K3": fwd + f["grid"] + f["eval_batches"], "K3-bwd": fwd,
            **expected_model_launches(r)}


def log_cli_run(label: str, r: dict, card: str) -> None:
    c = r["corpus"]
    batch = r["n_samples_seen"] // max(r["total_step"], 1)
    log(f"  {label}: corpus {c['train']} train / {c['val']} val / {c['test']} test windows, fetched in "
        f"{r['timings']['fetch_s']:.3f} s; {r['steps_per_epoch']} steps per epoch at batch {batch}; run "
        f"{r['duration_total']:.3f} s [{card}]")
    for h in r["history"]:
        t = h["train"]
        samples = r["steps_per_epoch"] * batch
        phases = ", ".join(f"{k} {v:.3f} s" for k, v in t["phase_s"].items())
        log(f"    epoch {h['epoch']}: train loss {t['loss']:.6f}, {t['throughput']:.1f} samples/s "
            f"({samples / t['throughput']:.3f} s for {samples} samples; {phases}) [{card}]")


def small_batch_steps(state, dev, card: str, batch: int = CLI_BATCH, n_steps: int = 20, grad_accum: int = 1) -> None:
    """The CLI's fused step at its batch, alone: the median of ``n_steps``
    steps closed by reading the loss, then a profile of three more (the
    device's busy share at this batch)."""
    step = make_train_step(kl_weight_schedule("constant", KL_WEIGHT), fused_loss=True, grad_accum=grad_accum)
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
    accum = f", grad_accum {grad_accum} (micro-batches of {batch // grad_accum})" if grad_accum > 1 else ""
    log(f"  fused step alone at batch {batch}{accum}: median {med:.3f} ms, min {min(step_ms):.3f} ms over {n_steps} steps "
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

    reset_launch_counts()
    r1 = train_cli.cli(fused + ["--stop-after-epochs", "2", "--models-dir", str(models), "--run-name", "cli",
                                "--run-id", "fused"])
    counts = launch_counts()
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

    reset_launch_counts()
    r2 = train_cli.cli(fused + ["--checkpoint", str(latest)])
    counts2 = launch_counts()
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

    reset_launch_counts()
    r3 = train_cli.cli(["--config", config, "--epochs", "1", "--seed", "0", "--models-dir", str(models),
                        "--run-name", "cli", "--run-id", "as-written"])
    log_cli_run("configs/folded.yaml as written (raw targets, auto bias, unfused), 1 epoch", r3, card)
    metrics = [r3["train"]["loss"]] + [r3[p][k] for p in ("test", "final_test", "final_train")
                                       for k in ("cross-entropy", "bce-objective", "kl", "mse", "mae")]
    check(all(math.isfinite(v) for v in metrics), f"non-finite metrics in the as-written run: {metrics}")
    counts3, want3 = launch_counts(), {**{k: 0 for k in ops.KERNEL_WRAPPERS}, **expected_model_launches(r3)}
    check(counts3 == want3, f"the unfused run launched {counts3}, expected {want3}")
    log(f"  as written: train loss {r3['train']['loss']:.6f}, final test bce-objective "
        f"{r3['final_test']['bce-objective']:.6f}, active units {r3['final_test']['active-units']}; no K1-K3 launched, "
        f"fused BatchNorm {counts3['BN']} / {counts3['BN-bwd']} as the forwards predict")
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
    reset_launch_counts()

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

    counts = launch_counts()
    check(elbo_launches(counts) == {k: 0 for k in ops.KERNEL_WRAPPERS},
          f"the inference path launched a fused-ELBO kernel: {counts}")
    log(f"  launches across the serve phase (generate, evaluate, serve): {counts}; the phase took "
        f"{time.perf_counter() - t_phase:.1f} s")


# ====================================================================== vq


def vq_train(root: Path, models: Path, card: str):
    """Stage 1: the train CLI on the VQ config as written, for 2 of its 60
    epochs. Returns the run's results and its best checkpoint."""
    from midi_vae_tpu_torch.cli import train as train_cli

    r = train_cli.cli(["--config", str(root / VQ_CONFIG), "--stop-after-epochs", str(VQ_EPOCHS), "--seed", "0",
                       "--models-dir", str(models), "--run-name", "vq16", "--run-id", "stage1"])
    log_cli_run(f"{VQ_CONFIG} as written (FoldedVQVAE, bf16), epochs 1-{VQ_EPOCHS} of 60", r, card)
    losses = [h["train"]["loss"] for h in r["history"]]
    check(len(losses) == VQ_EPOCHS and all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f"VQ train loss did not fall: {losses}")
    final = r["final_test"]
    check(final["codebook-perplexity"] > 1 and final["active-codes"] > 1, f"codebook collapsed: {final}")
    run_dir = models / "midi-synthetic" / "vq16__stage1"
    latest, best = run_dir / "checkpoint_latest.pt", run_dir / "best_model.pt"
    check(latest.is_file() and best.is_file(), f"VQ checkpoints missing under {run_dir}")
    log(f"  epoch losses {losses}; final test: bce-objective {final['bce-objective']:.6f}, f1 {final['f1']:.3f} %, "
        f"codebook perplexity {final['codebook-perplexity']:.2f}, active codes {final['active-codes']} of "
        f"{r['state'].model.codebook_size}; {latest.name} and {best.name} written")
    return r, best


def moe_prior_phase(dev, root: Path, card: str) -> None:
    """Item 18: the Moonlight prior through the prior trainer's normal
    path, over a stage-1 checkpoint of the same config, then one sample."""
    from midi_vae_tpu_torch.cli import generate, train as train_cli, train_prior

    models = root / "build" / "moe_models"
    shutil.rmtree(models, ignore_errors=True)
    r = train_cli.cli(["--config", str(root / MOE_CONFIG), "--stop-after-epochs", "1", "--seed", "0",
                       "--models-dir", str(models), "--run-name", "moe", "--run-id", "stage1"])
    log_cli_run(f"{MOE_CONFIG} stage 1, epoch 1", r, card)
    best = models / "midi-synthetic" / "moe__stage1" / "best_model.pt"
    check(best.is_file(), f"stage-1 checkpoint missing: {best}")
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    p = train_prior.cli(["--config", str(root / MOE_CONFIG), "--checkpoint", str(best), "--epochs", "1",
                         "--augment-passes", str(MOE_AUGMENT), "--out", str(best.parent / "prior_moonlight.pt")])
    peak = torch.cuda.max_memory_allocated(dev)
    h = p["history"][0]
    check(math.isfinite(h["nll"]) and math.isfinite(p["test_nll"]), f"MoE prior not finite: {p['history']}")
    prior, pcfg = train_prior.load_prior(p["out"], device=dev)
    check((pcfg["arch"], pcfg["layers"], pcfg["experts_held"]) == ("moonlight", 5, "0:8")
          and type(prior).__name__ == "MoonlightPrior" and prior.held == (0, 8), f"MoE prior reloaded as {pcfg}")
    n_params = sum(q.numel() for q in prior.parameters())
    del prior
    log(f"  moonlight prior: {n_params:,} parameters, corpus {p['corpus']} grids, {h['steps']} steps of "
        f"{p['batch_size']} in {h['duration']:.3f} s ({h['steps'] * p['batch_size'] / h['duration']:.1f} grids/s, "
        f"the first steps included), nll {h['nll']:.4f}, held-out {p['test_nll']:.4f} nats/position; peak memory "
        f"{peak:,} B ({100.0 * peak / torch.cuda.get_device_properties(dev).total_memory:.1f} % of the card) [{card}]")
    t0 = time.perf_counter()
    sampled = generate.cli(["--checkpoint", str(best), "--prior", p["out"], "--mode", "sample", "-n", "1",
                            "--out", str(best.parent / "moe_sample.png")])
    check(sampled.shape[0] == 1 and np.isfinite(sampled).all(), f"MoE prior sample: {sampled.shape}")
    log(f"  generate --prior: one grid of {pcfg['grid']}x{pcfg['grid']} codes sampled and decoded in "
        f"{time.perf_counter() - t0:.3f} s [{card}]")


def vq_step_timing(r: dict, dev, card: str) -> None:
    """The VQ train step alone at the CLI's batch: the median of 20 steps
    closed by reading the loss, the device's busy share of it, and the
    quantizer's share of the step's device time (the search and sums
    kernels and the EMA update: the quantizer's train-mode call on the
    step's z_e, alone)."""
    from midi_vae_tpu_torch.data.transforms import get_transform

    spec, _ = get_transform("pianoroll", 128, {"normalization": "midi-synthetic"})
    step = make_train_step(kl_weight_schedule("constant", 0.25), loss_type="vq",
                           target_denorm=(tuple(spec.mean), tuple(spec.std)))
    state = [r["state"]]
    data_gen = torch.Generator(device=dev).manual_seed(6)
    step_ms = []
    for _ in range(20):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        x, _ = make_pianoroll_batch(data_gen, CLI_BATCH, device=dev)
        state[0], lo, _ = step(state[0], x, 0)
        lo.loss.item()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(step_ms)

    def one_step():
        state[0], _, _ = step(state[0], x, 0)

    step_dev, step_kernels = device_ms_per_call(one_step, dev, n=5)
    model = state[0].model
    with torch.no_grad():
        z_e = model._encode_spatial(x, False)[0]
    quantizer = copy.deepcopy(model.quantizer)
    q_dev, q_kernels = device_ms_per_call(lambda: quantizer(z_e, True), dev)
    log(f"  VQ step alone at batch {CLI_BATCH} (bf16): median {med:.3f} ms, min {min(step_ms):.3f} ms over 20 steps "
        f"({CLI_BATCH / med * 1e3:.1f} samples/s); device busy {step_dev:.3f} ms/step ({step_dev / med:.1%}, "
        f"{step_kernels:.0f} kernels and copies) [{card}]")
    log(f"  quantizer (search and sums kernels, EMA update) on z_e {list(z_e.shape)}: device {q_dev:.4f} ms per "
        f"call ({q_kernels:.0f} kernels), {q_dev / step_dev:.1%} of the step's device time [{card}]")


def vq_card_vs_cpu(best: Path, dev, card: str) -> None:
    """The VQ model on the card against the same weights on the CPU, f32,
    batch 16: decode_indices of the same grids within 1e-4; encode_indices
    equal on at least 99.9 % of positions, every difference a near-tie (the
    two codes' distances on the CPU within 1e-4 relative)."""
    from midi_vae_tpu_torch.cli.generate import _fetch_eval_batch, _load_model_and_state

    gpu, cfg, size, _, dataset = _load_model_and_state(str(best), device=dev)
    cpu, _, _, _, _ = _load_model_and_state(str(best), device="cpu")
    x, _, _ = _fetch_eval_batch(dataset, None, size, 16, cfg, dev)
    s, k = cpu.last_conv_size, cpu.codebook_size
    grids = torch.randint(0, k, (16, s, s), generator=torch.Generator().manual_seed(7))
    with torch.inference_mode():
        dec_err = float((gpu.decode_indices(grids.to(dev)).cpu() - cpu.decode_indices(grids)).abs().max())
        idx_g = gpu.encode_indices(x).cpu().reshape(-1).long()
        idx_c = cpu.encode_indices(x.cpu()).reshape(-1).long()
        d2 = cpu.quantizer.distances(cpu.encode(x.cpu()).mu.reshape(-1, cpu.latent_dim))
    differ = torch.nonzero(idx_g != idx_c).flatten()
    a, b = d2[differ, idx_g[differ]], d2[differ, idx_c[differ]]
    near_ties = bool(((a - b).abs() <= 1e-4 * torch.maximum(a.abs(), b.abs())).all())
    agree = 1.0 - len(differ) / idx_g.numel()
    log(f"  card vs CPU, f32 batch 16: decode_indices max |err| {dec_err:.3e}; encode_indices equal on "
        f"{agree:.4%} of {idx_g.numel()} positions, {len(differ)} differ (all near-ties: {near_ties}) [{card}]")
    check(dec_err <= 1e-4, "decode_indices on the card disagrees with the CPU")
    check(agree >= 0.999 and near_ties, "encode_indices on the card disagrees with the CPU")


def vq_prior_train(root: Path, best: Path, card: str):
    """Stage 2: the prior trainer on the config's prior section (transformer)
    for 2 of its 40 epochs with 2 of its 10 augment passes, its resume to
    epoch 3, and one epoch of the PixelCNN at its default widths. Returns
    both priors' paths."""
    from midi_vae_tpu_torch.cli import train_prior

    def report(label, p):
        for h in p["history"]:
            log(f"    {label} epoch {h['epoch']}: nll {h['nll']:.4f} nats/position, {h['steps']} steps of "
                f"{p['batch_size']} in {h['duration']:.3f} s ({h['steps'] * p['batch_size'] / h['duration']:.1f} "
                f"grids/s) [{card}]")

    argv = ["--config", str(root / VQ_CONFIG), "--checkpoint", str(best), "--augment-passes", str(AUGMENT_PASSES)]
    p1 = train_prior.cli(argv + ["--epochs", str(PRIOR_EPOCHS)])
    report("transformer", p1)
    _, pcfg = train_prior.load_prior(p1["out"], device="cpu")
    uniform = math.log(pcfg["num_codes"])
    nlls = [h["nll"] for h in p1["history"]]
    check(len(nlls) == PRIOR_EPOCHS and all(math.isfinite(v) for v in nlls) and nlls[-1] < nlls[0],
          f"prior NLL did not fall: {nlls}")
    check(p1["test_nll"] < uniform, f"held-out NLL {p1['test_nll']} not below log K = {uniform}")
    log(f"  transformer prior ({pcfg['features']} features, {pcfg['layers']} layers, {pcfg['heads']} heads): corpus "
        f"{p1['corpus']} grids (clean + {AUGMENT_PASSES} augment passes, encoded in "
        f"{sum(p1['timings'].values()):.3f} s), held-out NLL {p1['test_nll']:.4f} < log K {uniform:.4f} nats/position")
    p2 = train_prior.cli(argv + ["--epochs", str(PRIOR_EPOCHS + 1)])  # resumes from prior_latest.pt
    report("transformer, resumed", p2)
    check([h["epoch"] for h in p2["history"]] == [PRIOR_EPOCHS + 1]
          and p2["total_step"] == p1["total_step"] + p2["history"][0]["steps"],
          f"prior resume: {p2['history']}, total_step {p1['total_step']} -> {p2['total_step']}")
    pix = train_prior.cli(["--checkpoint", str(best), "--prior-arch", "pixelcnn", "--epochs", "1",
                           "--out", str(best.parent / "prior_pixelcnn.pt")])
    report("PixelCNN", pix)
    check(math.isfinite(pix["history"][0]["nll"]) and math.isfinite(pix["test_nll"]), "PixelCNN prior not finite")
    log(f"  resumed to epoch {PRIOR_EPOCHS + 1}: total_step {p1['total_step']} -> {p2['total_step']}, held-out NLL "
        f"{p2['test_nll']:.4f}; PixelCNN 1 epoch: held-out NLL {pix['test_nll']:.4f} nats/position")
    return Path(p2["out"]), Path(pix["out"])


def vq_generate_evaluate(best: Path, prior_path: Path, out: Path, dev, card: str):
    """generate --prior (sample at top_p 1.0 and 0.9, continue keeping 8
    time columns) with .mid export; the forced codes checked at the
    sampler; evaluate --codes-out read back. Returns the model, the prior
    and a batch of 16 test rolls, on the card."""
    import numpy as np

    from midi_vae_tpu_torch.cli import evaluate as evaluate_cli
    from midi_vae_tpu_torch.cli import generate as generate_cli
    from midi_vae_tpu_torch.cli.generate import _fetch_eval_batch, _load_model_and_state
    from midi_vae_tpu_torch.cli.train_prior import load_prior
    from midi_vae_tpu_torch.midi.smf import read_smf
    from midi_vae_tpu_torch.models.prior import sample_codes_autoregressive

    runs = {
        "sample": (["--mode", "sample"], SAMPLE_N),
        "sample_top_p": (["--mode", "sample", "--top-p", "0.9"], SAMPLE_N),
        "continue": (["--mode", "continue", "--keep-cols", "8"], 2 * SAMPLE_N),  # input | continuation pairs
    }
    for name, (extra, n) in runs.items():
        png, mid = out / f"{name}.png", out / f"mid_{name}"
        t0 = time.perf_counter()
        images = generate_cli.cli(["--checkpoint", str(best), "--prior", str(prior_path), "-n", str(SAMPLE_N),
                                   "--out", str(png), "--export-midi", str(mid)] + extra)
        seconds = time.perf_counter() - t0
        check(images.shape == (n, 128, 128, 1) and bool(np.isfinite(images).all())
              and images.min() >= 0.0 and images.max() <= 1.0, f"generate --prior {name}: {images.shape}")
        files = sorted(mid.glob("*.mid"))
        notes = [read_smf(str(f)) for f in files]
        check(png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n" and len(files) == n, f"generate --prior {name}: outputs")
        log(f"  generate --prior {' '.join(extra)}: {list(images.shape)}, {n} .mid files "
            f"({sum(len(k) for k in notes)} notes) read back; {seconds:.3f} s [{card}]")

    model, cfg, size, _, dataset = _load_model_and_state(str(best), device=dev)
    prior, _ = load_prior(str(prior_path), device=dev)
    x, _, _ = _fetch_eval_batch(dataset, None, size, SAMPLE_N, cfg, dev)
    s = model.last_conv_size
    with torch.inference_mode():
        codes = model.encode_indices(x)
    mask = np.zeros((s, s), bool)
    mask[:, :8] = True
    idx = sample_codes_autoregressive(prior, 1, SAMPLE_N, s, known=codes, known_mask=mask)
    check(torch.equal(idx[:, :, :8], codes[:, :, :8]), "forced positions differ from the encoded codes")
    check(int(idx.min()) >= 0 and int(idx.max()) < model.codebook_size, "codes outside [0, K)")

    npz = out / "codes.npz"
    res = evaluate_cli.cli(["--checkpoint", str(best), "--partition", "test", "--codes-out", str(npz)])["test"]
    grids = np.load(npz)["codes_test"]
    check(grids.shape == (res["count"], s, s) and grids.dtype == np.int32 and grids.min() >= 0
          and grids.max() < model.codebook_size, f"--codes-out: {grids.shape} {grids.dtype}")
    log(f"  sampler: forced time columns equal the encoded codes, codes in [0, {model.codebook_size}); evaluate "
        f"--codes-out: {list(grids.shape)} int32 grids read back, {len(np.unique(grids))} distinct codes; test "
        f"bce-objective {res['bce-objective']:.6f}")
    return model, prior, x


def sampler_timing(prior, grid: int, label: str, dev, card: str) -> None:
    """One ancestral sampler call of SAMPLE_N grids: host ms per call (the
    median of 3, closed by a synchronize) and per position; kernels and the
    device's busy time per call from a profile of one call."""
    from midi_vae_tpu_torch.models.prior import sample_codes_autoregressive

    def call():
        sample_codes_autoregressive(prior, 0, SAMPLE_N, grid)
        torch.cuda.synchronize(dev)

    call()
    ms = statistics.median(timed(call, 3)) * 1e3
    dev_ms, kernels = device_ms_per_call(call, dev, n=1)
    positions = grid * grid
    log(f"  {label} ancestral sampler, {SAMPLE_N} grids of {grid}x{grid}: {ms:.3f} ms per call, "
        f"{ms / positions:.4f} ms per position, {kernels / positions:.1f} kernels and copies per position; device "
        f"busy {dev_ms:.3f} ms per call ({dev_ms / ms:.1%}) [{card}]")


def prior_step_timing(prior_path: Path, dev, card: str) -> None:
    """The prior's train step (forward, NLL, backward, Adam) at the config's
    batch of 256 grids: median of 10 steps closed by reading the loss, and
    its device time."""
    from midi_vae_tpu_torch.cli.train_prior import load_prior
    from midi_vae_tpu_torch.models.prior import prior_nll

    prior, pcfg = load_prior(str(prior_path), device=dev)
    opt = torch.optim.Adam(prior.parameters(), lr=3e-4)
    s = int(pcfg["grid"])
    idx = torch.randint(0, int(pcfg["num_codes"]), (256, s, s), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(8))

    def one():
        opt.zero_grad(set_to_none=True)
        nll = prior_nll(prior, idx)
        nll.backward()
        opt.step()
        return nll

    for _ in range(3):
        one()
    ms = []
    for _ in range(10):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        one().item()
        ms.append((time.perf_counter() - t0) * 1e3)
    dev_ms, kernels = device_ms_per_call(one, dev, n=3)
    med = statistics.median(ms)
    log(f"  {pcfg['arch']} prior train step at batch 256 (f32, TF32 off): median {med:.3f} ms, min {min(ms):.3f} ms "
        f"over 10 steps ({256 / med * 1e3:.1f} grids/s); device {dev_ms:.3f} ms ({dev_ms / med:.1%}, {kernels:.0f} "
        f"kernels and copies) [{card}]")


def vq_serve(best: Path, prior_path: Path, model, prior, x, dev, card: str) -> None:
    """serve on the card with --prior: /healthz names the prior; /sample
    equals the direct sampler and decoder for the same seed; /continue
    answers; both timed over PRIOR_REQUESTS requests."""
    import numpy as np

    from midi_vae_tpu_torch.models.prior import sample_codes_autoregressive
    from midi_vae_tpu_torch.serving.client import ServingClient
    from midi_vae_tpu_torch.serving.server import serve

    httpd = serve(str(best), port=0, prior=str(prior_path))
    try:
        client = ServingClient(f"http://127.0.0.1:{httpd.server_address[1]}")
        health = client.healthz()
        check(health["prior"] is not None and health["prior"]["arch"] == "transformer", f"/healthz: {health}")
        got = client.sample(SAMPLE_N, 3, temperature=0.9, top_p=0.95)
        with torch.inference_mode():
            idx = sample_codes_autoregressive(prior, 3, SAMPLE_N, model.last_conv_size, temperature=0.9, top_p=0.95)
            want = model.decode_indices(idx).cpu().numpy()
        err = float(np.abs(got - want).max())
        check(got.shape == want.shape and err <= 1e-4, f"/sample vs the direct sampler: max |err| {err}")
        rolls = x.cpu().numpy()
        cont = client.continue_(rolls, keep_cols=8, seed=4)
        check(cont.shape == rolls.shape and bool(np.isfinite(cont).all()), f"/continue: {cont.shape}")
        log(f"  serve --prior on the card: /healthz prior {health['prior']['arch']}; /sample n={SAMPLE_N} "
            f"(temperature 0.9, top_p 0.95) vs the direct sampler + decode_indices, same seed: max |err| {err:.3e}; "
            f"/continue of {len(rolls)} rolls answered")
        sample_s = timed(lambda: client.sample(SAMPLE_N, 0, temperature=0.9, top_p=0.95), PRIOR_REQUESTS)
        cont_s = timed(lambda: client.continue_(rolls[:1], keep_cols=8), PRIOR_REQUESTS)
        log(f"  /sample with prior, n={SAMPLE_N}, npy ({PRIOR_REQUESTS} sequential): p50 {quantile_ms(sample_s, 50):.3f} "
            f"ms, p99 {quantile_ms(sample_s, 99):.3f} ms; /continue 1 roll, keep 8 of {model.last_conv_size} columns: "
            f"p50 {quantile_ms(cont_s, 50):.3f} ms, p99 {quantile_ms(cont_s, 99):.3f} ms [{card}]")
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.service.close()


def vq_phase(dev, root: Path, card: str) -> dict:
    """The two-stage VQ path (module docstring, item 9). Returns the launches
    of its stage-1 train run: K1–K3 none (nor anywhere in the phase), the
    fused BatchNorm's and the VQ kernels' as the run's forwards predict."""
    from midi_vae_tpu_torch.cli.train_prior import load_prior

    t_phase = time.perf_counter()
    models, out = root / "build" / "vq_models", root / "build" / "vq"
    for d in (models, out):
        shutil.rmtree(d, ignore_errors=True)
    out.mkdir(parents=True)
    reset_launch_counts()

    r, best = vq_train(root, models, card)
    stage1, want = launch_counts(), {**{k: 0 for k in ops.KERNEL_WRAPPERS}, **expected_model_launches(r)}
    log(f"  stage 1 launches {stage1}, expected {want} (forwards {r['forwards']})")
    check(stage1 == want, f"the VQ stage-1 run launched {stage1}, expected {want}")
    vq_step_timing(r, dev, card)
    vq_card_vs_cpu(best, dev, card)
    prior_path, pixelcnn_path = vq_prior_train(root, best, card)
    model, prior, x = vq_generate_evaluate(best, prior_path, out, dev, card)
    grid = model.last_conv_size
    sampler_timing(prior, grid, "transformer", dev, card)
    sampler_timing(load_prior(str(pixelcnn_path), device=dev)[0], grid, "PixelCNN", dev, card)
    prior_step_timing(prior_path, dev, card)
    vq_serve(best, prior_path, model, prior, x, dev, card)

    counts = launch_counts()
    check(elbo_launches(counts) == {k: 0 for k in ops.KERNEL_WRAPPERS},
          f"the VQ path launched a fused-ELBO kernel: {counts}")
    log(f"  launches across the VQ phase: {counts}; the phase took {time.perf_counter() - t_phase:.1f} s")
    return stage1


# ================================================================ variants


ACCUM = 2  # --grad-accum of the accumulated runs: micro-batches of 50 at the CLI's batch of 100
BETA_TC_CONFIG = "configs/beta_tc_vae.yaml"
BETA_TC_EPOCHS = 2  # of the config's 100
CONDITIONAL_CONFIG = "configs/conditional_mnist.yaml"
CONDITIONAL_DATASET = "vae-lines-large-synthetic"  # labels = line counts; MNIST is not in the repo
CONDITIONAL_EPOCHS = 2  # of the config's 5
CONDITIONAL_BATCH = 128  # the config's batch_size_per_device
OPTIMIZERS = ("Adam", "SGD", "RMSprop", "Adagrad", "LAMB", "Lion")
MLP_HIDDEN = ("512", "256")  # MLPVAE's own default widths
# the rate of the repo's midi configs: at the CLI's default 0.01 a one-epoch (7-step) OneCycle peaks at its
# second step and the KL blows up, in both packages alike; 1 epoch of the CLI's 5 keeps the 5-epoch horizon
MLP_LR, MLP_EPOCHS = "0.00128", "5"


def add_counts(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def timed_step(label: str, state, step, batch: int, dev, card: str, y=None, n: int = 12) -> float:
    """A train step alone on fresh on-device rolls: the median of the last
    ``n`` − 2 of ``n`` steps, each closed by reading the loss, and its
    device time and kernels (profile of 3 more). Returns the device ms per
    step."""
    data_gen = torch.Generator(device=dev).manual_seed(15)
    cur = [state]

    def one():
        x, _ = make_pianoroll_batch(data_gen, batch, device=dev)
        cur[0], lo, _ = step(cur[0], x, 0, y=y)
        return lo

    ms = []
    for _ in range(n):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        one().loss.item()
        ms.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(ms[2:])
    dev_ms, kernels = device_ms_per_call(one, dev, n=3)
    log(f"  {label} step alone at batch {batch}: median {med:.3f} ms over {n - 2} ({batch / med * 1e3:.1f} samples/s); "
        f"device busy {dev_ms:.3f} ms/step ({dev_ms / med:.1%}, {kernels:.0f} kernels and copies) [{card}]")
    return dev_ms


def fused_run(argv: list, epochs: int, label: str, card: str) -> tuple:
    """A fused train-CLI run with its launch counts held to its forwards.
    Returns (results, counts)."""
    from midi_vae_tpu_torch.cli import train as train_cli

    reset_launch_counts()
    r = train_cli.cli(argv)
    counts = launch_counts()
    log_cli_run(label, r, card)
    want = expected_cli_launches(r, epochs)
    log(f"  launches {counts}, expected {want} (forwards {r['forwards']})")
    check(counts == want, f"{label}: launched {counts}, expected {want}")
    return r, counts


def unfused_run(argv: list, label: str, card: str) -> dict:
    """A train-CLI run on a path that runs no fused-ELBO kernel: 0 launches
    of K1–K3, the fused BatchNorm's and the VQ kernels' as its forwards
    predict."""
    from midi_vae_tpu_torch.cli import train as train_cli

    reset_launch_counts()
    r = train_cli.cli(argv)
    log_cli_run(label, r, card)
    counts = launch_counts()
    want = {**{k: 0 for k in ops.KERNEL_WRAPPERS}, **expected_model_launches(r)}
    log(f"  launches {counts}, expected {want} (forwards {r['forwards']})")
    check(counts == want, f"{label}: launched {counts}, expected {want}")
    return r


def kernels_at_run_shapes(dev, shapes: dict) -> dict:
    """K1/K2 on [B, 128, 128, 1] logits and K3 with its backward on [B, 10],
    at each (B, dtype) a run of this phase launched them with (``shapes``:
    label → (B, dtype)), against their plain versions at the limits used
    above; returns the max errors over all of them."""
    gen = torch.Generator(device=dev).manual_seed(9)
    errs = {key: 0.0 for key in KERNEL_INFO}
    for label, (b, dtype) in shapes.items():
        what = f"{label} [{b},128,128,1] {str(dtype).removeprefix('torch.')}"
        logits = (3.0 * torch.randn((b, 128, 128, 1), generator=gen, device=dev)).to(dtype)
        targets, _ = make_pianoroll_batch(gen, b, device=dev)
        e1, e2 = check_bce(logits, targets - 0.5, torch.full((), 2.5, device=dev), f"{what} logits, f32 targets")
        mu = torch.randn((b, 10), generator=gen, device=dev).to(dtype)
        lv = (0.3 * torch.randn((b, 10), generator=gen, device=dev)).to(dtype)
        what = f"{label} [{b},10] {str(dtype).removeprefix('torch.')}"
        e3 = check_k3(mu, lv, 21, what)
        z, _ = ops.reparam_kl(mu, lv, 21)
        g_z = torch.randn((b, 10), generator=gen, device=dev).to(dtype)
        e4 = max(check_k3_grad(mu, lv, z, g_z, g_kl, f"{what}, {kl}")
                 for g_kl, kl in ((None, "no g_kl"), (torch.full((), 5.0, device=dev), "g_kl 5")))
        for key, e in zip(("K1", "K2", "K3", "K3-bwd"), (e1, e2, e3, e4)):
            errs[key] = max(errs[key], e)
    return errs


def run_shape(r: dict, batch: int) -> tuple:
    """(batch, dtype) a fused train run launched its kernels with, after
    checking its model has the 128-px, 10-latent shapes
    :func:`kernels_at_run_shapes` holds the kernels at."""
    model = r["state"].model
    check(model.input_dim == 128 and model.latent_dim == 10,
          f"{type(model).__name__}: input {model.input_dim}, latent {model.latent_dim}; the kernel checks assume 128, 10")
    return batch, model.dtype


def accum_step_vs_unfused(dev) -> None:
    """One fused grad_accum = 2 step of the flagship FoldedVAE at batch 100
    against the same step unfused, given the plain draws of its two micro
    seeds: the losses agree within 1e-3 relative."""
    from midi_vae_tpu_torch.core.rng import derive_micro_seed

    model = build_model("FoldedVAE", dtype=torch.bfloat16, fused_reparam=True, seed=0, device=dev, **FLAGSHIP)
    ref = copy.deepcopy(model)
    x, _ = make_pianoroll_batch(torch.Generator(device=dev).manual_seed(10), CLI_BATCH, device=dev)
    kl = kl_weight_schedule("constant", KL_WEIGHT)
    _, lo, _ = make_train_step(kl, fused_loss=True, grad_accum=ACCUM)(
        create_train_state(model, build_optimizer(model, param_group_label, **OPTIMIZER)), x, 0)
    m = CLI_BATCH // ACCUM
    eps = [ops.k3_eps_plain((m, FLAGSHIP["latent_dim"]), derive_micro_seed(derive_step_seed(0, 0), i), dev)
           for i in range(ACCUM)]
    _, ref_lo, _ = make_train_step(kl, fused_loss=False, grad_accum=ACCUM)(
        create_train_state(ref, build_optimizer(ref, param_group_label, **OPTIMIZER)), x, 0, eps=eps)
    rel = abs(lo.loss.item() - ref_lo.loss.item()) / abs(ref_lo.loss.item())
    log(f"  grad_accum {ACCUM} step at batch {CLI_BATCH}: fused loss {lo.loss.item():.7f} vs unfused with the plain "
        f"draws of both micro seeds {ref_lo.loss.item():.7f}: rel {rel:.2e}")
    check(rel <= 1e-3, "fused and unfused accumulated first-step losses differ")


def vq_accum_run(root: Path, models: Path, card: str) -> None:
    """configs/vq16_fold8.yaml with --grad-accum 2 for one epoch: finite
    loss, the quantizer's three EMA buffers moved from their initial values
    (captured as the train loop builds the model), no K1–K3 launched, the
    fused BatchNorm and the VQ kernels as its micro forwards predict."""
    import midi_vae_tpu_torch.train.loop as loop_mod

    initial, real = {}, loop_mod.build_model

    def capture(*args, **kwargs):
        model = real(*args, **kwargs)
        initial.update({n: b.detach().clone() for n, b in model.named_buffers() if n.startswith("quantizer.")})
        return model

    loop_mod.build_model = capture
    try:
        r = unfused_run(["--config", str(root / VQ_CONFIG), "--grad-accum", str(ACCUM), "--stop-after-epochs", "1",
                         "--seed", "0", "--models-dir", str(models), "--run-name", "vq16", "--run-id", "accum"],
                        f"{VQ_CONFIG} --grad-accum {ACCUM}, epoch 1 of 60", card)
    finally:
        loop_mod.build_model = real
    trained = dict(r["state"].model.named_buffers())
    moved = {n: not torch.equal(b, trained[n]) for n, b in initial.items()}
    check(len(moved) == 3 and all(moved.values()), f"quantizer buffers unchanged: {moved}")
    check(math.isfinite(r["train"]["loss"]) and r["forwards"]["train_forwards"] == ACCUM * r["forwards"]["train_steps"],
          f"VQ accumulated run: loss {r['train']['loss']}, forwards {r['forwards']}")
    log(f"  train loss {r['train']['loss']:.6f}; {r['forwards']['train_forwards']} micro forwards in "
        f"{r['forwards']['train_steps']} steps; quantizer buffers moved: {sorted(moved)}; final test codebook "
        f"perplexity {r['final_test']['codebook-perplexity']:.2f}, active codes {r['final_test']['active-codes']}")


def beta_tc_run(root: Path, models: Path, dev, card: str) -> None:
    """configs/beta_tc_vae.yaml as written for 2 of its 100 epochs: the loss
    is finite and falls, no kernel launches; then on one batch on the card,
    with eps injected, the β-TC loss against the same model on the CPU
    (1e-5 relative), and MI, TC and DWKL on both."""
    from midi_vae_tpu_torch.cli.generate import _fetch_eval_batch
    from midi_vae_tpu_torch.losses.tcvae import tc_decomposition
    from midi_vae_tpu_torch.train.state import make_loss

    r = unfused_run(["--config", str(root / BETA_TC_CONFIG), "--stop-after-epochs", str(BETA_TC_EPOCHS), "--seed", "0",
                     "--models-dir", str(models), "--run-name", "betatc", "--run-id", "1"],
                    f"{BETA_TC_CONFIG} as written (VanillaVAE, f32), epochs 1-{BETA_TC_EPOCHS} of 100", card)
    losses = [h["train"]["loss"] for h in r["history"]]
    check(len(losses) == BETA_TC_EPOCHS and all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f"β-TC train loss did not fall: {losses}")
    x, _, _ = _fetch_eval_batch("midi-synthetic", None, 128, CLI_BATCH, {"transform_type": "pianoroll"}, dev)
    eps = torch.randn((x.shape[0], 10), generator=torch.Generator().manual_seed(11))
    loss_fn = make_loss(loss_type="beta-tc", tc_beta=6.0, dataset_size=r["corpus"]["train"])
    got = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        model = copy.deepcopy(r["state"].model).to(d)
        with torch.no_grad():
            out = model(x.to(d), train=True, eps=eps.to(d))
            lo = loss_fn(out, 1.0)
            terms = tc_decomposition(out.latents, out.encoded.mu, out.encoded.log_var, r["corpus"]["train"])
        got[where] = [float(lo.loss)] + [float(t) for t in terms]
    rel = abs(got["card"][0] - got["cpu"][0]) / abs(got["cpu"][0])
    log(f"  epoch losses {losses}; one batch of {x.shape[0]}, eps injected, card vs CPU: loss {got['card'][0]:.7f} vs "
        f"{got['cpu'][0]:.7f} (rel {rel:.2e}); MI {got['card'][1]:.5f} / {got['cpu'][1]:.5f}, TC {got['card'][2]:.5f} / "
        f"{got['cpu'][2]:.5f}, DWKL {got['card'][3]:.5f} / {got['cpu'][3]:.5f} nat [{card}]")
    check(rel <= 1e-5, "β-TC loss on the card disagrees with the CPU")
    timed_step("β-TC (f32)", r["state"], make_train_step(kl_weight_schedule("constant", 1.0), loss_type="beta-tc",
                                                        tc_beta=6.0, dataset_size=r["corpus"]["train"]),
               CLI_BATCH, dev, card)


def conditional_serve(best: Path, dev, card: str) -> None:
    """generate --label and the per-class sweep, evaluate with IWAE, and
    serve with labels over both wires on the conditional run's best model:
    served answers within 1e-4 of the model on the card; 16 threads of
    mixed-label requests all answered correctly and coalesced."""
    import numpy as np

    from midi_vae_tpu_torch.cli import evaluate as evaluate_cli
    from midi_vae_tpu_torch.cli import generate as generate_cli
    from midi_vae_tpu_torch.cli.generate import _fetch_eval_batch, _load_model_and_state
    from midi_vae_tpu_torch.evaluation.inference import interpolate, sample_prior
    from midi_vae_tpu_torch.serving.client import ServingClient
    from midi_vae_tpu_torch.serving.server import serve

    model, cfg, size, _, dataset = _load_model_and_state(str(best), device=dev)
    classes = model.num_classes
    out = best.parent
    one = generate_cli.cli(["--checkpoint", str(best), "--mode", "sample", "-n", "8", "--label", "1",
                            "--out", str(out / "label1.png")])
    sweep = generate_cli.cli(["--checkpoint", str(best), "--mode", "sample", "-n", str(2 * classes),
                              "--out", str(out / "sweep.png")])
    with torch.inference_mode():
        want_one = sample_prior(model, 8, 0, y=torch.full((8,), 1, device=dev)).cpu().numpy()
        want_sweep = sample_prior(model, 2 * classes, 0, y=torch.arange(2 * classes, device=dev) % classes).cpu().numpy()
    err = max(float(np.abs(one - want_one).max()), float(np.abs(sweep - want_sweep).max()))
    check(err <= 1e-6, f"generate --label / the class sweep vs sample_prior: {err}")
    res = evaluate_cli.cli(["--checkpoint", str(best), "--partition", "test", "--iwae-samples", "8", "--mig"])["test"]
    check(all(math.isfinite(res[k]) for k in ("cross-entropy", "kl", "iwae-8", "mig")), f"evaluate: {res}")
    log(f"  {classes} classes; generate --label 1 (8 samples) and the {2 * classes}-sample class sweep equal "
        f"sample_prior under those labels (max |err| {err:.1e}); evaluate: cross-entropy {res['cross-entropy']:.6f}, "
        f"kl {res['kl']:.5f}, iwae-8 {res['iwae-8']:.4f} nat/sample, mig {res['mig']:.5f} [{card}]")

    x_dev, y_dev, _ = _fetch_eval_batch(dataset, None, size, 16, cfg, dev)
    x, y = x_dev.cpu().numpy(), y_dev.cpu().numpy().astype(np.int32)
    httpd = serve(str(best), port=0)
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        health = ServingClient(url).healthz()
        check(health["conditional"] and health["num_classes"] == classes, f"/healthz: {health}")
        yt = torch.from_numpy(y[:5]).long().to(dev)
        with torch.inference_mode():
            enc = model.encode(x_dev[:5], train=False, y=yt)
            direct = {"reconstruct": model.decode(enc.mu, train=False, y=yt).cpu().numpy(),
                      "encode": torch.cat([enc.mu, enc.log_var], -1).cpu().numpy(),
                      "interpolate": interpolate(model, x_dev[:1], x_dev[1:2], steps=8, y=yt[:1])[:, 0].cpu().numpy(),
                      "sample": sample_prior(model, 16, 3, y=torch.arange(16, device=dev) % classes).cpu().numpy()}
        errs = {}
        for wire in ("npy", "json"):
            c = ServingClient(url, wire=wire)
            got = {"reconstruct": c.reconstruct(x[:5], labels=y[:5]),
                   "encode": np.concatenate(c.encode(x[:5], labels=y[:5]), axis=1),
                   "interpolate": c.interpolate(x[0], x[1], steps=8, labels=int(y[0])),
                   "sample": c.sample(16, 3, labels=np.arange(16) % classes)}
            for key, want in direct.items():
                check(got[key].shape == want.shape, f"served {key} ({wire}): shape {got[key].shape}")
                errs[(wire, key)] = float(np.abs(got[key] - want).max())
        log("  served with labels vs the model on the card, max |err|: " + "; ".join(
            f"{w} {k} {e:.3e}" for (w, k), e in errs.items()) + f" [{card}]")
        check(max(errs.values()) <= 1e-4, f"served outputs with labels disagree: {errs}")

        before = ServingClient(url).healthz()
        rng = np.random.default_rng(1)
        plan = [[(int(s), int(n), int(k)) for s, n, k in zip(rng.integers(0, 12, SERVE_REQUESTS),
                                                             rng.integers(1, 5, SERVE_REQUESTS),
                                                             rng.integers(0, classes, SERVE_REQUESTS))]
                for _ in range(SERVE_THREADS)]
        with torch.inference_mode():
            want = {}
            for reqs in plan:
                for s, n, k in reqs:
                    yk = torch.full((n,), k, device=dev)
                    want[(s, n, k)] = model.decode(model.encode(x_dev[s:s + n], y=yk).mu, y=yk).cpu().numpy()
        errors = []

        def worker(reqs):
            c = ServingClient(url)
            try:
                for s, n, k in reqs:
                    if float(np.abs(c.reconstruct(x[s:s + n], labels=k) - want[(s, n, k)]).max()) > 1e-4:
                        errors.append(f"request ({s}, {n}, class {k}): wrong answer")
            except Exception as e:  # noqa: BLE001 - every failure is reported below
                errors.append(repr(e))

        threads = [threading.Thread(target=worker, args=(reqs,)) for reqs in plan]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        after = ServingClient(url).healthz()
        served_n = after["requests_served"] - before["requests_served"]
        batches = after["batches_dispatched"] - before["batches_dispatched"]
        check(not errors and served_n == SERVE_THREADS * SERVE_REQUESTS and batches < served_n,
              f"mixed-label load: {errors[:5]}, {served_n} requests in {batches} batches")
        log(f"  /reconstruct with labels under load, {SERVE_THREADS} threads x {SERVE_REQUESTS} requests of 1-4 rolls, "
            f"classes mixed: all {served_n} correct, {batches} device batches ({served_n / batches:.2f} requests per "
            f"batch) [{card}]")

        client, one, label = ServingClient(url), x[:1], y[:1]
        timed(lambda: client.reconstruct(one, labels=label), 10)
        seq = timed(lambda: client.reconstruct(one, labels=label), SEQUENTIAL_REQUESTS)
        device, n_kernels = device_ms_per_call(lambda: httpd.service._reconstruct_rows(one, label), dev)
        log(f"  /reconstruct with a label, 1 roll, npy, sequential ({SEQUENTIAL_REQUESTS} after 10 warm-up): p50 "
            f"{quantile_ms(seq, 50):.3f} ms, p99 {quantile_ms(seq, 99):.3f} ms; its dispatch on the device "
            f"{device:.4f} ms ({n_kernels:.0f} kernels and copies) [{card}]")
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.service.close()


def conditional_prior(root: Path, vq_best: Path, card: str) -> None:
    """train_prior --conditional (the config's transformer, 1 epoch) over
    the VQ phase's checkpoint, served with a label: /sample equals the
    direct sampler under that label for its seed."""
    import numpy as np

    from midi_vae_tpu_torch.cli import train_prior
    from midi_vae_tpu_torch.models.prior import sample_codes_autoregressive
    from midi_vae_tpu_torch.serving.client import ServingClient
    from midi_vae_tpu_torch.serving.server import serve

    path = vq_best.parent / "prior_conditional.pt"
    path.unlink(missing_ok=True)  # trained from scratch, not resumed
    p = train_prior.cli(["--config", str(root / VQ_CONFIG), "--checkpoint", str(vq_best), "--conditional",
                         "--augment-passes", "0", "--epochs", "1", "--out", str(path)])
    httpd = serve(str(vq_best), port=0, prior=str(path))
    try:
        service = httpd.service
        classes = service.prior_info["num_classes"]
        check(classes >= 1 and math.isfinite(p["history"][0]["nll"]), f"conditional prior: {classes} classes, {p}")
        client = ServingClient(f"http://127.0.0.1:{httpd.server_address[1]}")
        got = client.sample(SAMPLE_N, 3, labels=classes - 1)
        with torch.inference_mode():
            idx = sample_codes_autoregressive(service.prior, 3, SAMPLE_N, service.model.last_conv_size,
                                              y=[classes - 1] * SAMPLE_N)
            want = service.model.decode_indices(idx).cpu().numpy()
        err = float(np.abs(got - want).max())
        check(err <= 1e-4, f"/sample with a label vs the direct sampler: {err}")
        log(f"  class-conditional transformer prior over {classes} class(es) (1 epoch, nll "
            f"{p['history'][0]['nll']:.4f}): /sample n={SAMPLE_N} label {classes - 1} vs the direct sampler, same "
            f"seed: max |err| {err:.3e} [{card}]")
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.service.close()


def mlp_card_vs_cpu(r: dict, dev, card: str) -> None:
    """The trained MLPVAE on the card against the same weights on the CPU,
    f32, batch 16, eps injected: logits within 1e-4."""
    model = copy.deepcopy(r["state"].model).float()
    cpu = copy.deepcopy(model).cpu()
    x, _ = make_pianoroll_batch(torch.Generator(device=dev).manual_seed(12), 16, device=dev)
    eps = torch.randn((16, model.latent_dim), generator=torch.Generator().manual_seed(13))
    with torch.no_grad():
        err = float((model(x, train=True, eps=eps.to(dev)).logits.cpu()
                     - cpu(x.cpu(), train=True, eps=eps).logits).abs().max())
    log(f"  MLPVAE (hidden {model.hidden_dims}) card vs CPU, f32 batch 16: logits max |err| {err:.3e} [{card}]")
    check(err <= 1e-4, "MLPVAE on the card disagrees with the CPU")


def reference_lrs(scheduler: str, lr: float, total: int) -> list:
    """The LR before each of ``total`` steps from torch's own schedulers
    (OneCycleLR, CosineAnnealingLR, StepLR at the JAX package's step size
    1000 and γ 0.1), in f64: the yardstick of the logged LRs. The JAX
    package's OneCycle holds its warm-up to at least one step, which is
    torch's whenever 0.3·total ≥ 2 (total = 7 here)."""
    check(scheduler.lower() != "onecycle" or 0.3 * total >= 2, f"OneCycle over {total} steps: no yardstick")
    opt = torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=lr)
    sched = {
        "onecycle": lambda: torch.optim.lr_scheduler.OneCycleLR(opt, max_lr=lr, total_steps=total, cycle_momentum=False),
        "cosine": lambda: torch.optim.lr_scheduler.CosineAnnealingLR(opt, T_max=total),
        "step": lambda: torch.optim.lr_scheduler.StepLR(opt, step_size=1000, gamma=0.1),
    }[scheduler.lower()]()
    lrs = []
    for _ in range(total):
        lrs.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    return lrs


def optimizer_runs(root: Path, models: Path, dev, card: str) -> None:
    """One epoch of configs/folded.yaml (unfused) with each optimizer, and
    AdamW under the cosine and step schedules: finite loss, every logged LR
    within 1e-5 of torch's own scheduler, no kernel launched; then each
    step alone at batch 100 (:func:`timed_step`)."""
    from midi_vae_tpu_torch.data.transforms import get_transform
    from midi_vae_tpu_torch.train.config import from_yaml
    from midi_vae_tpu_torch.train.optim import scale_lr

    spec, _ = get_transform("pianoroll", 128, {"normalization": "midi-synthetic"})
    runs = [(name, "OneCycle") for name in OPTIMIZERS] + [("AdamW", "cosine"), ("AdamW", "step")]
    for name, scheduler in runs:
        run_id = f"{name}-{scheduler}"
        r = unfused_run(["--config", str(root / "configs" / "folded.yaml"), "--optimizer", name, "--scheduler", scheduler,
                         "--epochs", "1", "--log-interval", "1", "--print-interval", "100", "--seed", "0",
                         "--models-dir", str(models),
                         "--run-name", "opt", "--run-id", run_id],
                        f"configs/folded.yaml, {name} under {scheduler}, 1 epoch", card)
        check(math.isfinite(r["train"]["loss"]) and math.isfinite(r["final_test"]["cross-entropy"]),
              f"{run_id}: loss {r['train']['loss']}")
        rows = [json.loads(line) for line in (models / "midi-synthetic" / f"opt__{run_id}" / "metrics.jsonl")
                .read_text().splitlines()]
        logged = [(row["step"], row["training/stepwise/lr-decoder"]) for row in rows
                  if "training/stepwise/lr-decoder" in row]
        cfg = from_yaml(str(root / "configs" / "folded.yaml"))
        want = reference_lrs(scheduler, scale_lr(cfg.lr_relative, CLI_BATCH) * cfg.lr_decoder_mult, r["steps_per_epoch"])
        worst = max(abs(v - want[s - 1]) / want[s - 1] for s, v in logged)
        check(logged and worst <= 1e-5, f"{run_id}: logged LRs {logged} vs torch's scheduler {want}")

        log(f"  {name} under {scheduler}: train loss {r['train']['loss']:.6f}, {len(logged)} logged LRs within "
            f"{worst:.1e} of torch's scheduler")
        step = make_train_step(kl_weight_schedule("constant", 2.5e-4), target_denorm=(tuple(spec.mean), tuple(spec.std)))
        timed_step(f"{name} ({scheduler})", r["state"], step, CLI_BATCH, dev, card)


def variants_phase(dev, root: Path, card: str) -> tuple:
    """The training variants (module docstring, item 10). Returns (the
    accumulated fused run's launches, the launches of every run of the
    phase, the max kernel errors at the fused runs' shapes)."""
    t_phase = time.perf_counter()
    models = root / "build" / "variant_models"
    shutil.rmtree(models, ignore_errors=True)
    config = str(root / "configs" / "folded.yaml")
    total: dict = {}

    log(f"  grad_accum {ACCUM}, fused (configs/folded.yaml):")
    r, accum = fused_run(["--config", config, "--fused", "--bce-targets", "normalized", "--grad-accum", str(ACCUM),
                          "--epochs", "1", "--seed", "0", "--models-dir", str(models), "--run-name", "accum",
                          "--run-id", "fused"], 1, f"--grad-accum {ACCUM} --fused, 1 epoch", card)
    check(r["forwards"]["train_forwards"] == ACCUM * r["forwards"]["train_steps"], f"forwards {r['forwards']}")
    check(math.isfinite(r["train"]["loss"]), f"accumulated run: loss {r['train']['loss']}")
    add_counts(total, accum)
    shapes = {"micro-batch": run_shape(r, CLI_BATCH // ACCUM)}
    accum_step_vs_unfused(dev)
    small_batch_steps(r["state"], dev, card, grad_accum=ACCUM)

    log(f"  grad_accum {ACCUM}, VQ ({VQ_CONFIG}):")
    vq_accum_run(root, models, card)

    log(f"  β-TC ({BETA_TC_CONFIG}):")
    beta_tc_run(root, models, dev, card)

    log(f"  conditional ({CONDITIONAL_CONFIG}'s model and optimizer on {CONDITIONAL_DATASET}, fused):")
    r, counts = fused_run(["--config", str(root / CONDITIONAL_CONFIG), "--dataset", CONDITIONAL_DATASET,
                           "--image-size", "128", "--transform-type", "noaug", "--fused", "--save-best-model",
                           "--stop-after-epochs", str(CONDITIONAL_EPOCHS), "--seed", "0", "--models-dir", str(models),
                           "--run-name", "cond", "--run-id", "fused"], CONDITIONAL_EPOCHS,
                          f"conditional VanillaVAE, epochs 1-{CONDITIONAL_EPOCHS} of 5", card)
    add_counts(total, counts)
    shapes["conditional batch"] = run_shape(r, CONDITIONAL_BATCH)
    losses = [h["train"]["loss"] for h in r["history"]]
    check(r["state"].model.num_classes > 1 and losses[-1] < losses[0], f"conditional run: losses {losses}")
    labels = torch.arange(CONDITIONAL_BATCH, device=dev) % r["state"].model.num_classes
    timed_step("conditional fused (f32)", r["state"], make_train_step(kl_weight_schedule("constant", 1.0),
                                                                    fused_loss=True), CONDITIONAL_BATCH, dev, card,
               y=labels)
    conditional_serve(models / CONDITIONAL_DATASET / "cond__fused" / "best_model.pt", dev, card)
    conditional_prior(root, root / "build" / "vq_models" / "midi-synthetic" / "vq16__stage1" / "best_model.pt", card)

    log(f"  MLPVAE (hidden {' '.join(MLP_HIDDEN)}, midi-synthetic, fused):")
    r, counts = fused_run(["--dataset", "midi-synthetic", "--transform-type", "pianoroll", "--image-size", "128",
                           "--model", "MLPVAE", "--hidden-dims", *MLP_HIDDEN, "--fused", "--bce-targets", "normalized",
                           "--batch-size", str(CLI_BATCH), "--lr", MLP_LR, "--epochs", MLP_EPOCHS, "--stop-after-epochs",
                           "1", "--seed", "0", "--models-dir", str(models), "--run-name", "mlp", "--run-id", "fused"],
                          1, f"MLPVAE --fused, epoch 1 of {MLP_EPOCHS}", card)
    add_counts(total, counts)
    shapes["MLPVAE batch"] = run_shape(r, CLI_BATCH)
    check(math.isfinite(r["train"]["loss"]), f"MLPVAE run: loss {r['train']['loss']}")
    mlp_card_vs_cpu(r, dev, card)
    timed_step("MLPVAE fused (f32)", r["state"], make_train_step(kl_weight_schedule("constant", 1.0), fused_loss=True),
               CLI_BATCH, dev, card)

    log("  optimizers and schedules (configs/folded.yaml as written, unfused):")
    optimizer_runs(root, models, dev, card)

    log("  K1, K2, K3 and K3's backward at the fused runs' shapes and dtypes, against their plain versions:")
    errs = kernels_at_run_shapes(dev, shapes)

    log(f"  launches: accumulated run {accum}; every run of the phase {total}; the phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return accum, total, errs

# ========================================================== model variants


SUB4_STEPS, REMAT_STEPS = 30, 10  # the flagship windows under --norm batch-sub4 and --remat
NONE_STEPS = 10  # the --norm none windows (with and without --remat): the yardsticks of BatchNorm's share
VANILLA_WIDTHS = ("32", "64", "128", "256")  # VanillaVAE's reference widths
VANILLA_RUNS = {  # the train CLI's flags of each VanillaVAE variant run (128 px, batch 100, one epoch)
    "BatchNorm": [],  # the plain model: the yardstick of GroupNorm and no norm
    "BatchNorm, fused": ["--fused"],  # the yardstick of the fused s2d/d2s run
    "s2d stem + d2s head, fused": ["--stem", "s2d", "--head", "d2s", "--fused"],
    "GroupNorm": ["--norm", "group"],
    "no norm": ["--norm", "none"],
}
VANILLA_YARDSTICKS = {"s2d stem + d2s head, fused": "BatchNorm, fused", "GroupNorm": "BatchNorm", "no norm": "BatchNorm"}


def flagship_variant_window(dev, card: str, label: str, steps: int, **variant) -> dict:
    """The flagship fused step (train_phase's configuration) with a model
    variant: one fused step against the unfused step from the same weights
    and batch given the plain draw (1e-3 relative), then a window of
    ``steps`` fused steps (K1–K3 once each per step, peak memory), then a
    profile of three more. Returns the window's numbers."""
    model = build_model("FoldedVAE", dtype=torch.bfloat16, fused_reparam=True, seed=0, device=dev, **FLAGSHIP,
                        **variant)
    data_gen = torch.Generator(device=dev).manual_seed(1)
    x0, _ = make_pianoroll_batch(data_gen, BATCH, device=dev)
    kl = kl_weight_schedule("constant", KL_WEIGHT)
    ref = copy.deepcopy(model)
    eps = ops.k3_eps_plain((BATCH, FLAGSHIP["latent_dim"]), derive_step_seed(0, 0), dev)
    _, ref_lo, _ = make_train_step(kl, fused_loss=False)(
        create_train_state(ref, build_optimizer(ref, param_group_label, **OPTIMIZER)), x0, 0, eps=eps)
    ref_loss = ref_lo.loss.item()
    del ref

    state = create_train_state(model, build_optimizer(model, param_group_label, **OPTIMIZER))
    step = make_train_step(kl, fused_loss=True)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    losses, step_ms = [], []
    x = x0
    for i in range(steps):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if i:
            x, _ = make_pianoroll_batch(data_gen, BATCH, device=dev)
        state, lo, _ = step(state, x, 0)
        losses.append(lo.loss.item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    check(all(math.isfinite(v) for v in losses), f"{label}: losses {losses}")
    want = {**{k: steps for k in ops.KERNEL_WRAPPERS}, **model_launches(model, steps)}
    check(counts == want, f"{label}: launched {counts} in {steps} fused steps, expected {want}")
    rel = abs(losses[0] - ref_loss) / abs(ref_loss)
    check(rel <= 1e-3, f"{label}: fused first-step loss {losses[0]} vs unfused {ref_loss}")
    med = statistics.median(step_ms)
    throughput = BATCH * steps / sum(step_ms) * 1e3
    log(f"  {label}: {throughput:.1f} samples/s over {steps} fused steps at batch {BATCH} (step median {med:.3f} ms, "
        f"min {min(step_ms):.3f}); launches {counts}; first fused step loss {losses[0]:.7f} vs unfused "
        f"{ref_loss:.7f}: rel {rel:.2e}; peak memory {peak_gib:.3f} GiB [{card}]")
    _, busy = profile_steps(state, step, data_gen, 0, dev, med)
    return {"samples_per_s": throughput, "median_ms": med, "busy_ms": busy, "peak_gib": peak_gib, "counts": counts}


def remat_equivalence(dev, card: str) -> None:
    """The flagship step with remat on and off from the same weights, batch
    and draw (unfused, eps given): losses within 1e-5 relative, every
    BatchNorm buffer identical after the step."""
    kl = kl_weight_schedule("constant", KL_WEIGHT)
    x, _ = make_pianoroll_batch(torch.Generator(device=dev).manual_seed(11), BATCH, device=dev)
    eps = ops.k3_eps_plain((BATCH, FLAGSHIP["latent_dim"]), derive_step_seed(0, 0), dev)
    out = {}
    for remat in (False, True):
        model = build_model("FoldedVAE", dtype=torch.bfloat16, fused_reparam=True, seed=0, device=dev, remat=remat,
                            **FLAGSHIP)
        _, lo, _ = make_train_step(kl, fused_loss=False)(
            create_train_state(model, build_optimizer(model, param_group_label, **OPTIMIZER)), x, 0, eps=eps)
        out[remat] = (lo.loss.item(), {k: v.clone() for k, v in model.state_dict().items() if "running" in k})
    rel = abs(out[True][0] - out[False][0]) / abs(out[False][0])
    same = [k for k in out[False][1] if torch.equal(out[False][1][k], out[True][1][k])]
    log(f"  remat on vs off, same weights, batch and draw: loss {out[True][0]:.7f} vs {out[False][0]:.7f} (rel "
        f"{rel:.2e}); {len(same)} of {len(out[False][1])} BatchNorm buffers identical [{card}]")
    check(rel <= 1e-5 and len(same) == len(out[False][1]), "remat changes the step")


def card_vs_cpu(model, label: str, card: str, batch: int = 4) -> None:
    """A trained model on the card against the same weights on the CPU, f32,
    eps injected: train-mode logits and the eval reconstruction within 1e-4."""
    gpu = copy.deepcopy(model).float()
    cpu = copy.deepcopy(gpu).cpu()
    dev = next(gpu.parameters()).device
    x, _ = make_pianoroll_batch(torch.Generator(device=dev).manual_seed(14), batch, device=dev)
    eps = torch.randn((batch, gpu.latent_dim), generator=torch.Generator().manual_seed(13))
    with torch.no_grad():
        errs = [float((gpu(x, train=True, eps=eps.to(dev)).logits.cpu() - cpu(x.cpu(), train=True, eps=eps).logits)
                      .abs().max()),
                float((gpu.decode(gpu.encode(x, train=False).mu, train=False).cpu()
                       - cpu.decode(cpu.encode(x.cpu(), train=False).mu, train=False)).abs().max())]
    log(f"  {label} card vs CPU, f32 batch {batch}: train logits max |err| {errs[0]:.3e}, eval reconstruction "
        f"{errs[1]:.3e} [{card}]")
    check(max(errs) <= 1e-4, f"{label} on the card disagrees with the CPU")


def vanilla_variant_runs(dev, models: Path, card: str) -> tuple:
    """VanillaVAE at its reference widths, 128 px, through the train CLI,
    one epoch of each VANILLA_RUNS entry: card against CPU, the step timed
    and its device time set against the plain step's from this run.
    Returns (the fused-ELBO launches of the runs, the fused runs' kernel
    shapes)."""
    total: dict = {}
    shapes = {}
    device_ms = {}
    for label, flags in VANILLA_RUNS.items():
        argv = ["--dataset", "midi-synthetic", "--transform-type", "pianoroll", "--image-size", "128", "--model",
                "VanillaVAE", "--hidden-dims", *VANILLA_WIDTHS, "--batch-size", str(CLI_BATCH), "--lr", MLP_LR,
                "--epochs", "1", "--seed", "0", "--models-dir", str(models), "--run-name", "vanilla",
                "--run-id", "_".join(flags).replace("-", "") or "plain"] + flags
        fused = "--fused" in flags
        if fused:
            r, counts = fused_run(argv, 1, f"VanillaVAE {label}, 1 epoch", card)
            shapes[f"VanillaVAE {label} batch"] = run_shape(r, CLI_BATCH)
        else:
            r = unfused_run(argv, f"VanillaVAE {label}, 1 epoch", card)
            counts = launch_counts()
        add_counts(total, counts)
        check(math.isfinite(r["train"]["loss"]) and math.isfinite(r["final_test"]["cross-entropy"]),
              f"VanillaVAE {label}: loss {r['train']['loss']}")
        card_vs_cpu(r["state"].model, f"VanillaVAE {label}", card)
        device_ms[label] = timed_step(f"VanillaVAE {label} (f32)", r["state"],
                                      make_train_step(kl_weight_schedule("constant", KL_WEIGHT), fused_loss=fused),
                                      CLI_BATCH, dev, card)
    log("  VanillaVAE device ms per step against the plain step's, this run: " + "; ".join(
        f"{label} {device_ms[label]:.3f} / {device_ms[base]:.3f} ({base}) = {device_ms[label] / device_ms[base]:.1%}"
        for label, base in VANILLA_YARDSTICKS.items()) + f" [{card}]")
    return total, shapes


def torch_compat_check(dev, models: Path, card: str) -> None:
    """A reference-layout state_dict (a torch_compat VanillaVAE at the
    reference widths and 32 px, its running statistics moved, written out by
    the port's exporter) loaded into a fresh model on the card: the forward
    against the CPU's (1e-4), the state_dict back bitwise; then one epoch of
    the train CLI with --torch-compat."""
    from midi_vae_tpu_torch.interop.torch_reference import export_reference_state_dict, import_reference_state_dict

    kw = dict(in_channels=1, latent_dim=10, input_dim=32, hidden_dims=tuple(int(w) for w in VANILLA_WIDTHS),
              torch_compat=True)
    src = build_model("VanillaVAE", seed=8, device="cpu", **kw)
    gen = torch.Generator().manual_seed(15)
    with torch.no_grad():
        for _ in range(3):
            src(torch.rand((8, 32, 32, 1), generator=gen), train=True, eps=torch.zeros(8, 10))
    sd = export_reference_state_dict(src, num_batches_tracked=3)
    on_card, on_cpu = build_model("VanillaVAE", seed=9, device=dev, **kw), build_model("VanillaVAE", seed=9,
                                                                                     device="cpu", **kw)
    import_reference_state_dict(on_card, sd)
    import_reference_state_dict(on_cpu, sd)
    back = export_reference_state_dict(on_card, num_batches_tracked=3)
    check(list(back) == list(sd) and all(torch.equal(back[k], sd[k]) for k in sd),
          "the reference state_dict did not round-trip through the card bitwise")
    x = torch.rand((8, 32, 32, 1), generator=gen)
    eps = torch.randn((8, 10), generator=gen)
    with torch.no_grad():
        err = max(float((on_card(x.to(dev), train=t, eps=eps.to(dev)).output.cpu()
                         - on_cpu(x, train=t, eps=eps).output).abs().max()) for t in (False, True))
    log(f"  torch_compat: reference state_dict ({len(sd)} tensors) loaded on the card and written back bitwise; "
        f"forward (eval and train) vs the CPU max |err| {err:.3e} [{card}]")
    check(err <= 1e-4, "the torch_compat model on the card disagrees with the CPU")
    r = unfused_run(["--dataset", "vae-lines-synthetic", "--transform-type", "noaug", "--image-size", "32",
                     "--torch-compat", "--epochs", "1", "--seed", "0", "--models-dir", str(models),
                     "--run-name", "torch_compat", "--run-id", "1"], "VanillaVAE --torch-compat, 1 epoch", card)
    check(math.isfinite(r["train"]["loss"]) and r["state"].model.torch_compat, f"torch_compat run: {r['train']}")


def model_variants_phase(dev, root: Path, card: str, flagship: dict) -> tuple:
    """The remaining model variants (module docstring, item 11). Returns (the
    fused-ELBO launches of every run of the phase, the max kernel errors at
    the new fused run's shape)."""
    t_phase = time.perf_counter()
    models = root / "build" / "model_variants"
    shutil.rmtree(models, ignore_errors=True)
    total: dict = {}

    windows = {
        "--norm batch-sub4": flagship_variant_window(dev, card, "flagship --norm batch-sub4", SUB4_STEPS,
                                                     norm="batch-sub4"),
        "--remat": flagship_variant_window(dev, card, "flagship --remat", REMAT_STEPS, remat=True),
    }
    none = {
        False: flagship_variant_window(dev, card, "flagship --norm none", NONE_STEPS, norm="none"),
        True: flagship_variant_window(dev, card, "flagship --norm none --remat", NONE_STEPS, norm="none", remat=True),
    }
    for w in [*windows.values(), *none.values()]:
        add_counts(total, w["counts"])
    log(f"  flagship windows at batch {BATCH}, this run: --norm batch {flagship['samples_per_s']:.1f} samples/s "
        f"(train phase), " + ", ".join(f"{k} {w['samples_per_s']:.1f}" for k, w in windows.items())
        + f", --norm none {none[False]['samples_per_s']:.1f}, --norm none --remat {none[True]['samples_per_s']:.1f} "
        f"[{card}]")
    rows = {"--norm batch": (flagship, none[False]), "--norm batch-sub4": (windows["--norm batch-sub4"], none[False]),
            "--remat": (windows["--remat"], none[True])}
    for label, (w, yardstick) in rows.items():
        log(f"  {label}: device busy {w['busy_ms']:.3f} ms/step ({w['busy_ms'] / w['median_ms']:.1%} of the "
            f"{w['median_ms']:.3f} ms median step); BatchNorm's share of device time "
            f"{1 - yardstick['busy_ms'] / w['busy_ms']:.1%} (the same step with --norm none: "
            f"{yardstick['busy_ms']:.3f} ms) [{card}]")
    log(f"  peak memory of the window: --remat {windows['--remat']['peak_gib']:.3f} GiB vs without "
        f"{flagship['peak_gib']:.3f} GiB (train phase) and {windows['--norm batch-sub4']['peak_gib']:.3f} GiB "
        f"(batch-sub4); --norm none {none[False]['peak_gib']:.3f} GiB, with --remat {none[True]['peak_gib']:.3f} GiB "
        f"[{card}]")
    remat_equivalence(dev, card)

    log("  VanillaVAE variants through the train CLI (reference widths, 128 px, batch 100):")
    counts, shapes = vanilla_variant_runs(dev, models, card)
    add_counts(total, counts)
    log("  torch_compat (reference state_dict, 32 px):")
    torch_compat_check(dev, models, card)
    errs = kernels_at_run_shapes(dev, shapes)
    log(f"  launches across the phase {total}; the phase took {time.perf_counter() - t_phase:.1f} s")
    return total, errs


# ================================================================ artifact


def artifact_phase(dev, root: Path, card: str) -> dict:
    """The exported serving artifact (module docstring, item 12). Returns the
    launches across it: K1–K3 none; the fused BatchNorm's as served (one
    request on each server held to its forward)."""
    import numpy as np

    from midi_vae_tpu_torch.cli.generate import _fetch_eval_batch, _load_model_and_state
    from midi_vae_tpu_torch.cli.train_prior import load_prior
    from midi_vae_tpu_torch.interop import aot_export
    from midi_vae_tpu_torch.models.prior import sample_codes_autoregressive
    from midi_vae_tpu_torch.serving.client import ServingClient
    from midi_vae_tpu_torch.serving.server import serve

    t_phase = time.perf_counter()
    out = root / "build" / "artifact"
    shutil.rmtree(out, ignore_errors=True)
    ckpt = root / "build" / "cli_models" / "midi-synthetic" / "cli__fused" / "best_model.pt"
    vq_dir = root / "build" / "vq_models" / "midi-synthetic" / "vq16__stage1"
    reset_launch_counts()

    def stop(*servers):
        for h in servers:
            h.shutdown()
            h.server_close()
            h.service.close()

    t0 = time.perf_counter()
    manifest = aot_export.main(["--checkpoint", str(ckpt), "--out", str(out / "folded")])
    export_s = time.perf_counter() - t0
    log(f"  exported {ckpt.parent.name}/{ckpt.name} for {manifest['platforms']} in {export_s:.3f} s: " + ", ".join(
        f"{name} {rec['bytes'][dev.type] / 1e6:.3f} MB (export {rec['export_s'][dev.type]:.3f} s)"
        for name, rec in manifest["programs"].items()) + f" [{card}]")
    t0 = time.perf_counter()
    art = serve(artifact=str(out / "folded"), port=0)
    load_s = time.perf_counter() - t0
    ck = serve(str(ckpt), port=0)
    try:
        urls = {k: f"http://127.0.0.1:{h.server_address[1]}" for k, h in (("artifact", art), ("checkpoint", ck))}
        health = ServingClient(urls["artifact"]).healthz()
        check(health["model"] == "FoldedVAE (AOT artifact)" and health["artifact"]["platforms"] == [dev.type],
              f"/healthz: {health}")
        model, cfg, size, _, dataset = _load_model_and_state(str(ckpt), device="cpu")
        x, _, _ = _fetch_eval_batch(dataset, None, size, 16, cfg, "cpu")
        x = x.numpy()
        got = {}
        for where, url in urls.items():
            c = ServingClient(url)
            got[where] = {"reconstruct": c.reconstruct(x[:5]), "encode": np.concatenate(c.encode(x[:5]), axis=1),
                          "sample": c.sample(16, 3), "interpolate lerp": c.interpolate(x[0], x[1], steps=8),
                          "interpolate slerp": c.interpolate(x[0], x[1], steps=8, slerp=True)}
        errs = {k: float(np.abs(got["artifact"][k] - v).max()) for k, v in got["checkpoint"].items()}
        log(f"  serve --artifact on the card (loaded and listening in {load_s:.3f} s) vs the checkpoint server, max "
            "|err|: " + "; ".join(f"{k} {e:.3e}" for k, e in errs.items()) + f"; /healthz {health['model']} [{card}]")
        check(max(errs.values()) <= 1e-5, f"the artifact server disagrees with the checkpoint server: {errs}")
        for where, url in urls.items():  # a reconstruction: one forward, the fused BatchNorm once a layer
            before, want = launch_counts(), model_launches(model, 0, 1)
            ServingClient(url).reconstruct(x[:1])
            probe = {k: launch_counts()[k] - before[k] for k in want}
            check(probe == want, f"a {where} /reconstruct launched {probe} of the fused BatchNorm and the VQ "
                  f"kernels, expected {want}")
        log(f"  one /reconstruct launches the fused BatchNorm {fused_norms(model)} times on either server, the "
            "exported programs' operators included")
        lat = {}
        for where, url in urls.items():
            c = ServingClient(url)
            timed(lambda: c.reconstruct(x[:1]), 10)
            lat[where] = timed(lambda: c.reconstruct(x[:1]), SEQUENTIAL_REQUESTS)
        log("  /reconstruct, 1 roll, npy, sequential (" + str(SEQUENTIAL_REQUESTS) + " after 10 warm-up): " + "; ".join(
            f"{k} p50 {quantile_ms(v, 50):.3f} ms, p99 {quantile_ms(v, 99):.3f} ms" for k, v in lat.items())
            + f" [{card}]")
    finally:
        stop(art, ck)

    prior_path = vq_dir / "prior_latest.pt"
    t0 = time.perf_counter()
    manifest = aot_export.main(["--checkpoint", str(vq_dir / "best_model.pt"), "--out", str(out / "vq"), "--prior",
                                str(prior_path)])
    log(f"  exported the VQ run with its {manifest['prior']['arch']} prior in {time.perf_counter() - t0:.3f} s: "
        + ", ".join(f"{name} {rec['bytes'][dev.type] / 1e6:.3f} MB" for name, rec in manifest["programs"].items())
        + f" [{card}]")
    art = serve(artifact=str(out / "vq"), port=0)
    ck = serve(str(vq_dir / "best_model.pt"), port=0, prior=str(prior_path))
    try:
        n, seed, temperature = 4, 3, 0.9
        prior, _ = load_prior(str(prior_path), device=dev)
        grid = manifest["prior"]["grid"]
        with torch.inference_mode():
            want_codes = sample_codes_autoregressive(prior, seed, n, grid, temperature=temperature)
        codes = art.service._bundle.sample_codes(seed, temperature, np.zeros(n, np.int32))
        same = int((codes.int() == want_codes).sum())
        a = ServingClient(f"http://127.0.0.1:{art.server_address[1]}")
        b = ServingClient(f"http://127.0.0.1:{ck.server_address[1]}")
        t0 = time.perf_counter()
        got = a.sample(n, seed, temperature=temperature)
        art_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = b.sample(n, seed, temperature=temperature)
        ck_s = time.perf_counter() - t0
        err = float(np.abs(got - want).max())
        log(f"  VQ artifact /sample n={n} (temperature {temperature}): codes equal to the port's sampler on "
            f"{same} of {want_codes.numel()} positions; images vs the checkpoint server with --prior max |err| "
            f"{err:.3e}; {art_s:.3f} s vs {ck_s:.3f} s [{card}]")
        check(same == want_codes.numel() and err <= 1e-5, "the VQ artifact's sampler disagrees")
    finally:
        stop(art, ck)

    counts = launch_counts()
    check(elbo_launches(counts) == {k: 0 for k in ops.KERNEL_WRAPPERS},
          f"the artifact path launched a fused-ELBO kernel: {counts}")
    log(f"  launches across the artifact phase: {counts}; the phase took {time.perf_counter() - t_phase:.1f} s")
    return counts


# ================================================================ parallel

PARALLEL_STEPS = 10  # world-1 window of each step implementation
TWO_RANK_STEPS = 3  # two ranks sharing the card over gloo


def flagship_state(dev, weights: dict):
    """A fused bf16 flagship FoldedVAE from ``weights`` with a fresh AdamW/OneCycle."""
    model = build_model("FoldedVAE", dtype=torch.bfloat16, fused_reparam=True, seed=0, device=dev, **FLAGSHIP)
    model.load_state_dict(weights)
    return create_train_state(model, build_optimizer(model, param_group_label, **OPTIMIZER))


def flagship_batches(dev, n: int) -> list:
    """``n`` on-device batches of BATCH synthetic rolls, the same for every caller."""
    gen = torch.Generator(device=dev).manual_seed(5)
    return [make_pianoroll_batch(gen, BATCH, device=dev)[0] for _ in range(n)]


def param_vector(model) -> torch.Tensor:
    return torch.cat([p.detach().float().reshape(-1) for p in model.parameters()])


def update_vector(model) -> torch.Tensor:
    """The parameters whose gradient is not zero by construction: all but the
    biases of convs followed by a norm (the norm cancels them, so AdamW moves
    them by noise; ``tests/test_torch_accum.py`` exempts them the same way)."""
    return torch.cat([p.detach().float().reshape(-1) for name, p in model.named_parameters()
                      if not (name.endswith(("Conv_0.bias", "ConvTranspose_0.bias")) and "Block_" in name)])


def step_window(state, step, xs: list, dev, rows=None) -> dict:
    """Steps over ``xs`` (this rank's ``rows`` of each), each closed by reading
    its loss: losses, per-step ms, kernel launches and collectives."""
    from midi_vae_tpu_torch.parallel import collectives

    reset_launch_counts()
    collectives.reset_counts()
    losses, ms = [], []
    for x in xs:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, lo, grad_norm = step(state, x if rows is None else x[rows], 0)
        losses.append(lo.loss.item())
        ms.append((time.perf_counter() - t0) * 1e3)
        check(math.isfinite(losses[-1]) and math.isfinite(grad_norm.item()), f"non-finite step: {losses[-1]}")
    return {"state": state, "losses": losses, "ms": ms, "launches": launch_counts(),
            "collectives": collectives.counts()}


def collective_cost(dev, card: str, n: int = 200) -> None:
    """Host µs per call of one all-reduce of a BatchNorm layer's statistics
    (2 × 256 f32) over the one-rank NCCL group: the bare call, and through
    ``all_reduce_sum`` with its backward (what the auto step issues per
    layer); issue time alone and with the device's finish."""
    import torch.distributed as dist

    from midi_vae_tpu_torch.parallel import collectives

    t = torch.zeros(2 * 256, device=dev)

    def wrapped():
        x = t.clone().requires_grad_(True)
        collectives.all_reduce_sum(x, None).sum().backward()

    for name, fn in (("dist.all_reduce", lambda: dist.all_reduce(t)), ("all_reduce_sum forward + backward", wrapped)):
        for _ in range(10):
            fn()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        issue_us = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize(dev)
        done_us = (time.perf_counter() - t0) / n * 1e6
        log(f"  one-rank NCCL {name} of 512 f32: {issue_us:.1f} µs host per call, {done_us:.1f} µs with the device's "
            f"finish, over {n} calls [{card}]")


def _two_rank_worker(rank: int, store: str, weights_path: str, out_path: str) -> None:
    """One of two ranks on cuda:0 over gloo: the auto step, then the explicit
    step, from the same weights, on this rank's half of each global batch."""
    import torch.distributed as dist

    from midi_vae_tpu_torch.parallel.mesh import make_mesh, replicate
    from midi_vae_tpu_torch.parallel.spmd import make_spmd_train_step

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=2)
    try:
        weights = torch.load(weights_path, map_location=dev)
        xs = flagship_batches(dev, TWO_RANK_STEPS)
        mesh = make_mesh(2)
        rows = torch.from_numpy(mesh.local_rows(BATCH)).to(dev)
        kl = kl_weight_schedule("constant", KL_WEIGHT)
        state = flagship_state(dev, weights)
        replicate(state.model)
        auto = step_window(state, make_train_step(kl, fused_loss=True, mesh=mesh), xs, dev, rows)
        state = flagship_state(dev, weights)
        step = make_spmd_train_step(kl, mesh, fused_loss=True)
        equal, spmd_losses = [], []
        reset_launch_counts()
        for x in xs:
            state, lo, _ = step(state, x[rows], 0)
            spmd_losses.append(lo.loss.item())
            mine = param_vector(state.model)
            theirs = mine.clone()
            dist.broadcast(theirs, src=1)
            equal.append(bool(torch.equal(mine, theirs)))
        spmd_launches = launch_counts()
        launches = [None, None]
        dist.all_gather_object(launches, (auto["launches"], spmd_launches))
        if rank == 0:
            torch.save({"auto_losses": auto["losses"], "auto_ms": auto["ms"], "collectives": auto["collectives"],
                        "params": update_vector(auto["state"].model).cpu(),
                        "spmd_losses": spmd_losses, "spmd_equal": equal, "launches": launches}, out_path)
    finally:
        dist.destroy_process_group()


def parallel_phase(dev, root: Path, card: str, flagship: dict) -> dict:
    """Multi-GPU training on one card: the flagship fused step over a
    one-rank NCCL group on both step implementations against the
    non-distributed step; two ranks sharing the card over gloo against one
    rank at twice the batch; the train CLI with ``--num-devices 1
    --step-impl shard_map`` and its refusal of two devices here. Returns the
    kernel launches of the one-rank windows and the CLI run."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from midi_vae_tpu_torch.cli import train as train_cli
    from midi_vae_tpu_torch.parallel.mesh import ensure_process_group, make_mesh
    from midi_vae_tpu_torch.parallel.spmd import make_spmd_train_step

    t_phase = time.perf_counter()
    kl = kl_weight_schedule("constant", KL_WEIGHT)
    weights = build_model("FoldedVAE", dtype=torch.bfloat16, fused_reparam=True, seed=0, device=dev,
                          **FLAGSHIP).state_dict()
    xs = flagship_batches(dev, PARALLEL_STEPS)
    ref = step_window(flagship_state(dev, weights), make_train_step(kl, fused_loss=True), xs, dev)
    want = {**{k: PARALLEL_STEPS for k in ops.KERNEL_WRAPPERS}, **model_launches(ref["state"].model, PARALLEL_STEPS)}
    check(ref["launches"] == want, f"the non-distributed window launched {ref['launches']}, expected {want}")
    total = {k: 0 for k in ops.KERNEL_WRAPPERS}

    # one rank over NCCL, both step implementations
    store = ensure_process_group(dev)
    check(store is not None, "a process group already existed")
    check(dist.get_backend() == "nccl", f"backend {dist.get_backend()} on CUDA")
    mesh = make_mesh(1)
    for impl, step in (("auto", make_train_step(kl, fused_loss=True, mesh=mesh)),
                       ("shard_map", make_spmd_train_step(kl, mesh, fused_loss=True))):
        w = step_window(flagship_state(dev, weights), step, xs, dev)
        add_counts(total, w["launches"])
        bitwise = w["losses"] == ref["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(w["losses"], ref["losses"]))
        check(bitwise or rel <= 1e-6, f"world-1 {impl} losses differ from the non-distributed step: rel {rel}")
        want = {**{k: PARALLEL_STEPS for k in ops.KERNEL_WRAPPERS}, **model_launches(w["state"].model, PARALLEL_STEPS)}
        check(w["launches"] == want, f"{w['launches']} launched in {PARALLEL_STEPS} world-1 {impl} steps, "
              f"expected {want} (a group of one rank keeps the statistics local: fused)")
        per_step = {k: v / PARALLEL_STEPS for k, v in w["collectives"].items()}
        med = statistics.median(w["ms"])
        log(f"  world-1 NCCL {impl}: {PARALLEL_STEPS} losses {'bitwise equal to' if bitwise else f'within {rel:.2e} rel of'}"
            f" the non-distributed step's; launches {w['launches']}; collectives per step {per_step}; step median "
            f"{med:.3f} ms ({BATCH / med * 1e3:.1f} samples/s) vs the non-distributed window here "
            f"{statistics.median(ref['ms']):.3f} ms and the train phase's {flagship['median_ms']:.3f} ms [{card}]")
        profile_steps(w["state"], step, torch.Generator(device=dev).manual_seed(6), 0, dev, med)
    collective_cost(dev, card)
    dist.destroy_process_group()
    shutil.rmtree(store, ignore_errors=True)

    # two ranks sharing the card over gloo, against one rank at twice their batch
    tmp = Path(tempfile.mkdtemp(prefix="two_rank_", dir=root / "build"))
    torch.save(weights, tmp / "weights.pt")
    t0 = time.perf_counter()
    mp.start_processes(_two_rank_worker, args=(str(tmp / "store"), str(tmp / "weights.pt"), str(tmp / "out.pt")),
                       nprocs=2, start_method="spawn", join=True)
    two = torch.load(tmp / "out.pt", weights_only=False)
    spawn_s = time.perf_counter() - t0
    rel = abs(two["auto_losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    check(rel <= 1e-3, f"two-rank first-step loss {two['auto_losses'][0]} vs one rank {ref['losses'][0]}")
    # parameters after the steps: the two ranks' update against one rank's, relative to its size
    p0 = update_vector(flagship_state(dev, weights).model).cpu()
    one = update_vector(step_window(flagship_state(dev, weights), make_train_step(kl, fused_loss=True),
                                    xs[:TWO_RANK_STEPS], dev)["state"].model).cpu()
    upd_rel = float((two["params"] - one).norm() / (one - p0).norm())
    check(upd_rel <= 0.1, f"two-rank parameters after {TWO_RANK_STEPS} steps: update differs by {upd_rel:.3e} rel")
    model = flagship_state(dev, weights).model
    for r, (auto_l, spmd_l) in enumerate(two["launches"]):
        elbo = {k: TWO_RANK_STEPS for k in ops.KERNEL_WRAPPERS}
        want = ({**elbo, **model_launches(model, TWO_RANK_STEPS, synced=True)},
                {**elbo, **model_launches(model, TWO_RANK_STEPS)})
        check((auto_l, spmd_l) == want, f"rank {r}: launched {auto_l} (auto), {spmd_l} (shard_map) in "
              f"{TWO_RANK_STEPS} steps, expected {want}")
    check(all(math.isfinite(v) for v in two["spmd_losses"]) and all(two["spmd_equal"]),
          f"two-rank shard_map: losses {two['spmd_losses']}, ranks' parameters equal after each step {two['spmd_equal']}")
    med2 = statistics.median(two["auto_ms"])
    log(f"  two ranks on cuda:0 over gloo, batch {BATCH // 2} each: first-step loss {two['auto_losses'][0]:.7f} vs one "
        f"rank at {BATCH} {ref['losses'][0]:.7f} (rel {rel:.2e}, bound 1e-3); K1-K3 once per rank per step, "
        f"the fused BatchNorm {fused_norms(model)} times per rank per shard_map step (none in the auto step); "
        f"parameters after {TWO_RANK_STEPS} steps: update within {upd_rel:.3e} of one rank's (relative norm, "
        f"bound 0.1: bf16 compute; the norm-fed conv biases left out); "
        f"collectives in {TWO_RANK_STEPS} steps {two['collectives']}; step median {med2:.3f} ms "
        f"({BATCH / med2 * 1e3:.1f} samples/s, one shared card: an observation, not scaling); shard_map losses "
        f"{[round(v, 6) for v in two['spmd_losses']]}, ranks' parameters bitwise equal after every step; "
        f"{spawn_s:.1f} s with process start [{card}]")
    shutil.rmtree(tmp, ignore_errors=True)

    # the train CLI through its entry point
    models = root / "build" / "cli_models"
    argv = ["--config", str(root / "configs" / "folded.yaml"), "--fused", "--bce-targets", "normalized",
            "--epochs", "1", "--seed", "0", "--models-dir", str(models), "--run-name", "cli"]
    reset_launch_counts()
    r = train_cli.cli(argv + ["--num-devices", "1", "--step-impl", "shard_map", "--run-id", "shard-map"])
    counts = launch_counts()
    log_cli_run("--num-devices 1 --step-impl shard_map, 1 epoch", r, card)
    want = expected_cli_launches(r, 1)
    check(counts == want, f"shard_map CLI run launched {counts}, expected {want}")
    add_counts(total, counts)
    try:
        train_cli.cli(argv + ["--num-devices", "2", "--run-id", "two"])
    except ValueError as e:
        check("only 1 available" in str(e), f"--num-devices 2 raised {e!r}")
        log(f"  --num-devices 2 on one card raises: {e}")
    else:
        raise RuntimeError("check failed: --num-devices 2 ran on one card")
    log(f"  launches {counts} (expected {want}); the phase took {time.perf_counter() - t_phase:.1f} s")
    return total


# ==================================================================== data

STREAM_ROLLS = 16384  # rows of the streamed RRD corpus, 128×128×1 uint8 each (256 MiB)
SCAN_CHUNK = 16
CACHE_ROLLS = 1024  # the small corpus of the --compilation-cache processes
JAX_FIXTURE = "tests/fixtures/jax_folded_lines28.msgpack"
JAX_ORBAX_FIXTURE = "tests/fixtures/jax_folded_lines28.orbax"  # the same state, saved by the JAX Orbax backend
READER_ROUNDS = 5
MNIST_SERVED = {"train": 1024, "t10k": 256}  # images of each split the loopback server hands out


def write_stream_corpus(path: Path, dev, card: str) -> None:
    """``STREAM_ROLLS`` piano rolls from the on-device generator, as uint8
    (the ``pianoroll-synthetic`` rounding), written as one RRD file."""
    from midi_vae_tpu_torch.data.sources import write_rrd

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(11)
    rolls, labels = [], []
    for _ in range(0, STREAM_ROLLS, 4096):
        r, n = make_pianoroll_batch(gen, min(4096, STREAM_ROLLS), device=dev)
        rolls.append((r * 255).to(torch.uint8).cpu())
        labels.append(n.cpu())
    images = torch.cat(rolls).numpy()
    path.parent.mkdir(parents=True, exist_ok=True)
    write_rrd(images, torch.cat(labels).numpy(), str(path))
    log(f"  wrote {STREAM_ROLLS} rolls {images.shape[1:]} ({path.stat().st_size / 2**20:.1f} MiB, fill "
        f"{float((images > 0).mean()):.4f}) in {time.perf_counter() - t0:.2f} s [{card}]")


class LossRecorder:
    """Wraps the train loop's ``make_train_step`` so every step's loss is kept
    as the step returns it (a device tensor: no host read)."""

    def __init__(self):
        from midi_vae_tpu_torch.train import loop

        self.loop, self.real, self.losses = loop, loop.make_train_step, []

    def __enter__(self):
        def make(*a, **k):
            step = self.real(*a, **k)

            def recorded(state, x, seed, **kw):
                state, lo, gn = step(state, x, seed, **kw)
                self.losses.append(lo.loss.detach())
                return state, lo, gn

            return recorded

        self.loop.make_train_step = make
        return self

    def __exit__(self, *exc):
        self.loop.make_train_step = self.real


def stream_epoch(root: Path, rrd: Path, models: Path, dev, card: str) -> tuple:
    """One epoch of ``configs/folded.yaml`` at full width, fused, on ``rrd:``
    through the native loader (``--data-placement host``); checks the
    loader was ``NativeDeviceLoader`` and K1–K3's launches. Returns (the
    run's results, its launch counts)."""
    from midi_vae_tpu_torch.cli import train as train_cli
    from midi_vae_tpu_torch.data import pipeline

    served = {"batches": 0}
    real_epoch = pipeline.NativeDeviceLoader.epoch

    def counted(self, epoch=1):
        for b in real_epoch(self, epoch):
            served["batches"] += 1
            yield b

    argv = ["--config", str(root / "configs" / "folded.yaml"), "--fused", "--bce-targets", "normalized",
            "--dataset", f"rrd:{rrd}", "--data-placement", "host", "--epochs", "1", "--seed", "0",
            "--models-dir", str(models), "--run-name", "data", "--run-id", "stream"]
    pipeline.NativeDeviceLoader.epoch = counted
    try:
        reset_launch_counts()
        r = train_cli.cli(argv)
        counts = launch_counts()
    finally:
        pipeline.NativeDeviceLoader.epoch = real_epoch
    log_cli_run("rrd: stream, host placement (native loader), fused", r, card)
    want = expected_cli_launches(r, 1)
    evals = r["forwards"]["eval_batches"]
    check(served["batches"] == r["steps_per_epoch"] + evals,
          f"the native loader served {served['batches']} batches, the run took {r['steps_per_epoch']} + {evals}")
    check(counts == want, f"stream run launched {counts}, expected {want}")
    t = r["history"][0]["train"]
    loader_s = t["phase_s"].get("dataloader", 0.0)
    epoch_s = r["steps_per_epoch"] * CLI_BATCH / t["throughput"]
    log(f"  native loader: {served['batches']} batches served; {t['throughput']:.1f} samples/s; waiting on the "
        f"loader {loader_s / r['steps_per_epoch'] * 1e3:.3f} ms/batch, {loader_s / epoch_s:.1%} of the epoch; "
        f"launches {counts} as the forwards predict [{card}]")
    return r, counts


def stream_busy_share(r: dict, rrd: Path, dev, card: str, n_steps: int = 20) -> None:
    """The device's busy share of the streaming loop: ``n_steps`` fused steps
    over the native loader's batches, timed, then profiled."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from midi_vae_tpu_torch.data.pipeline import make_loader
    from midi_vae_tpu_torch.data.sources import open_rrd_stream
    from midi_vae_tpu_torch.data.transforms import get_transform

    spec, _ = get_transform("pianoroll", 128, {})
    loader = make_loader(open_rrd_stream(str(rrd)).with_transform(spec), CLI_BATCH, train=True, seed=1, device=dev,
                         placement="host")
    step = make_train_step(kl_weight_schedule("constant", KL_WEIGHT), fused_loss=True)
    state = r["state"]

    def window():
        nonlocal state
        batches = loader.epoch(5)
        t0 = time.perf_counter()
        for _ in range(n_steps):
            state, lo, _ = step(state, next(batches).x, 0)
        lo.loss.item()
        return (time.perf_counter() - t0) * 1e3 / n_steps

    window()  # warm
    step_ms = window()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        window()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)) / n_steps / 1e3
    log(f"  stream loop: {step_ms:.3f} ms/step ({CLI_BATCH / step_ms * 1e3:.1f} samples/s) over {n_steps} steps; "
        f"device busy {busy:.3f} ms/step = {busy / step_ms:.1%} [{card}]")


def resident_scan_epochs(root: Path, rrd: Path, models: Path, card: str) -> dict:
    """The same corpus device-resident: one epoch at ``--scan-steps 1`` and
    one at ``--scan-steps 16`` from the same seed; their per-step losses
    must be bitwise equal. Returns the launch counts of both runs."""
    from midi_vae_tpu_torch.cli import train as train_cli

    base = ["--config", str(root / "configs" / "folded.yaml"), "--fused", "--bce-targets", "normalized",
            "--dataset", f"rrd:{rrd}", "--data-placement", "device", "--epochs", "1", "--seed", "0",
            "--models-dir", str(models), "--run-name", "data"]
    runs, total = {}, {k: 0 for k in ops.KERNEL_WRAPPERS}
    for n in (1, SCAN_CHUNK):
        reset_launch_counts()
        with LossRecorder() as rec:
            r = train_cli.cli(base + ["--scan-steps", str(n), "--run-id", f"scan{n}"])
        counts = launch_counts()
        want = expected_cli_launches(r, 1)
        check(counts == want, f"--scan-steps {n} run launched {counts}, expected {want}")
        add_counts(total, counts)
        runs[n] = (r, torch.stack(rec.losses).cpu())
        t = r["history"][0]["train"]
        log(f"  device-resident, --scan-steps {n}: {t['throughput']:.1f} samples/s, {t['host_syncs']} host syncs "
            f"in {r['steps_per_epoch']} steps, train loss {t['loss']:.6f} [{card}]")
    (r1, l1), (r16, l16) = runs[1], runs[SCAN_CHUNK]
    check(len(l1) == r1["steps_per_epoch"] and torch.equal(l1, l16),
          f"--scan-steps {SCAN_CHUNK} losses differ from --scan-steps 1 "
          f"(max {float((l1 - l16).abs().max()) if len(l1) == len(l16) else 'length'})")
    check(r1["history"][0]["train"]["loss"] == r16["history"][0]["train"]["loss"], "epoch mean losses differ")
    log(f"  the {len(l1)} per-step losses of the two epochs are bitwise equal; samples/s "
        f"{r16['history'][0]['train']['throughput'] / r1['history'][0]['train']['throughput']:.3f}× with chunks of "
        f"{SCAN_CHUNK} [{card}]")
    return total


def parse_corpus(card: str) -> None:
    """The ``midi-synthetic`` corpus's files (generated by the CLI phase)
    parsed natively and in Python: identical note arrays, ms per file."""
    from midi_vae_tpu_torch.data.fetch import synthetic_midi_dir
    from midi_vae_tpu_torch.midi.parse import parse_midi

    files = sorted(str(p) for p in Path(synthetic_midi_dir("midi-synthetic")).rglob("*.mid"))
    check(len(files) == 512, f"{len(files)} files in the midi-synthetic corpus")
    for f in files:  # the native library loaded and every file in the page cache before either is timed
        parse_midi(f)
    out, ms = {}, {}
    for native in (True, False):
        t0 = time.perf_counter()
        out[native] = [parse_midi(f, prefer_native=native) for f in files]
        ms[native] = (time.perf_counter() - t0) * 1e3 / len(files)
    same = all(all(np.array_equal(getattr(a, k), getattr(b, k)) for k in ("onset", "duration", "pitch", "velocity"))
               for a, b in zip(out[True], out[False]))
    check(same, "native and Python parses differ")
    notes = sum(len(a.pitch) for a in out[True])
    log(f"  {len(files)} files, {notes} notes: native and Python note arrays identical; native {ms[True]:.4f} ms/file, "
        f"Python {ms[False]:.4f} ms/file ({ms[False] / ms[True]:.1f}×) [{card}]")


def compilation_cache_processes(root: Path, card: str) -> None:
    """Two fresh processes of the train CLI with the same new
    ``--compilation-cache DIR`` (a fused FoldedVAE epoch on a small ``rrd:``
    corpus, so every kind of build runs): the first builds the CUDA and
    host libraries and compiles the Triton kernels into DIR, the second
    builds nothing."""
    from midi_vae_tpu_torch.data.sources import write_rrd
    from midi_vae_tpu_torch.data.synthetic import generate_line_images

    work = root / "build" / "cache_check"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    images, labels = generate_line_images(CACHE_ROLLS, img_size=(28, 28), max_lines=2, line_width=2, seed=0)
    write_rrd(images[..., None], labels, str(work / "lines.rrd"))
    cache = work / "cache"
    argv = [sys.executable, "-m", "midi_vae_tpu_torch.cli.train", "--dataset", f"rrd:{work / 'lines.rrd'}",
            "--data-placement", "host", "--transform-type", "noaug", "--image-size", "28", "--model", "FoldedVAE",
            "--fold", "4", "--hidden-dims", "8", "16", "--n_features", "4", "--fused", "--epochs", "1",
            "--batch-size", "128", "--seed", "0", "--models-dir", str(work / "models"), "--compilation-cache", str(cache)]
    env = {k: v for k, v in os.environ.items() if k not in ("TRITON_CACHE_DIR", cuda_lib.BUILD_DIR_ENV)}
    env["PYTHONPATH"] = str(root)
    seconds, built, files = [], [], []
    for _ in range(2):
        t0 = time.perf_counter()
        proc = subprocess.run(argv, capture_output=True, text=True, env=env, cwd=str(root), timeout=600)
        seconds.append(time.perf_counter() - t0)
        check(proc.returncode == 0, f"--compilation-cache run exited {proc.returncode}:\n{proc.stderr[-3000:]}")
        built.append([line for line in proc.stdout.splitlines() if line.startswith("built ")])
        files.append(sorted(str(p.relative_to(cache)) for p in cache.rglob("*") if p.is_file()))
    check(any("CUDA library" in b for b in built[0]) and any("host library rollloader" in b for b in built[0]),
          f"the first process built {built[0]}, expected the CUDA library and the host loader")
    check(any(f.startswith("triton/") for f in files[0]), "no Triton cache entry in DIR")
    check(built[1] == [] and files[1] == files[0], f"the second process built {built[1]} or changed DIR")
    log(f"  first process {seconds[0]:.2f} s ({len(built[0])} builds, {len(files[0])} files in DIR), second "
        f"{seconds[1]:.2f} s (no build, DIR unchanged) [{card}]")


def probe_and_serve(ckpt: Path, root: Path, dev, card: str) -> None:
    """The backend probe in this process, then the server CLI in a process
    of its own (its probe, ``--compilation-cache``) on ``ckpt``: one
    ``/reconstruct`` against the CPU service on the same checkpoint."""
    import socket

    from midi_vae_tpu_torch.core.backend_check import backend_alive
    from midi_vae_tpu_torch.serving.client import ServingClient
    from midi_vae_tpu_torch.serving.server import InferenceService

    t0 = time.perf_counter()
    check(backend_alive(timeout_s=120.0, attempts=1), "the backend probe failed on the card")
    log(f"  backend probe: alive in {time.perf_counter() - t0:.2f} s (1024² matmul in a subprocess) [{card}]")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": str(root)}
    cmd = [sys.executable, "-m", "midi_vae_tpu_torch.serving.server", "--checkpoint", str(ckpt), "--port", str(port),
           "--compilation-cache", str(root / "build" / "serve_cache")]
    t0 = time.perf_counter()
    server_log = root / "build" / "serve_process.log"
    log_file = open(server_log, "w")
    proc = subprocess.Popen(cmd, stdout=log_file, stderr=subprocess.STDOUT, text=True, env=env)
    try:
        client = ServingClient(f"http://127.0.0.1:{port}")
        while True:
            check(proc.poll() is None, f"the server exited {proc.returncode}: {server_log.read_text()[-3000:]}")
            check(time.perf_counter() - t0 < 180, "the server did not answer /healthz in 180 s")
            try:
                health = client.healthz()
                break
            except OSError:
                time.sleep(0.5)
        ready = time.perf_counter() - t0
        x = (np.random.default_rng(0).random((1, 128, 128, 1)) < 0.02).astype(np.float32) - 0.5
        got = client.reconstruct(x)
        cpu = InferenceService(str(ckpt), device="cpu")
        try:
            want = cpu.reconstruct(x)
        finally:
            cpu.close()
        err = float(np.max(np.abs(got - want)))
        check(got.shape == (1, 128, 128, 1) and err <= 1e-4, f"served /reconstruct off the CPU by {err}")
        log(f"  serve --checkpoint (probe, --compilation-cache) answered /healthz after {ready:.2f} s "
            f"(model {health['model']}); /reconstruct within {err:.2e} of the CPU service [{card}]")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log_file.close()


def orbax_resume(root: Path, models: Path, card: str) -> dict:
    """``--checkpoint-backend orbax`` on ``configs/folded.yaml`` (fused,
    ``midi-synthetic``): one epoch, resumed for a second (asynchronous
    writes), against the uninterrupted two-epoch run: the weights, EMA-free
    optimizer moments and final metrics bitwise. Returns the launches."""
    from midi_vae_tpu_torch.cli import train as train_cli
    from midi_vae_tpu_torch.train.state import state_dict

    base = ["--config", str(root / "configs" / "folded.yaml"), "--fused", "--bce-targets", "normalized",
            "--epochs", "2", "--seed", "0", "--checkpoint-backend", "orbax"]
    a, b = models / "orbax_a" / "checkpoint_latest.orbax", models / "orbax_b" / "checkpoint_latest.orbax"
    total = {k: 0 for k in ops.KERNEL_WRAPPERS}
    reset_launch_counts()
    first = train_cli.cli(base + ["--stop-after-epochs", "1", "--checkpoint", str(a)])
    resumed = train_cli.cli(base + ["--async-checkpoint", "--checkpoint", str(a)])
    straight = train_cli.cli(base + ["--async-checkpoint", "--checkpoint", str(b)])
    add_counts(total, launch_counts())
    check(resumed["start_epoch"] == 2 and resumed["total_step"] == straight["total_step"] == 2 * first["total_step"],
          "the orbax resume did not continue at epoch 2")
    sa, sb = state_dict(resumed["state"]), state_dict(straight["state"])
    same = all(torch.equal(sa["model"][k], sb["model"][k]) for k in sa["model"]) and all(
        torch.equal(pa[k], pb[k]) for pa, pb in zip(sa["optimizer"]["state"].values(), sb["optimizer"]["state"].values())
        for k in pa)
    check(same and resumed["final_test"] == straight["final_test"], "the orbax resume differs from the straight run")
    shards = sorted(p.name for p in (a / "state").iterdir())
    log(f"  orbax: resumed at epoch 2 bitwise equal to the uninterrupted run (weights, moments, final test); "
        f"{a.name}/state holds {shards} [{card}]")
    return total


def jax_checkpoint_on_the_card(root: Path, models: Path, dev, card: str, fixture: str = JAX_FIXTURE) -> dict:
    """A JAX package fixture checkpoint (``.msgpack`` or Orbax) on the
    card: ``evaluate`` against the CPU (1e-4), ``generate --mode
    reconstruct`` against the CPU, a ``serve`` service's reconstruction
    against the CPU's, and a fused ``--pretrained`` warm start whose
    launches its forwards predict. Returns the warm start's launches."""
    from midi_vae_tpu_torch.cli import evaluate, generate
    from midi_vae_tpu_torch.cli import train as train_cli
    from midi_vae_tpu_torch.serving.server import InferenceService

    from midi_vae_tpu_torch.models import vae

    kind = Path(fixture).suffix
    fixture = str(root / fixture)
    out = models / f"jax_fixture{kind}"
    out.mkdir(parents=True, exist_ok=True)
    # the evaluate and reconstruct forwards sample z, from a generator whose
    # stream differs between the card and the CPU: both take z = mu here
    draw = vae.VanillaVAE.reparameterize
    vae.VanillaVAE.reparameterize = lambda self, mu, log_var, **kw: mu
    try:
        res = {}
        for where in ("card", "cpu"):
            flags = ["--cpu"] if where == "cpu" else []
            evaluate.cli(["--checkpoint", fixture, "--json", str(out / f"{where}.json"), "--seed", "0"] + flags)
            res[where] = json.loads((out / f"{where}.json").read_text())["test"]
        imgs = {where: generate.cli(["--checkpoint", fixture, "--mode", "reconstruct", "-n", "8", "--out",
                                     str(out / f"{where}.png")] + (["--cpu"] if where == "cpu" else []))
                for where in ("card", "cpu")}
    finally:
        vae.VanillaVAE.reparameterize = draw
    errs = {k: abs(res["card"][k] - v) / max(abs(v), 1e-12) for k, v in res["cpu"].items()}
    check(max(errs.values()) <= 1e-4, f"evaluate of the JAX {kind} checkpoint: card against CPU {errs}")
    gen_err = float(np.max(np.abs(imgs["card"] - imgs["cpu"])))
    check(gen_err <= 1e-4, f"generate --mode reconstruct of the JAX {kind} checkpoint: card against CPU {gen_err}")
    x = (np.random.default_rng(1).random((4, 28, 28, 1)) < 0.1).astype(np.float32) - 0.5
    services = [InferenceService(fixture), InferenceService(fixture, device="cpu")]
    try:
        srv_err = float(np.max(np.abs(services[0].reconstruct(x) - services[1].reconstruct(x))))
    finally:
        for s in services:
            s.close()
    check(srv_err <= 1e-4, f"the served JAX {kind} checkpoint: card against CPU {srv_err}")
    reset_launch_counts()
    r = train_cli.cli(["--dataset", "vae-lines-synthetic", "--transform-type", "noaug", "--image-size", "28",
                       "--model", "FoldedVAE", "--fold", "4", "--hidden-dims", "8", "16", "--n_features", "4",
                       "--fused", "--epochs", "1", "--batch-size", "128", "--seed", "0", "--pretrained", fixture,
                       "--ema-decay", "0.9", "--models-dir", str(models), "--run-name", f"pretrained-{kind[1:]}"])
    counts = launch_counts()
    check(counts == expected_cli_launches(r, 1) and r["total_step"] == r["steps_per_epoch"],
          f"--pretrained x{kind} run: launches {counts}, total_step {r['total_step']}")
    log(f"  JAX {kind} on the card (z = mu): evaluate within {max(errs.values()):.2e} (relative) of the CPU, generate "
        f"reconstruct within {gen_err:.2e}, served reconstruction within {srv_err:.2e}; --pretrained run "
        f"{r['history'][0]['train']['throughput']:.1f} samples/s, test cross-entropy "
        f"{r['final_test']['cross-entropy']:.6f}; launches {counts} [{card}]")
    return counts


def _same_leaves(got, want, path: str = "state") -> int:
    """Check two checkpoint trees leaf for leaf, bitwise; returns the leaves."""
    if isinstance(want, dict):
        check(isinstance(got, dict) and set(got) == set(want), f"{path}: keys differ")
        return sum(_same_leaves(got[k], want[k], f"{path}/{k}") for k in want)
    if isinstance(want, np.ndarray):
        check(isinstance(got, np.ndarray) and got.dtype == want.dtype and got.shape == want.shape
              and got.tobytes() == want.tobytes(), f"{path} differs")
        return 1
    check(type(got) is type(want) and got == want, f"{path} differs")
    return 1


def orbax_reader(root: Path, card: str) -> None:
    """The JAX Orbax fixture read without JAX (the port's zstd, OCDBT and
    zarr readers): every leaf bitwise the ``.msgpack`` fixture's, then the
    load's time (median of ``READER_ROUNDS``) and the zstd decoder's rate
    over the fixture's chunks on this machine's host CPU."""
    from midi_vae_tpu_torch.io.checkpoint import load_checkpoint
    from midi_vae_tpu_torch.io.ocdbt import OcdbtStore
    from midi_vae_tpu_torch.native import zstd

    orbax = str(root / JAX_ORBAX_FIXTURE)
    got, want = load_checkpoint(orbax), load_checkpoint(str(root / JAX_FIXTURE))
    check(got["state_format"] == want["state_format"] == "flax", "the Orbax fixture is not read as a flax state")
    n_leaves = _same_leaves(got["state"], want["state"])
    check({k: v for k, v in got.items() if k != "state"} == {k: v for k, v in want.items() if k != "state"},
          "the Orbax fixture's metadata differs from the .msgpack fixture's")
    load_s = statistics.median(timed(lambda: load_checkpoint(orbax), READER_ROUNDS))
    store = OcdbtStore(str(root / JAX_ORBAX_FIXTURE / "state"))
    frames = [store.read(k) for k in store.list() if not k.endswith("/.zarray")]
    decoded = sum(len(zstd.decompress(f)) for f in frames)
    decode_s = statistics.median(timed(lambda: [zstd.decompress(f) for f in frames], READER_ROUNDS))
    log(f"  JAX Orbax fixture: {n_leaves} leaves bitwise equal to the .msgpack fixture's; load "
        f"{load_s * 1e3:.3f} ms (median of {READER_ROUNDS}); zstd {len(frames)} chunks, "
        f"{sum(map(len, frames))} -> {decoded} bytes in {decode_s * 1e3:.3f} ms = {decoded / decode_s / 1e6:.1f} MB/s "
        f"(host CPU) [{card}]")


def _idx_gz(array: np.ndarray) -> bytes:
    import gzip
    import struct

    header = struct.pack(">I", 0x0800 | array.ndim) + struct.pack(">" + "I" * array.ndim, *array.shape)
    return gzip.compress(header + array.astype(np.uint8).tobytes(), mtime=0)


def mnist_download(root: Path, card: str) -> None:
    """``fetch_dataset("mnist", download=True)`` from a loopback HTTP server
    (127.0.0.1) handing out MNIST-format files written here: the files land
    byte-equal to what was served and the datasets load with its values."""
    import functools
    import http.server

    from midi_vae_tpu_torch.data import fetch, sources

    served, data_dir = root / "build" / "served", root / "build" / "downloaded"
    for d in (served, data_dir):
        shutil.rmtree(d, ignore_errors=True)
    (served / "mnist").mkdir(parents=True)
    rng = np.random.default_rng(0)
    arrays = {}
    for prefix, n in MNIST_SERVED.items():
        arrays[prefix] = rng.integers(0, 256, (n, 28, 28), dtype=np.uint8), rng.integers(0, 10, n, dtype=np.uint8)
        (served / "mnist" / f"{prefix}-images-idx3-ubyte.gz").write_bytes(_idx_gz(arrays[prefix][0]))
        (served / "mnist" / f"{prefix}-labels-idx1-ubyte.gz").write_bytes(_idx_gz(arrays[prefix][1]))

    class Quiet(http.server.SimpleHTTPRequestHandler):
        def log_message(self, *args):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), functools.partial(Quiet, directory=str(served)))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    urls = sources._MNIST_URLS
    sources._MNIST_URLS = [f"http://127.0.0.1:{httpd.server_address[1]}/mnist/"]
    try:
        t0 = time.perf_counter()
        train, _, test, _ = fetch.fetch_dataset("mnist", root=str(data_dir), download=True)
        seconds = time.perf_counter() - t0
    finally:
        sources._MNIST_URLS = urls
        httpd.shutdown()
        httpd.server_close()
        thread.join()
    for name in sources._MNIST_FILES:
        check((data_dir / "MNIST" / "raw" / name).read_bytes() == (served / "mnist" / name).read_bytes(),
              f"downloaded {name} differs from the served file")
    for ds, prefix in ((train, "train"), (test, "t10k")):
        images, labels = arrays[prefix]
        check(np.array_equal(ds.images, images[..., None]) and np.array_equal(ds.labels, labels.astype(np.int64)),
              f"the downloaded MNIST {prefix} split differs from the served arrays")
    log(f"  --allow-download-dataset: MNIST ({len(train)} train, {len(test)} test) from a loopback server, "
        f"files byte-equal, datasets equal, in {seconds:.3f} s [{card}]")


def data_phase(dev, root: Path, card: str) -> dict:
    """The data and utility modules: the host libraries' build, an ``rrd:``
    epoch of the flagship config through the native loader, the same
    corpus device-resident with and without ``--scan-steps``, the native
    parser against Python, ``--compilation-cache`` across two processes,
    the backend probe and the server, sharded checkpoints, the JAX
    ``.msgpack`` and Orbax checkpoints, the dataset download and the
    ``data.stats`` CLI. Returns the launches of the stream run and of the
    ``--pretrained`` run from the Orbax fixture."""
    from midi_vae_tpu_torch.data import stats
    from midi_vae_tpu_torch.native import _build

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    built = _build.build()
    check(set(built) == {"rollloader", "midiparse", "zstd", "png"}, f"host libraries {sorted(built)}")
    log(f"  host C++ libraries in {time.perf_counter() - t0:.2f} s: " + ", ".join(
        f"{n} {'found built' if b.seconds is None else f'g++ {b.seconds:.2f} s'}" for n, b in built.items()))
    models = root / "build" / "data_models"
    shutil.rmtree(models, ignore_errors=True)
    rrd = root / "build" / "data" / "rolls.rrd"
    write_stream_corpus(rrd, dev, card)
    stats.cli(["--dataset", f"rrd:{rrd}", "--max-samples", "1024"])

    r, stream_counts = stream_epoch(root, rrd, models, dev, card)
    stream_busy_share(r, rrd, dev, card)
    total = dict(stream_counts)
    add_counts(total, resident_scan_epochs(root, rrd, models, card))
    parse_corpus(card)
    compilation_cache_processes(root, card)
    probe_and_serve(Path(r["config"]["checkpoint_path"]), root, dev, card)
    add_counts(total, orbax_resume(root, models, card))
    add_counts(total, jax_checkpoint_on_the_card(root, models, dev, card))
    t0 = time.perf_counter()
    orbax_reader(root, card)
    orbax_counts = jax_checkpoint_on_the_card(root, models, dev, card, fixture=JAX_ORBAX_FIXTURE)
    add_counts(total, orbax_counts)
    mnist_download(root, card)
    log(f"  JAX Orbax checkpoint and download checks {time.perf_counter() - t0:.1f} s [{card}]")
    log(f"  data phase {time.perf_counter() - t_phase:.1f} s; launches over the phase {total} [{card}]")
    data_counts = dict(stream_counts)
    add_counts(data_counts, orbax_counts)
    return data_counts


# ============================================================== public API

PNG_ROLLS = 1024  # 128×128 uint8 rolls written as the sageev-smoke PNG folder
PNG_DATASET = "sageev-smoke"
REGISTERED_ARCH = "SmokeRollVAE"
TWIN_TIMEOUT_S = 600


class SmokeRollVAE(VanillaVAE):
    """A VanillaVAE registered under a name of its own, as a user adds an
    architecture (``models/registry.py`` ``register_model``)."""


def wheel_files(root: Path) -> list:
    """(source, path in the wheel) of every file a wheel of this checkout
    ships: the ``.py`` files of each package ``pyproject.toml``'s
    ``packages.find`` includes, and its ``package-data`` globs."""
    import fnmatch
    import tomllib

    setup = tomllib.loads((root / "pyproject.toml").read_text())["tool"]["setuptools"]
    include = setup["packages"]["find"]["include"]
    packages = []
    for top in sorted(root.iterdir()):
        if (top / "__init__.py").is_file() and any(fnmatch.fnmatchcase(top.name, pat) for pat in include):
            packages += [d for d in [top, *sorted(top.rglob("*"))] if (d / "__init__.py").is_file()]
    files = []
    for pkg in packages:
        name = ".".join(pkg.relative_to(root).parts)
        files += [(f, f.relative_to(root)) for f in sorted(pkg.glob("*.py"))]
        for pattern in setup["package-data"].get(name, []):
            files += [(f, f.relative_to(root)) for f in sorted(pkg.glob(pattern)) if f.is_file()]
    return files


INSTALLED_CHECK = r"""
import json, sys, time
from pathlib import Path
tree, fixture, work = sys.argv[1:4]
sys.path.insert(0, tree)
import numpy as np
import torch
import midi_vae_tpu_torch
from midi_vae_tpu_torch.io.logging import write_png
from midi_vae_tpu_torch.io.orbax_read import load_jax_orbax
from midi_vae_tpu_torch.midi.factory import generate_midi_dataset
from midi_vae_tpu_torch.midi.parse import parse_midi
from midi_vae_tpu_torch.native import _build
from midi_vae_tpu_torch.native.png import read_png
from midi_vae_tpu_torch.ops import cuda_lib
from midi_vae_tpu_torch.ops import fused_elbo as ops
out = {"package": midi_vae_tpu_torch.__file__}
t0 = time.perf_counter()
out["host_built"] = {n: b.seconds for n, b in _build.build(["zstd", "midiparse", "rollloader", "png"]).items()}
out["host_build_s"] = time.perf_counter() - t0
payload = load_jax_orbax(fixture)
out["orbax_total_step"] = payload["total_step"]
generate_midi_dataset(1, work + "/mid", seed=0)
notes = [parse_midi(str(f)) for f in sorted(Path(work, "mid").rglob("*.mid"))]
python = [parse_midi(str(f), prefer_native=False) for f in sorted(Path(work, "mid").rglob("*.mid"))]
out["mid_notes"] = [len(n.pitch) for n in notes]
out["mid_same"] = all(np.array_equal(getattr(a, k), getattr(b, k)) for a, b in zip(notes, python)
                      for k in ("onset", "duration", "pitch", "velocity"))
img = np.random.default_rng(0).integers(0, 256, (128, 128), dtype=np.uint8)
write_png(work + "/one.png", img)
out["png_same"] = bool(np.array_equal(read_png(work + "/one.png"), img))
t0 = time.perf_counter()
out["cuda_built"] = {n: (b.seconds, str(b.path)) for n, b in cuda_lib.build().items()}
out["cuda_build_s"] = time.perf_counter() - t0
gen = torch.Generator(device="cuda").manual_seed(3)
mu = torch.randn((100, 10), generator=gen, device="cuda")
lv = 0.3 * torch.randn((100, 10), generator=gen, device="cuda")
ops.reset_launch_counts()
z, kl = ops.reparam_kl(mu, lv, 21)
out["k3_launches"] = ops.launch_counts()["K3"]
z_plain, kl_plain = ops.reparam_kl_plain(mu, lv, ops.k3_eps_plain(mu.shape, 21, mu.device))
top = torch.maximum(z.abs(), z_plain.abs())
ulp = torch.nextafter(top, torch.full_like(top, float("inf"))) - top
out["k3_z_beyond_ulp"] = int(((z - z_plain).abs() > ulp).sum())
out["k3_kl_rel_err"] = abs(float(kl) - float(kl_plain)) / abs(float(kl_plain))
print("INSTALLED " + json.dumps(out))
"""


def installed_package_check(root: Path, card: str) -> None:
    """(i) What a wheel of this checkout ships, copied into a fresh
    directory: in a process whose working directory is elsewhere, with only
    that directory of this repository on its path and fresh build
    directories, it builds the host C++ libraries with g++ and K3 with
    nvcc from the copied sources, reads the JAX Orbax fixture (zstd),
    parses a ``.mid`` file, decodes a PNG and holds one K3 launch against
    its plain version."""
    (root / "build").mkdir(exist_ok=True)
    base = Path(tempfile.mkdtemp(prefix="installed_", dir=root / "build"))
    tree, work, kernels = base / "site", base / "work", base / "kernels"
    work.mkdir()
    files = wheel_files(root)
    for src, rel in files:
        (tree / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(src, tree / rel)
    shipped = sorted(str(rel) for _, rel in files if rel.suffix in (".cc", ".cu"))
    log(f"  wheel contents: {len(files)} files; sources shipped: {', '.join(shipped)}")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env[cuda_lib.BUILD_DIR_ENV] = str(kernels)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", INSTALLED_CHECK, str(tree), str(root / JAX_ORBAX_FIXTURE),
                           str(work)], cwd=work, env=env, capture_output=True, text=True, timeout=900)
    check(proc.returncode == 0, f"the installed copy failed (exit {proc.returncode}):\n{proc.stdout[-3000:]}\n"
                                f"{proc.stderr[-5000:]}")
    out = json.loads(next(line for line in proc.stdout.splitlines() if line.startswith("INSTALLED "))[10:])
    check(out["package"].startswith(str(tree)), f"imported {out['package']}, not the installed copy")
    check(all(v is not None for v in out["host_built"].values()), f"host libraries not built anew: {out['host_built']}")
    check(all(s is not None and str(kernels) in p for s, p in out["cuda_built"].values()),
          f"CUDA libraries not built anew into {kernels}: {out['cuda_built']}")
    check(out["orbax_total_step"] > 0 and out["mid_same"] and out["png_same"],
          f"installed copy: orbax {out['orbax_total_step']}, .mid {out['mid_same']}, PNG {out['png_same']}")
    check(out["k3_launches"] == 1 and out["k3_z_beyond_ulp"] == 0 and out["k3_kl_rel_err"] <= 1e-5,
          f"installed K3 vs plain: {out}")
    log(f"  installed copy ({time.perf_counter() - t0:.1f} s, its own process): host libraries "
        f"{ {n: round(s, 2) for n, s in out['host_built'].items()} } s with g++ ({out['host_build_s']:.2f} s), "
        f"CUDA {[n for n in out['cuda_built']]} with nvcc ({out['cuda_build_s']:.2f} s); JAX Orbax fixture read "
        f"(total_step {out['orbax_total_step']}); .mid parsed natively = Python ({out['mid_notes']} notes); "
        f"PNG decoded bitwise; K3 [100,10] f32 once: z within 1 ulp of plain, KL rel err {out['k3_kl_rel_err']:.2e} "
        f"[{card}]")
    shutil.rmtree(base)


def registered_png_run(dev, root: Path, card: str) -> tuple:
    """(ii) 1,024 rolls from the on-device generator written as the
    ``sageev-smoke`` PNG folder by ``write_image_folder`` and read back by
    ``load_image_folder`` (the port's PNG writer and decoder, Pillow
    blocked), then one fused epoch of a registered architecture on that
    folder through the train CLI. Returns its launches and the kernels'
    errors at its shapes."""
    from midi_vae_tpu_torch.data.sources import load_image_folder, write_image_folder
    from midi_vae_tpu_torch.models.registry import MODEL_REGISTRY, register_model

    pil = sys.modules.get("PIL")
    sys.modules["PIL"] = None  # the card's machine has no Pillow; make sure nothing here uses one
    try:
        rolls, counts = make_pianoroll_batch(torch.Generator(device=dev).manual_seed(31), PNG_ROLLS, device=dev)
        images = (rolls.cpu().numpy() * 255).astype(np.uint8)
        labels = counts.cpu().numpy() % 4
        data_root = root / "build" / "png_data"
        folder = data_root / PNG_DATASET
        shutil.rmtree(data_root, ignore_errors=True)
        t0 = time.perf_counter()
        write_image_folder(images, labels, str(folder))
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ds = load_image_folder(str(folder))
        decode_s = time.perf_counter() - t0
        order = [int(f[len("image_"):-len(".png")]) - 1 for c in sorted(os.listdir(folder)) if (folder / c).is_dir()
                 for f in sorted(os.listdir(folder / c))]
        check(ds.images.shape == (PNG_ROLLS, 128, 128, 1) and np.array_equal(ds.images, images[order])
              and np.array_equal(ds.labels, np.unique(labels, return_inverse=True)[1][order]),
              "the PNG folder did not read back as the rolls written")
        png_bytes = sum(f.stat().st_size for f in folder.rglob("*.png"))
        log(f"  {PNG_ROLLS} rolls 128×128 written as {PNG_DATASET} ({len(ds.class_names)} class folders, {png_bytes} "
            f"bytes of PNG) in {write_s:.3f} s; loaded with no cache (decode, stack, _cache.npz written) in "
            f"{decode_s:.3f} s ({decode_s / PNG_ROLLS * 1e3:.4f} ms per image), bitwise the rolls [{card}]")
        (folder / "_cache.npz").unlink()  # the CLI run decodes the folder again

        register_model(REGISTERED_ARCH, SmokeRollVAE)
        try:
            r, run_counts = fused_run(
                ["--dataset", PNG_DATASET, "--data-dir", str(data_root), "--model", REGISTERED_ARCH,
                 "--transform-type", "pianoroll", "--image-size", "128", "--fused", "--bce-targets", "normalized",
                 "--batch-size", str(CLI_BATCH), "--epochs", "1", "--seed", "0",
                 "--models-dir", str(root / "build" / "public_models"), "--run-name", "public",
                 "--run-id", "registered"],
                1, f"{REGISTERED_ARCH} (registered) on {PNG_DATASET}, fused, 1 epoch", card)
        finally:
            MODEL_REGISTRY.pop(REGISTERED_ARCH.lower())
        check(type(r["state"].model) is SmokeRollVAE, f"--model built {type(r['state'].model).__name__}")
        check(math.isfinite(r["history"][0]["train"]["loss"]), "registered run: non-finite loss")
        throughput = r["history"][0]["train"]["throughput"]
        log(f"  --model {REGISTERED_ARCH} built {type(r['state'].model).__name__}; corpus fetched (PNG decode, no "
            f"cache) in {r['timings']['fetch_s']:.3f} s; epoch {throughput:.1f} samples/s [{card}]")
        errs = kernels_at_run_shapes(dev, {"registered": run_shape(r, CLI_BATCH)})
    finally:
        if pil is None:
            del sys.modules["PIL"]
        else:
            sys.modules["PIL"] = pil
    return run_counts, errs


def rasterize_on_the_card(dev, card: str) -> None:
    """(iii) ``rasterize_batch`` and ``augment_pianoroll`` on the card, each
    bitwise the same call on the CPU with the same notes and draws."""
    from midi_vae_tpu_torch.midi.rasterize import augment_pianoroll, rasterize_batch

    rng = np.random.default_rng(7)
    b, n = 64, 48
    notes = (rng.uniform(-8, 140, (b, n)).astype(np.float32), rng.uniform(0.2, 24, (b, n)).astype(np.float32),
             rng.integers(0, 128, (b, n)).astype(np.int32), rng.uniform(0, 1, (b, n)).astype(np.float32),
             rng.uniform(size=(b, n)) > 0.25)
    notes[4][:4] = False  # empty rows
    cpu = rasterize_batch(*map(torch.from_numpy, notes))
    card_out = rasterize_batch(*(torch.from_numpy(a).to(dev) for a in notes))
    check(cpu.shape == (b, 128, 128, 1) and torch.equal(card_out.cpu(), cpu), "rasterize_batch: card != CPU")
    draws = [(-6, 16, 0.7), (3, -9, 1.1999), (0, 0, 1.0), (5, 2, 0.93)]
    for i, (dp, dt, s) in enumerate(draws):
        want = augment_pianoroll(cpu[i], pitch_shift=dp, time_shift=dt, scale=s)
        got = augment_pianoroll(card_out[i], pitch_shift=dp, time_shift=dt, scale=s)
        check(torch.equal(got.cpu(), want), f"augment_pianoroll {(dp, dt, s)}: card != CPU")
    log(f"  rasterize_batch [{b}, {n}] notes → {list(cpu.shape)} ({int((cpu > 0).sum())} cells lit) and "
        f"augment_pianoroll at {len(draws)} given draws: the card bitwise the CPU [{card}]")


def example_twins(root: Path, card: str) -> None:
    """(iv) ``examples/torch_end_to_end.py`` at its defaults (64 files, 2
    epochs) and ``examples/torch_migrate_from_reference.py`` on the card, each
    in a process of its own; both must exit 0 (the migration twin checks its
    forward parity within 1e-4, TF32 off, and that the loss falls)."""
    workdir = root / "build" / "e2e_torch"
    shutil.rmtree(workdir, ignore_errors=True)
    runs = {
        "torch_end_to_end.py": ["--workdir", str(workdir)],
        "torch_migrate_from_reference.py": [],
    }
    for name, args in runs.items():
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(root / "examples" / name), *args], cwd=root, capture_output=True,
                              text=True, timeout=TWIN_TIMEOUT_S)
        check(proc.returncode == 0, f"examples/{name} exited {proc.returncode}:\n{proc.stdout[-3000:]}\n"
                                    f"{proc.stderr[-3000:]}")
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith(("[", "forward parity", "continued", "migration"))]
        log(f"  examples/{name} on the card: exit 0 in {time.perf_counter() - t0:.1f} s [{card}]")
        for ln in lines:
            log(f"    {ln[:300]}")


def public_api_phase(dev, root: Path, card: str) -> tuple:
    """The port's public surface: (i) the installed tree, (ii) a registered
    architecture trained on a PNG folder through the fused kernels, (iii)
    rasterize and augment on the card, (iv) the example twins; (v) the
    phase's seconds. Returns the launches and kernel errors of (ii)."""
    t_phase = time.perf_counter()
    installed_package_check(root, card)
    counts, errs = registered_png_run(dev, root, card)
    rasterize_on_the_card(dev, card)
    example_twins(root, card)
    log(f"  public API phase {time.perf_counter() - t_phase:.1f} s [{card}]")
    return counts, errs


# ================================================================== config

YAML_FORMS = "tests/fixtures/yaml_forms"  # YAML documents beside the .json of what PyYAML's safe_load returned
FOLDED_BLOCK = "tests/fixtures/folded_block.yaml"  # configs/folded.yaml in block style, an anchor and a merge key


def same_value(a, b) -> bool:
    """Equal values of the same types: dict keys in the same order, NaN equal
    to NaN."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(same_value(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same_value(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def yaml_forms_check(root: Path, card: str) -> int:
    """Every YAML form fixture read by the port's reader, equal to the
    ``.json`` of what PyYAML's ``safe_load`` returned for it. Returns the
    number of fixtures."""
    from midi_vae_tpu_torch.train.config import read_yaml

    forms = sorted((root / YAML_FORMS).glob("*.yaml"))
    check(len(forms) >= 10, f"{len(forms)} YAML form fixtures under {YAML_FORMS}")
    t0 = time.perf_counter()
    for path in forms:
        with open(path.with_suffix(".json"), encoding="utf-8") as f:
            want = json.load(f)
        got = read_yaml(str(path))
        check(same_value(got, want), f"{path.name} read as {got!r}, PyYAML's safe_load as {want!r}")
    log(f"  {len(forms)} YAML form fixtures read by the port's reader, each equal to its .json "
        f"({(time.perf_counter() - t0) * 1e3:.1f} ms for all) [{card}]")
    return len(forms)


def first_step_loss(run_dir: Path) -> float:
    """The loss of a run's first step, from its ``metrics.jsonl``."""
    with open(run_dir / "metrics.jsonl", encoding="utf-8") as f:
        row = json.loads(f.readline())
    check(row["step"] == 1, f"{run_dir}: the first logged step is {row['step']}")
    return row["training/stepwise/train/loss"]


def config_phase(dev, root: Path, card: str) -> tuple:
    """The port's YAML reader with PyYAML blocked (the card's machine has
    none): the YAML form fixtures equal to their ``.json``; the block-style
    ``configs/folded.yaml`` resolved to the flow-style file's
    ``TrainConfig``; both trained through the train CLI, fused, one epoch,
    the same seed, their first-step losses within 1e-6 relative; K1–K3
    against their plain versions at the runs' shapes; the phase's seconds.
    Returns the launches of both runs and the kernels' errors."""
    from midi_vae_tpu_torch.train.config import from_yaml

    t_phase = time.perf_counter()
    has_pyyaml = importlib.util.find_spec("yaml") is not None
    pyyaml = sys.modules.get("yaml")
    sys.modules["yaml"] = None  # make sure nothing here reads YAML with PyYAML
    try:
        n_forms = yaml_forms_check(root, card)
        block, flow = root / FOLDED_BLOCK, root / "configs" / "folded.yaml"
        want, got = from_yaml(str(flow)).to_dict(), from_yaml(str(block)).to_dict()
        differ = {k: (got[k], v) for k, v in want.items() if got[k] != v}
        check(got == want, f"{FOLDED_BLOCK} resolves otherwise: {differ}")
        log(f"  {FOLDED_BLOCK} (block sequences, an anchor, a merge key) resolves to configs/folded.yaml's "
            f"TrainConfig, all {len(want)} keys equal; PyYAML installed here: {has_pyyaml} (blocked for the phase)")
        tmp = root / "build" / "tmp"  # the midi-synthetic corpus cli_phase generated
        tmp.mkdir(parents=True, exist_ok=True)
        tempfile.tempdir = str(tmp)
        models = root / "build" / "config_models"
        shutil.rmtree(models, ignore_errors=True)
        losses, counts = {}, {}
        for label, path in (("block", block), ("flow", flow)):
            r, counts[label] = fused_run(
                ["--config", str(path), "--fused", "--bce-targets", "normalized", "--epochs", "1", "--seed", "0",
                 "--models-dir", str(models), "--run-name", "config", "--run-id", label],
                1, f"{path.relative_to(root)}, fused, 1 epoch", card)
            check(r["config"]["batch_size_per_device"] == CLI_BATCH, f"{label}: batch {r['config']['batch_size_per_device']}")
            losses[label] = first_step_loss(models / "midi-synthetic" / f"config__{label}")
        rel = abs(losses["block"] - losses["flow"]) / abs(losses["flow"])
        log(f"  first-step loss: block style {losses['block']!r}, flow style {losses['flow']!r}, relative difference "
            f"{rel:.3e} [{card}]")
        check(math.isfinite(losses["flow"]) and rel <= 1e-6, f"first-step losses differ by {rel:.3e} relative")
        errs = kernels_at_run_shapes(dev, {"config": run_shape(r, CLI_BATCH)})
    finally:
        if pyyaml is None:
            del sys.modules["yaml"]
        else:
            sys.modules["yaml"] = pyyaml
    total = {}
    for c in counts.values():
        add_counts(total, c)
    log(f"  config phase {time.perf_counter() - t_phase:.1f} s: {n_forms} YAML form fixtures, launches block "
        f"{counts['block']} + flow {counts['flow']} [{card}]")
    return total, errs


# ============================================================== trajectory

TRAJECTORY_FIXTURE = "tests/fixtures/trajectory_folded_fold8"  # .npz and .json: the JAX run to replay
TRAJECTORY_REPLAY = "tests/fixtures/trajectory_replay.py"  # the seeded init, the replay, the row comparison
# the card's run against the JAX run recorded on the CPU, by dtype (PERF.md §6 gives their reasons):
# stepwise values (rtol, atol), eval rows and final sweeps (rtol, atol), leaves' sums and L2 norms (rtol)
TRAJECTORY_TOL = {
    "float32": dict(step_rtol=1e-4, step_atol=1e-6, key_rtol={"loss_kld": 2e-2, "grad_norm": 5e-3},
                    eval_rtol=5e-3, eval_atol=1e-5, leaf_rtol=5e-2),
    "bfloat16": dict(step_rtol=1e-2, step_atol=1e-4, key_rtol={"loss_kld": 1e-1, "grad_norm": 5e-2},
                     eval_rtol=5e-2, eval_atol=1e-4, leaf_rtol=2e-1),
}


# the card's f32 step against the same step recomputed in f64 on the card (loss, reconstruction, KL loss,
# grad norm; PERF.md §6)
F64_RTOL = 1e-4


def load_trajectory_replay(root: Path):
    """``tests/fixtures/trajectory_replay.py`` (numpy, torch and the port only)."""
    spec = importlib.util.spec_from_file_location("trajectory_replay", root / TRAJECTORY_REPLAY)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # its dataclasses resolve their annotations there
    spec.loader.exec_module(module)
    return module


def trajectory_init(tr, meta: dict, path: Path) -> None:
    """The fixture's seeded init rebuilt from the port's model (its checksum
    checked) and saved at ``path`` as a checkpoint of the port."""
    from midi_vae_tpu_torch.interop.from_jax import load_flax_variables
    from midi_vae_tpu_torch.io.checkpoint import save_checkpoint

    model = build_model("FoldedVAE", device="cpu", **FLAGSHIP)
    leaves = tr.init_leaves(tr.port_shapes(model), meta["init_seed"])
    # the f64 sums may round apart in the last bits across machines; a changed stream moves them by far more
    check(abs(tr.checksum(leaves) - meta["init_checksum"]) <= 1e-9 * meta["init_checksum"],
          f"init checksum {tr.checksum(leaves)!r}, the fixture's {meta['init_checksum']!r}: numpy's stream changed")
    trees = tr.nest(leaves)
    load_flax_variables(model, trees["params"], trees["batch_stats"])
    save_checkpoint(str(path), {"model": model.state_dict()}, epoch=0)


def leaf_errors(tr, model, want: dict, rtol: float, cancelled: float) -> tuple:
    """Each final leaf's sum and L2 norm against the fixture's; the
    BN-cancelled conv biases and the running means after them within
    ``cancelled`` per element. Returns (mismatches, largest relative error
    of the other leaves)."""
    got = tr.leaf_stats(model)
    numel = {"/".join((c,) + p): model.state_dict()[n].numel() for n, (c, p) in tr.flax_name_map(model).items()}
    check(sorted(got) == sorted(want), f"leaves differ: {sorted(set(got) ^ set(want))}")
    errors, worst = [], 0.0
    for path, (w_sum, w_l2) in want.items():
        g_sum, g_l2 = got[path]
        keys = path.split("/")
        if "Block_" in path and (keys[-1] == "mean" or (keys[-1] == "bias" and keys[-2].startswith("Conv"))):
            if abs(g_sum - w_sum) > cancelled * numel[path] or abs(g_l2 - w_l2) > cancelled * math.sqrt(numel[path]):
                errors.append(f"{path}: sum {g_sum!r} l2 {g_l2!r}, fixture {w_sum!r} {w_l2!r} (cancelled, {cancelled:.3g})")
            continue
        rel = max(abs(g_sum - w_sum) / max(abs(w_sum), w_l2), abs(g_l2 - w_l2) / w_l2)
        worst = max(worst, rel)
        if rel > rtol:
            errors.append(f"{path}: sum {g_sum!r} l2 {g_l2!r}, fixture {w_sum!r} {w_l2!r}")
    return errors, worst


def trajectory_run(tr, meta: dict, arrays: dict, dtype: str, init: Path, models: Path, dev, card: str) -> dict:
    """One dtype of the fixture replayed through the train CLI on the card;
    returns its launch counts."""
    from midi_vae_tpu_torch.cli import train as train_cli
    from midi_vae_tpu_torch.data import fetch
    from midi_vae_tpu_torch.midi import rasterize
    from midi_vae_tpu_torch.train import loop

    from midi_vae_tpu_torch.train.state import make_loss

    want, tol = meta["runs"][dtype], TRAJECTORY_TOL[dtype]
    draws = tr.Draws(train=[[e] for e in arrays[f"{dtype}_train_eps"]], eval=[list(arrays[f"{dtype}_eval_eps"])])
    replay_train_step, make_eval_step = tr.port_replayers(draws, loop.make_train_step, loop.make_eval_step, device=dev)
    aug = tr.port_aug_replayer(rasterize.augment_pianoroll_batch,
                               lambda k, b: (arrays["aug_dp"][k], arrays["aug_dt"][k], arrays["aug_scale"][k]))
    f64 = []  # the f32 run's steps recomputed in f64 on the card: the yardstick the CPU reference cannot be

    def make_train_step(kl_schedule, **kw):
        step = replay_train_step(kl_schedule, **kw)
        plain_elbo = make_loss()  # the plain ELBO: K1 and K2 do not take f64, and the function is the same

        def checked(state, x, epoch_seed, **rest):
            if dtype == "float32":
                eps = torch.from_numpy(draws.train[len(f64)][0]).to(dev)
                f64.append(tr.f64_step_terms(state.model, x, eps, kl_schedule(state.step), plain_elbo))
            return step(state, x, epoch_seed, **rest)

        return checked

    saved = (loop.make_train_step, loop.make_eval_step, rasterize.augment_pianoroll_batch, fetch.SYNTHETIC_SIZES)
    loop.make_train_step, loop.make_eval_step, rasterize.augment_pianoroll_batch = make_train_step, make_eval_step, aug
    fetch.SYNTHETIC_SIZES = {**fetch.SYNTHETIC_SIZES, "midi-synthetic": meta["synthetic_files"]}
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        r = train_cli.cli(meta["argv"] + meta["dtypes"][dtype] + ["--pretrained", str(init), "--models-dir",
                                                                  str(models), "--run-id", dtype])
    finally:
        loop.make_train_step, loop.make_eval_step, rasterize.augment_pianoroll_batch, fetch.SYNTHETIC_SIZES = saved
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    steps, f = r["total_step"], r["forwards"]
    log_cli_run(f"the JAX fixture's {dtype} run replayed, fused", r, card)
    want_counts = {"K1": steps, "K2": steps, "K3": f["grid"], "K3-bwd": 0, **expected_model_launches(r)}
    log(f"  launches {counts}, expected {want_counts}: K1 and K2 once per step; K3 only for the {f['grid']} "
        "reconstruction grids, whose draw is not replayed (the steps and sweeps take the fixture's draws through "
        "the plain reparameterization, so K3 and its backward stay out of them; k3_phase holds K3); the fused "
        "BatchNorm as the forwards predict (the f64 recomputations take the plain BatchNorm)")
    check(counts == want_counts, f"{dtype}: launched {counts}, expected {want_counts}")
    check(replay_train_step.used == len(draws.train) and make_eval_step.used == len(draws.eval[0])
          and aug.calls == steps, f"{dtype}: replayed {replay_train_step.used} step draws, {make_eval_step.used} eval "
          f"draws, {aug.calls} augmentations of {len(draws.train)}, {len(draws.eval[0])}, {steps}")
    run_dir = Path(r["config"]["model_output_dir"])
    with open(run_dir / "metrics.jsonl", encoding="utf-8") as fh:
        rows = [json.loads(line) for line in fh]
    files = sorted(os.path.splitext(n)[0] for n in os.listdir(run_dir))
    step_rows = [(g, w) for g, w in zip(rows, want["rows"]) if "training/stepwise/train/loss" in w]
    for g, w in step_rows:
        errs = {k: abs(g[f"training/stepwise/train/{k}"] - w[f"training/stepwise/train/{k}"])
                / abs(w[f"training/stepwise/train/{k}"]) for k in ("loss", "loss_recon", "loss_kld", "grad_norm")}
        log(f"    step {w['step']:2d}: loss {g['training/stepwise/train/loss']!r} (JAX {w['training/stepwise/train/loss']!r}); "
            "relative error " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    if f64:
        keys = ("loss", "loss_recon", "loss_kld", "grad_norm")
        got = np.array([[g[f"training/stepwise/train/{k}"] for k in keys] for g, _ in step_rows])
        rel = np.abs(got - np.array(f64)) / np.abs(np.array(f64))
        log(f"  {dtype} steps against the same steps in f64 on the card, relative error by step: "
            + "; ".join(f"{k} " + " ".join(f"{v:.1e}" for v in rel[:, i]) for i, k in enumerate(keys)))
        check(rel.max() <= F64_RTOL, f"{dtype}: a step is {rel.max():.3e} off its f64 recomputation (limit {F64_RTOL})")
    errors, worst = tr.row_errors(rows, want["rows"], step_rtol=tol["step_rtol"], step_atol=tol["step_atol"],
                                  eval_rtol=tol["eval_rtol"], eval_atol=tol["eval_atol"], key_rtol=tol["key_rtol"])
    for key in ("total_step", "n_samples_seen", "best_epoch"):
        if r[key] != want[key]:
            errors.append(f"{key} {r[key]}, JAX {want[key]}")
    if files != want["files"]:
        errors.append(f"run directory {files}, JAX {want['files']}")
    for part in ("final_test", "final_train"):
        for key, v in want[part].items():
            g = r[part][key]
            if "throughput" in key:
                continue
            if isinstance(v, int) and not isinstance(v, bool) and key in ("count", "active-units"):
                if g != v:
                    errors.append(f"{part} {key} {g}, JAX {v}")
            elif abs(g - v) > tol["eval_atol"] + tol["eval_rtol"] * abs(v):
                errors.append(f"{part} {key} {g!r}, JAX {v!r}")
            worst[f"{part}/{key}"] = abs(g - v) / max(abs(v), 1e-30)
    lr_sum = sum(max(v for k, v in w.items() if "/lr-" in k) for _, w in step_rows)
    leaf_errs, leaf_worst = leaf_errors(tr, r["state"].model, want["leaves"], tol["leaf_rtol"], 2.0 * lr_sum)
    errors += leaf_errs
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:6]
    log(f"  {dtype}: {len(rows)} rows key for key; largest relative errors " + ", ".join(f"{k} {v:.3e}" for k, v in top)
        + f"; leaves {leaf_worst:.3e} (cancelled biases within 2·Σlr = {2.0 * lr_sum:.4g}); best epoch {r['best_epoch']} "
        f"(JAX {want['best_epoch']}); tolerances {tol}; {seconds:.1f} s [{card}]")
    check(not errors, f"{dtype} run differs from the JAX fixture: " + "; ".join(errors[:12]))
    return counts


def trajectory_phase(dev, root: Path, card: str) -> dict:
    """The JAX package's flagship run (``tests/fixtures/make_trajectory.py``)
    replayed through the port's train CLI on the card, ``--fused`` with TF32
    off, in float32 and then bfloat16: the seeded init rebuilt from numpy,
    the fixture's step, eval and augmentation draws injected, every
    ``metrics.jsonl`` row, the counters, the final sweeps and every final
    leaf held to the fixture within ``TRAJECTORY_TOL``. Returns the launches
    of both runs."""
    tr = load_trajectory_replay(root)
    t_phase = time.perf_counter()
    with open(root / (TRAJECTORY_FIXTURE + ".json"), encoding="utf-8") as f:
        meta = json.load(f)
    with np.load(root / (TRAJECTORY_FIXTURE + ".npz")) as z:
        arrays = {k: z[k] for k in z.files}
    tmp = root / "build" / "tmp"
    tmp.mkdir(parents=True, exist_ok=True)
    tempfile.tempdir = str(tmp)
    models = root / "build" / "trajectory_models"
    shutil.rmtree(models, ignore_errors=True)
    models.mkdir(parents=True)
    init = models / "init.pt"
    trajectory_init(tr, meta, init)
    log(f"  init rebuilt from seed {meta['init_seed']} (checksum {meta['init_checksum']!r}, as recorded); fixture "
        f"from JAX {meta['jax']}, {meta['synthetic_files']} midi-synthetic files")
    total = {}
    for dtype in ("float32", "bfloat16"):  # f32 first: its tolerances are the tight ones
        add_counts(total, trajectory_run(tr, meta, arrays, dtype, init, models, dev, card))
    log(f"  trajectory phase {time.perf_counter() - t_phase:.1f} s, launches {total} [{card}]")
    return total


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
    log("fused BatchNorm + LeakyReLU (Triton) at the flagship's BatchNorm layers:")
    norm_rows = fused_norm_phase(dev)
    log("VQ search and sums (CUDA C++) at the VQ config's shapes:")
    vq_rows = vq_search_phase(dev)
    log(f"train ({TRAIN_STEPS} fused steps, flagship FoldedVAE):")
    model, counts, device_ms, flagship_window = train_phase(dev)
    log("reconstruct:")
    reconstruct_phase(model, dev)
    log("train CLI (configs/folded.yaml):")
    cli_counts = cli_phase(dev, root, card)
    log("inference (generate, evaluate, serve) on the fused run's best_model.pt:")
    serve_phase(dev, root, card)
    log(f"two-stage VQ path ({VQ_CONFIG}):")
    vq_counts = vq_phase(dev, root, card)
    log("training variants (grad_accum, β-TC, conditional, MLPVAE, optimizers):")
    accum_counts, variant_counts, variant_errs = variants_phase(dev, root, card)
    log("model variants (batch-sub4, remat, s2d/d2s, group and no norm, torch_compat):")
    model_counts, model_errs = model_variants_phase(dev, root, card, flagship_window)
    log("the exported serving artifact (aot_export, serve --artifact):")
    artifact_counts = artifact_phase(dev, root, card)
    log("multi-GPU training (one rank over NCCL, two ranks over gloo, the CLI):")
    parallel_counts = parallel_phase(dev, root, card, flagship_window)
    log("data and utilities (rrd: stream, --scan-steps, native parser, caches, probe, orbax, JAX checkpoints, "
        "download):")
    data_counts = data_phase(dev, root, card)
    log("public API (installed tree, registered architecture on a PNG folder, rasterize, example twins):")
    public_counts, public_errs = public_api_phase(dev, root, card)
    log("config (the YAML reader without PyYAML; configs/folded.yaml in block style trained beside it):")
    config_counts, config_errs = config_phase(dev, root, card)
    log("trajectory (the JAX package's flagship run replayed step by step, float32 and bfloat16):")
    trajectory_counts = trajectory_phase(dev, root, card)
    log(f"stage-2 MoE prior ({MOE_CONFIG}: Moonlight-16B-A3B's block, published widths):")
    moe_prior_phase(dev, root, card)

    runs = {"launches": counts, "cli_launches": cli_counts, "vq_launches": vq_counts, "accum_launches": accum_counts,
            "variant_launches": variant_counts, "model_variant_launches": model_counts,
            "artifact_launches": artifact_counts, "parallel_launches": parallel_counts, "data_launches": data_counts,
            "public_api_launches": public_counts, "config_launches": config_counts,
            "trajectory_launches": trajectory_counts}
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
                **{run: c[key] for run, c in runs.items()},
                "max_abs_err": max(errs[key], variant_errs[key], model_errs[key], public_errs[key], config_errs[key]),
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
    for key, name in NORM_INFO.items():  # their errors and times: the fused_norm line
        kernels.append({"name": name, "route": "triton", "source": "midi_vae_tpu_torch/ops/fused_norm.py",
                        "replaces": None, **{run: c[key] for run, c in runs.items()}})
        log(f"  {key}: " + ", ".join(f"{run} {c[key]}" for run, c in runs.items()))
    cell = vq_rows[0]  # the VQ cell's N; the vq_search line has both
    for key, (_, name) in VQ_INFO.items():
        times = {"ms": cell["kernel_ms"], "device_ms": cell["kernel_device_ms"], "plain_ms": cell["plain_ms"],
                 "bound_ms": cell["bound_ms"], "bound_by": cell["bound_by"], "library_ms": cell["library_ms"]}
        kernels.append({"name": name, "route": "cuda", "source": VQ_SOURCE, "replaces": None,
                        **{run: c[key] for run, c in runs.items()}, **(times if key == "VQ" else {})})
        log(f"  {key}: " + ", ".join(f"{run} {c[key]}" for run, c in runs.items()))
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"fused_norm": norm_rows}))
    print(json.dumps({"vq_search": vq_rows}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Driver of the training cells: the train CLI's per-batch path in a timed
window.

Set-up builds what ``train/loop.py`` builds for a run: the corpus (made on
the card from the seed by ``bench_cuda/frozen.py`` and held by a
``DeviceResidentLoader``), the model (``build_run_model``, then the
benchmark's own weights), the optimizer and its OneCycle schedule over the
configuration's epochs (``build_run_optimizer``), the KL schedule and the
step (``make_train_step``), with the configuration keys the workload
file sets under ``set`` (as a CLI flag would). It then runs epoch 1
through ``train_one_epoch``, which warms every shape; a wrapper around the
step keeps the first three steps' losses, KL terms and KL weights, the
first gradient as AdamW holds it (its first moment over 1 − β1) and the
parameters after step 3. The
window runs epochs 2, 3, ... through the same call until ``--seconds``
have passed; it ends on an epoch's host read of the loss and a
``torch.cuda.synchronize()``. The rate is every sample stepped over the
window's seconds.

The logger has no output directory (no ``metrics.jsonl``, no
reconstruction grids): the CLI's per-batch path as a run that saves
nothing takes it. The loop's prints go to standard error.

With ``--trace 1`` two profiled stretches of ``trace_steps`` batches
follow the window, each from the start of an epoch over as many epochs as
it takes: a device-only one, which
the per-layer metrics read (K1's and K2's call shapes are recorded there),
and a labelled one, which says what the host did in the device's idle
gaps. After all of it the program's state is freed and the plain
reference replays the three steps for the check.
"""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np
import torch

from bench_cuda import check, counts, frozen, peaks, trace, weights
from bench_cuda.reference import tf32_off

CHECK_STEPS = 3


class _Head:
    """The first ``k`` batches of a loader's epoch, with its interface."""

    def __init__(self, loader, k: int):
        self.loader, self.k = loader, min(k, len(loader))
        self.batch_size, self.dataset = loader.batch_size, loader.dataset

    def __len__(self):
        return self.k

    def epoch(self, epoch: int):
        for i, batch in enumerate(self.loader.epoch(epoch)):
            if i >= self.k:
                return
            yield batch


def _optimizer_grads(bundle, names) -> dict:
    """The first gradient as AdamW holds it after one step: exp_avg / (1 − β1)."""
    out = {}
    for group in bundle.optimizer.param_groups:
        b1 = group["betas"][0]
        for p in group["params"]:
            st = bundle.optimizer.state.get(p, {})
            g = st["exp_avg"] / (1.0 - b1) if "exp_avg" in st else torch.zeros_like(p)
            out[names[id(p)]] = g.detach().clone()
    return out


def train_config(ctx) -> dict:
    """The configuration's ``train`` keys with those the workload sets."""
    return {**ctx.config["train"], **ctx.workload.get("set", {})}


def _faulty(step, fault: str, model, bundle):
    """The step broken underneath, for the harness's own tests and the
    readings of ``calibrate.py``: ``unchanged`` returns the state it was
    given, ``half_batch`` steps on the first half of the batch. (``build``
    plants ``beta_ahead``, the KL weight read one step ahead, and
    ``lr_high``, every learning rate 10 % high.)"""
    if fault == "half_batch":
        def half(state, x, epoch_seed, *, y=None):
            b = x.shape[0] // 2
            return step(state, x[:b], epoch_seed, y=None if y is None else y[:b])
        return half
    if fault == "unchanged":
        def unchanged(state, x, epoch_seed, *, y=None):
            saved = ({k: v.clone() for k, v in model.state_dict().items()}, bundle.optimizer.state_dict())
            _, lo, gn = step(state, x, epoch_seed, y=y)
            model.load_state_dict(saved[0])
            bundle.optimizer.load_state_dict(saved[1])
            return state, lo, gn
        return unchanged
    raise ValueError(f"unknown fault {fault!r}")


def build(ctx):
    """The run's training object and what the check needs, as ``train/loop.py`` builds them."""
    from midi_vae_tpu_torch.core.rng import epoch_seed
    from midi_vae_tpu_torch.data.pipeline import DeviceResidentLoader
    from midi_vae_tpu_torch.data.sources import ArrayDataset
    from midi_vae_tpu_torch.data.transforms import VALID_TRANSFORMS, get_transform
    from midi_vae_tpu_torch.io.logging import MetricLogger
    from midi_vae_tpu_torch.losses.schedules import kl_weight_schedule
    from midi_vae_tpu_torch.train.config import TrainConfig
    from midi_vae_tpu_torch.train.loop import build_run_model, build_run_optimizer
    from midi_vae_tpu_torch.train.state import create_train_state, make_train_step

    cfg, tr, dev, seed = train_config(ctx), ctx.workload["traffic"], ctx.device, ctx.seed
    B, n = int(tr["batch"]), int(tr["corpus"])
    config = TrainConfig.from_dict({**cfg, "batch_size_per_device": B, "seed": seed, "models_dir": None})
    corpus = frozen.make_corpus(seed, n, dev)
    ctx.mark("corpus made")
    args = {"normalization": config.dataset_name} if config.dataset_name in VALID_TRANSFORMS else {}
    transform_train, _ = get_transform(config.transform_type, config.image_size, args)
    dataset = ArrayDataset(images=corpus.cpu().numpy(), labels=np.zeros(n, np.int64), name="bench_cuda",
                           transform=transform_train)
    loader = DeviceResidentLoader(dataset, B, train=True, seed=seed, device=dev)
    bias = weights.output_bias(cfg, corpus)
    model = build_run_model(config, dev, in_channels=int(cfg.get("in_channels", 1)), seed=seed,
                            output_bias=bias if cfg.get("output_bias_init") is not None else None)
    p0 = weights.make(ctx.reference.spec(cfg), seed, dev, logit_bias=bias)
    own = dict(model.named_parameters())
    if set(own) != set(p0):
        raise RuntimeError(f"the model's parameters are not the reference's: {sorted(set(own) ^ set(p0))[:6]}")
    with torch.no_grad():
        for name, p in own.items():
            p.copy_(p0[name])
    ctx.mark("loader and model built")
    bundle = build_run_optimizer(config, model, B, config.epochs * len(loader))
    kl_sched = kl_weight_schedule(config.kl_schedule, config.kld_weight, warmup_steps=config.kl_warmup_steps,
                                  period=config.kl_cycle_steps, ramp_fraction=config.kl_ramp_fraction,
                                  growth=config.kl_growth, cap=config.kl_cap)
    if ctx.fault == "beta_ahead":
        kl_sched = (lambda sched: lambda t: sched(t + 1))(kl_sched)
    if ctx.fault == "lr_high":
        for k, f in list(bundle.lr_schedules.items()):
            bundle.lr_schedules[k] = (lambda f: lambda t: 1.1 * f(t))(f)
    state = create_train_state(model, bundle, ema=config.ema_decay is not None)
    target_denorm = ((tuple(transform_train.mean), tuple(transform_train.std))
                     if config.bce_targets == "raw" else None)
    step = make_train_step(kl_sched, log_var_clamp=config.log_var_clamp, free_bits=config.free_bits,
                           pos_weight=config.bce_pos_weight, target_denorm=target_denorm, fused_loss=config.fused,
                           loss_type=config.loss_type, tc_beta=config.tc_beta, dataset_size=n,
                           grad_accum=config.grad_accum, ema_decay=config.ema_decay)
    if ctx.fault in ("unchanged", "half_batch"):
        step = _faulty(step, ctx.fault, model, bundle)
    names = {id(p): k for k, p in model.named_parameters()}
    kept = {"losses": [], "kls": [], "kl_weights": [], "first_grads": None, "params": None}

    def kept_step(state, x, e_seed, *, y=None):
        state, lo, gn = step(state, x, e_seed, y=y)
        if len(kept["losses"]) < CHECK_STEPS:
            kept["losses"].append(lo.loss.detach().float().clone())
            kept["kls"].append(lo.kl.detach().float().clone())
            kept["kl_weights"].append(lo.kld_weight.detach().float().clone())
            if len(kept["losses"]) == 1:
                kept["first_grads"] = _optimizer_grads(bundle, names)
            if len(kept["losses"]) == CHECK_STEPS:
                kept["params"] = {k: p.detach().clone() for k, p in model.named_parameters()}
        return state, lo, gn

    run = dict(config=config, corpus=corpus, loader=loader, model=model, bundle=bundle, state=state, step=step,
               kept_step=kept_step, kept=kept, p0=p0, logger=MetricLogger(None), B=B,
               epoch_seed=lambda e: epoch_seed(seed, e))
    return run


def epoch(run, e: int, step, loader=None):
    """One epoch through the CLI's ``train_one_epoch``; returns its mean loss."""
    from midi_vae_tpu_torch.train.loop import train_one_epoch

    stats, run["state"], _, _ = train_one_epoch(
        config=run["config"], model=run["model"], state=run["state"], train_step=step,
        loader=loader or run["loader"], logger=run["logger"], epoch=e, epoch_seed=run["epoch_seed"](e),
        lr_schedules=run["bundle"].lr_schedules)
    return stats["loss"]


def program_side(run) -> dict:
    """The kept readings of the first steps, on the host's side of the check."""
    kept = run["kept"]
    out = {k: [float(v) for v in kept[k]] for k in ("losses", "kls", "kl_weights")}
    return {**out, "first_grads": kept["first_grads"], "params": kept["params"]}


def reference_side(ctx, run, compute=None, steps=CHECK_STEPS, rows=None, reordered=False) -> dict:
    """The plain reference's first steps from the same weights and corpus, TF32 off."""
    with tf32_off():
        return ctx.reference.train_steps(train_config(ctx), run["p0"], run["corpus"], batch=run["B"], seed=ctx.seed,
                                         steps=steps, compute=compute, rows=rows, reordered=reordered)


RULE_ROWS = 256  # rows of the f32 step that says which leaves move


def numbers(ctx, run, prog: dict, ref: dict) -> dict:
    """The check's numbers of ``prog`` against ``ref``, the change over the
    leaves that move in the reference's first step in f32 (on the batch's
    first rows: BatchNorm cancels a conv bias's gradient at any batch)."""
    moved = check.moved_leaves(reference_side(ctx, run, "float32", steps=1, rows=RULE_ROWS)["first_grads"])
    return check.train_numbers(prog, ref, run["p0"], moved)


def free_program(run) -> None:
    """Drop the program's state before the reference runs."""
    run["loader"].release()
    for key in ("loader", "model", "bundle", "state", "step", "kept_step", "logger"):
        run.pop(key, None)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(ctx) -> dict:
    tr = ctx.workload["traffic"]
    with contextlib.redirect_stdout(sys.stderr):
        r = build(ctx)
        epoch(r, 1, r["kept_step"])  # set-up: every shape warmed, the first steps kept
        ctx.mark("epoch 1")
        if len(r["kept"]["losses"]) < CHECK_STEPS:
            raise RuntimeError(f"an epoch has fewer than {CHECK_STEPS} steps")
        ctx.sync()
        t_first = time.time()
        e, step0, epoch_losses = 2, r["state"].step, []
        t0 = time.perf_counter()
        while True:
            epoch_losses.append(epoch(r, e, r["step"]))
            e += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        ctx.sync()
        window_s = time.perf_counter() - t0
    steps = r["state"].step - step0
    total = r["config"].epochs * len(r["loader"])
    if r["state"].step > total:
        ctx.log(f"note: the window reached step {r['state'].step} of the OneCycle schedule's {total}")
    result = {
        "e2e": {"setup_s": t_first - ctx.t_start, "train_samples_per_s": steps * r["B"] / window_s},
        "attempted": steps,
        "failed": sum(len(r["loader"]) for v in epoch_losses if not np.isfinite(v)),
    }
    ctx.log(f"window: {steps} steps of {r['B']} in {window_s:.3f} s over {len(epoch_losses)} epochs")
    if ctx.trace:
        result["trace"] = traced_stretch(ctx, r, e, steps, window_s)
    result["memory_peak_bytes"] = ctx.memory_peak()
    prog = program_side(r)
    free_program(r)
    nums = numbers(ctx, r, prog, reference_side(ctx, r))
    result["checks"] = [(k, nums[k], limit) for k, limit in ctx.workload["limits"].items()]
    return result


def traced_stretch(ctx, r, e: int, window_steps: int, window_s: float) -> dict:
    """The profiled stretches after the window, and what the per-layer readers read."""
    from midi_vae_tpu_torch.ops import fused_elbo

    k = int(ctx.workload["traffic"]["trace_steps"])
    calls = {"K1": [], "K2": []}
    originals = {"K1": fused_elbo.bce_mean, "K2": fused_elbo.bce_mean_grad}

    def recorder(key):
        fn = originals[key]

        def wrapped(logits, targets, *rest):
            calls[key].append((logits.numel(), logits.element_size(), targets.element_size()))
            return fn(logits, targets, *rest)
        wrapped.launches = fn.launches  # the kernel wrapper counts on the module's name
        return wrapped

    def steps_from(e0: int):
        """``k`` steps from the start of epoch ``e0``, over as many epochs as it takes."""
        def go():
            left, e1 = k, e0
            while left > 0:
                n = min(left, len(r["loader"]))
                epoch(r, e1, r["step"], _Head(r["loader"], n))
                left, e1 = left - n, e1 + 1
        return go

    per_epoch = -(-k // len(r["loader"]))
    cuda = ctx.device.type == "cuda"
    fused_elbo.bce_mean, fused_elbo.bce_mean_grad = recorder("K1"), recorder("K2")
    try:
        with contextlib.redirect_stdout(sys.stderr):
            tl = trace.profile(steps_from(e), device_only=cuda)
    finally:
        for key, name in (("K1", "bce_mean"), ("K2", "bce_mean_grad")):
            originals[key].launches = getattr(fused_elbo, name).launches
            setattr(fused_elbo, name, originals[key])
    ctx.log(f"traced: {k} steps in a stretch of {tl.window_s:.6f} s ({tl.window_s / k * 1e3:.3f} ms a step, the "
            f"window's {window_s / max(window_steps, 1) * 1e3:.3f}), busy {tl.busy_s():.6f} s")
    labelled = None
    if cuda:
        with contextlib.redirect_stdout(sys.stderr):
            labelled = trace.profile(steps_from(e + per_epoch), device_only=False)
    cfg = train_config(ctx)
    return {
        "timeline": tl,
        "labelled": labelled,
        "stretch_steps": k,
        "window": {"seconds": window_s, "steps": window_steps},
        "flops_per_step": counts.model_flops(ctx.reference, cfg, r["B"]),
        "peak_flops": peaks.PEAK_FLOPS[cfg["dtype"]],
        "kernel_calls": calls,
    }

"""Training orchestration (counterpart of ``midi_vae_tpu/train/loop.py``).

``run(config, device)`` goes through the JAX package's phases in order:
checkpoint config restore → dataset → "auto" statistics → model →
loaders → optimizer and KL schedule → state (warm start, resume) → epoch
loop (train, validate, collapse alarm, best tracking, save, log, early
stop) → final Test, Val and Train-under-eval sweeps. The step is eager
PyTorch on ``device`` (CUDA unless the caller asks for the CPU); with
``config.fused`` its loss and reparameterization run the kernels K1–K3.

Options the port does not have yet raise ``NotImplementedError`` naming
their ROADMAP item (:func:`check_ported`), before any work is done.
"""

from __future__ import annotations

import copy
import os
import sys
import time
import traceback
from datetime import datetime
from typing import Optional

import numpy as np
import torch

from midi_vae_tpu_torch.core.device import DeviceLike, resolve_device
from midi_vae_tpu_torch.core.rng import epoch_seed as derive_epoch_seed
from midi_vae_tpu_torch.data.fetch import fetch_dataset
from midi_vae_tpu_torch.data.pipeline import make_loader
from midi_vae_tpu_torch.data.registry import image_dataset_sizes
from midi_vae_tpu_torch.data.stats import estimate_base_rate, resolve_auto
from midi_vae_tpu_torch.data.transforms import VALID_TRANSFORMS, denormalize, get_transform
from midi_vae_tpu_torch.evaluation.disentanglement import mig_from_loader
from midi_vae_tpu_torch.evaluation.evaluate import evaluate, make_eval_step
from midi_vae_tpu_torch.evaluation.inference import reconstruction_grid
from midi_vae_tpu_torch.evaluation.iwae import iwae_bound
from midi_vae_tpu_torch.io.checkpoint import (
    CHECKPOINT_LATEST,
    AsyncCheckpointWriter,
    copy_best,
    load_checkpoint,
    restore_config,
    save_checkpoint,
)
from midi_vae_tpu_torch.io.logging import MetricLogger, PhaseTimer, generate_id, print_epoch_summary, write_png
from midi_vae_tpu_torch.losses.schedules import kl_weight_schedule
from midi_vae_tpu_torch.models.registry import build_model
from midi_vae_tpu_torch.models.vae import param_group_label
from midi_vae_tpu_torch.train.config import TrainConfig
from midi_vae_tpu_torch.train.optim import build_optimizer, scale_lr
from midi_vae_tpu_torch.train.state import (
    create_train_state,
    load_state_dict,
    make_train_step,
    reconcile_ema_state_dict,
    state_dict,
)

_VQ_ARCHS = ("vqvae", "foldedvqvae")


def check_ported(config: TrainConfig) -> None:
    """Raise ``NotImplementedError`` for an option the port does not have
    yet, naming its ROADMAP item (Queue 1)."""
    gaps = [
        (config.arch.lower() in _VQ_ARCHS or config.loss_type == "vq", "VQ models and the VQ objective", 12),
        (config.loss_type == "beta-tc", "the beta-TC objective", 17),
        (config.grad_accum != 1, "--grad-accum > 1", 7),
        (config.scan_steps != 1, "--scan-steps > 1 (scan-chunked epochs)", 9),
        (config.checkpoint_backend == "orbax", "--checkpoint-backend orbax", 10),
        ((config.num_devices or 1) != 1, "--num-devices > 1 (multi-GPU data parallelism)", 16),
        (config.mesh_slices, "--mesh-slices (multi-slice data parallelism)", 16),
        (config.step_impl != "auto", "--step-impl shard_map", 16),
        (config.conditional, "--conditional", 17),
        (config.stem != "conv" or config.head != "deconv", "--stem s2d / --head d2s", 17),
        (config.norm != "batch", f"--norm {config.norm}", 17),
        (config.remat, "--remat", 17),
        (config.torch_compat, "--torch-compat", 17),
        (config.verbose, "--verbose (forward range tracing)", 17),
        (config.compilation_cache, "--compilation-cache", 17),
        (config.optimizer.lower() != "adamw", f"--optimizer {config.optimizer}", 17),
        (config.scheduler.lower() not in ("onecycle", "constant"), f"--scheduler {config.scheduler}", 17),
        (config.arch.lower() not in ("vanillavae", "foldedvae", *_VQ_ARCHS), f"--model {config.arch}", 17),
    ]
    for missing, what, item in gaps:
        if missing:
            raise NotImplementedError(f"{what} is not ported to the PyTorch package yet (ROADMAP Queue 1 item {item})")


def run(config: TrainConfig, device: DeviceLike = "cuda") -> dict:
    """Run a training job on ``device``; returns the results dict (final
    metrics, counters, the train state, per-epoch history and timings)."""
    t_run_start = time.time()
    dev = resolve_device(device)
    check_ported(config)
    if config.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    if config.deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    timings = {}

    print("\nConfiguration:\n")
    print(config)
    print(f"\nDevice: {dev}" + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""))

    # RESTORE OMITTED CONFIG FROM THE RESUMPTION CHECKPOINT ====================
    checkpoint_payload = None
    if config.checkpoint_path:
        config.model_output_dir = os.path.dirname(config.checkpoint_path)
        if not os.path.isfile(config.checkpoint_path):
            print(
                "Skipping premature resumption from preemption: no checkpoint file"
                f" found at '{config.checkpoint_path}'"
            )
        else:
            print(f"Loading resumption checkpoint '{config.checkpoint_path}'")
            checkpoint_payload = load_checkpoint(config.checkpoint_path)
            config = TrainConfig.from_dict(restore_config(config.to_dict(), checkpoint_payload.get("config", {})))
            check_ported(config)
    start_epoch = 1 if checkpoint_payload is None else int(checkpoint_payload["epoch"]) + 1

    # MODEL SIZING ===========================================================
    _, _, img_channels = image_dataset_sizes(config.dataset_name)
    if config.image_size is None:
        config.image_size = 32
    dtype = torch.bfloat16 if config.dtype == "bfloat16" else torch.float32
    encoder_config = {"input_size": config.image_size, "n_feature": config.n_features}
    global_batch_size = config.batch_size_per_device  # one device
    print(f"One device; global batch size {global_batch_size}")

    # DATASET ================================================================
    transform_args = {}
    if config.dataset_name in VALID_TRANSFORMS:
        transform_args["normalization"] = config.dataset_name
    transform_train, transform_eval = get_transform(config.transform_type, config.image_size, transform_args)
    dataset_args = dict(
        dataset=config.dataset_name,
        root=config.data_dir,
        prototyping=config.prototyping,
        download=config.allow_download_dataset,
        protoval_split_rate=config.protoval_split_rate,
        device=dev,
    )
    if config.protoval_split_id is not None:
        dataset_args["protoval_split_id"] = config.protoval_split_id
    t0 = time.perf_counter()
    dataset_train, dataset_val, dataset_test, distinct_val_test = fetch_dataset(
        **dataset_args, transform_train=transform_train, transform_eval=transform_eval
    )
    timings["fetch_s"] = time.perf_counter() - t0
    eval_set = "Val" if distinct_val_test else "Test"
    print(
        f"corpus '{config.dataset_name}': {len(dataset_train)} train, {len(dataset_val)} val, "
        f"{len(dataset_test)} test samples ({timings['fetch_s']:.3f} s)"
    )

    # MODEL ==================================================================
    base_rate = (
        estimate_base_rate(dataset_train) if "auto" in (config.bce_pos_weight, config.output_bias_init) else None
    )
    pos_weight = resolve_auto(config.bce_pos_weight, dataset_train, "pos_weight", base_rate=base_rate)
    output_bias = resolve_auto(config.output_bias_init, dataset_train, "bias", base_rate=base_rate)
    target_denorm = (
        (tuple(transform_train.mean), tuple(transform_train.std)) if config.bce_targets == "raw" else None
    )
    seed = config.seed if config.seed is not None else int(time.time()) % 100000
    print(f"loading model '{config.arch}' for '{config.dataset_name}' dataset @ {config.image_size}px")
    model = build_model(
        config.arch,
        in_channels=img_channels,
        latent_dim=config.n_features,
        input_dim=config.image_size,
        hidden_dims=config.hidden_dims,
        dtype=dtype,
        fused_reparam=config.fused,
        fold=config.fold,
        output_logit_bias=output_bias,
        seed=seed,
        device=dev,
    )

    loader_kw = dict(device=dev, prefetch=config.prefetch, placement=config.data_placement)
    loader_train = make_loader(dataset_train, global_batch_size, train=True, seed=seed, **loader_kw)
    loader_val = make_loader(dataset_val, global_batch_size, train=False, **loader_kw)
    loader_test = loader_val if not distinct_val_test else make_loader(
        dataset_test, global_batch_size, train=False, **loader_kw
    )

    # OPTIMIZATION ===========================================================
    total_steps = config.epochs * len(loader_train)
    bundle = build_optimizer(
        model,
        param_group_label,
        optimizer=config.optimizer,
        lr=scale_lr(config.lr_relative, global_batch_size),
        lr_encoder_mult=config.lr_encoder_mult,
        lr_decoder_mult=config.lr_decoder_mult,
        weight_decay=config.weight_decay,
        scheduler=config.scheduler,
        total_steps=total_steps,
        freeze_encoder=config.freeze_encoder,
        grad_clip=config.grad_clip or None,
    )
    kl_sched = kl_weight_schedule(
        config.kl_schedule,
        config.kld_weight,
        warmup_steps=config.kl_warmup_steps,
        period=config.kl_cycle_steps,
        ramp_fraction=config.kl_ramp_fraction,
        growth=config.kl_growth,
        cap=config.kl_cap,
    )

    # STATE ==================================================================
    state = create_train_state(model, bundle, ema=config.ema_decay is not None)
    print(f"Model has {sum(p.numel() for p in model.parameters()):,} parameters")
    if config.pretrained and checkpoint_payload is None:
        _warm_start(state, config.pretrained)
    train_step = make_train_step(
        kl_sched,
        log_var_clamp=config.log_var_clamp,
        free_bits=config.free_bits,
        pos_weight=pos_weight,
        target_denorm=target_denorm,
        fused_loss=config.fused,
        loss_type=config.loss_type,
        grad_accum=config.grad_accum,
        ema_decay=config.ema_decay,
    )
    eval_step = make_eval_step(
        model, target_denorm=target_denorm,
        occupancy_denorm=(tuple(transform_eval.mean), tuple(transform_eval.std)),
    )

    # model forwards by kind over the run: train steps, reconstruction grids
    # and eval batches (what a caller needs to account for kernel launches)
    forwards = {"train_steps": 0, "grid": 0, "eval_batches": 0}

    def run_eval(loader, partition_name: str) -> dict:
        """``evaluate`` on the current weights: the EMA averages when tracking is on."""
        forwards["eval_batches"] += len(loader)
        params = state.ema_params if config.ema_decay is not None else None
        return evaluate(loader, model, params, partition_name=partition_name, seed=seed, eval_step=eval_step)

    # LOGGING ================================================================
    if config.run_name is None:
        config.run_name = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    if config.run_id is None:
        config.run_id = generate_id()
    if not config.checkpoint_path and config.models_dir:
        dataset_component = config.dataset_name.replace("/", "_").replace(":", "_")
        config.model_output_dir = os.path.join(config.models_dir, dataset_component, f"{config.run_name}__{config.run_id}")
        config.checkpoint_path = os.path.join(config.model_output_dir, CHECKPOINT_LATEST)
    print("Model will not be saved." if not config.checkpoint_path else f"Model will be saved to '{config.checkpoint_path}'")
    logger = MetricLogger(
        config.model_output_dir,
        use_wandb=config.log_wandb,
        wandb_entity=config.wandb_entity,
        wandb_project=config.wandb_project,
        run_name=f"{config.run_name}__{config.run_id}",
        run_id=config.run_id,
        config=config.to_dict(),
        tags=["prototype" if config.prototyping else "final"],
    )

    # RESUME =================================================================
    total_step = 0
    n_samples_seen = 0
    best_stats = {"best_epoch": 0, "best_metric": float("inf"), "best_metric_name": None}
    collapse_warned = False
    if checkpoint_payload is not None:
        print(f"Loading state from checkpoint (epoch {checkpoint_payload['epoch']})")
        state = load_state_dict(state, reconcile_ema_state_dict(checkpoint_payload["state"], state))
        total_step = int(checkpoint_payload["total_step"])
        n_samples_seen = int(checkpoint_payload["n_samples_seen"])
        best_stats["best_epoch"] = int(checkpoint_payload.get("best_epoch", 0))
        best_stats["best_metric"] = float(checkpoint_payload.get("best_metric", float("inf")))
        best_stats["best_metric_name"] = checkpoint_payload.get("best_metric_name") or "cross-entropy"

    # TRAIN ==================================================================
    results: dict = {
        "history": [],
        "timings": timings,
        "start_epoch": start_epoch,
        "corpus": {"train": len(dataset_train), "val": len(dataset_val), "test": len(dataset_test)},
    }
    last_epoch = config.epochs
    if config.stop_after_epochs is not None:
        last_epoch = min(last_epoch, start_epoch + config.stop_after_epochs - 1)
    if config.early_stop_patience is not None and config.early_stop_patience < 1:
        raise ValueError(f"early_stop_patience must be >= 1, got {config.early_stop_patience}")
    async_writer = AsyncCheckpointWriter() if config.async_checkpoint else None
    profiler = None
    try:
        for epoch in range(start_epoch, last_epoch + 1):
            t_start_epoch = time.time()
            if config.profile_dir and epoch < start_epoch + config.profile_epochs:
                if profiler is None:
                    profiler = _start_profiler(dev)
            elif profiler is not None:
                _stop_profiler(profiler, config.profile_dir)
                profiler = None
            n_before = n_samples_seen
            train_stats, state, total_step, n_samples_seen = train_one_epoch(
                config=config,
                model=model,
                state=state,
                train_step=train_step,
                loader=loader_train,
                logger=logger,
                epoch=epoch,
                epoch_seed=derive_epoch_seed(seed, epoch),
                lr_schedules=bundle.lr_schedules,
                n_samples_seen=n_samples_seen,
                forwards=forwards,
            )
            duration_train = time.time() - t_start_epoch
            n_epoch_samples = n_samples_seen - n_before
            train_stats["throughput"] = n_epoch_samples / max(duration_train, 1e-9)
            print_epoch_summary(
                "Training", epoch, config.epochs,
                {"total_step": total_step, "steps": len(loader_train), "samples": n_epoch_samples, **train_stats},
                duration_train,
            )

            t_start_val = time.time()
            eval_stats = run_eval(loader_val, eval_set)
            duration_val = time.time() - t_start_val
            eval_stats["throughput"] = loader_val.num_samples / max(duration_val, 1e-9)
            print_epoch_summary("Evaluating", epoch, config.epochs, eval_stats, duration_val)

            # collapse alarm: 0 active units past the first epochs (KL warm-up
            # may start the latent inactive), once per run
            if not collapse_warned and eval_stats.get("active-units") == 0 and epoch >= min(3, last_epoch):
                collapse_warned = True
                print(
                    "WARNING: 0 active latent units at epoch "
                    f"{epoch} (KL {eval_stats.get('kl', float('nan')):.4f} nat) — posterior collapse. "
                    "On sparse corpora train with --bce-targets raw --output-bias-init auto "
                    "(configs/folded_quality.yaml sets both)."
                )

            # best epoch by the validation reconstruction metric the run optimises
            select_name = "bce-objective" if "bce-objective" in eval_stats else "cross-entropy"
            if best_stats["best_metric_name"] not in (None, select_name):
                print(
                    f"best-metric tracking switched from {best_stats['best_metric_name']!r} "
                    f"to {select_name!r}; resetting best-epoch tracking"
                )
                best_stats["best_metric"] = float("inf")
            best_stats["best_metric_name"] = select_name
            if eval_stats[select_name] < best_stats["best_metric"]:
                best_stats["best_metric"] = eval_stats[select_name]
                best_stats["best_epoch"] = epoch

            t_start_save = time.time()
            if config.checkpoint_path:
                save_kwargs = dict(
                    config=config.to_dict(),
                    epoch=epoch,
                    total_step=total_step,
                    n_samples_seen=n_samples_seen,
                    encoder_config=encoder_config,
                    transform_args=transform_args,
                    best_epoch=best_stats["best_epoch"],
                    best_metric=best_stats["best_metric"],
                    best_metric_name=best_stats["best_metric_name"],
                )
                if async_writer is not None:
                    async_writer.save(config.checkpoint_path, state_dict(state), **save_kwargs)
                else:
                    save_checkpoint(config.checkpoint_path, state_dict(state), **save_kwargs)
                if config.save_best_model and best_stats["best_epoch"] == epoch:
                    if async_writer is not None:
                        async_writer.wait()  # best copies the completed latest file
                    print(f"Copied best model to {copy_best(config.checkpoint_path)}")
            duration_save = time.time() - t_start_save

            pre = "training/epochwise"
            logger.log(
                {
                    "training/stepwise/epoch": epoch,
                    "training/stepwise/n_samples_seen": n_samples_seen,
                    f"{pre}/epoch": epoch,
                    **{f"{pre}/train/{k}": v for k, v in train_stats.items()},
                    **{f"{pre}/{eval_set}/{k}": v for k, v in eval_stats.items()},
                    f"{pre}/duration/train": duration_train,
                    f"{pre}/duration/val": duration_val,
                    f"{pre}/duration/saving": duration_save,
                    f"{pre}/duration/overall": time.time() - t_start_epoch,
                },
                step=total_step,
            )
            results["train"] = train_stats
            results[eval_set.lower()] = eval_stats
            results["history"].append({"epoch": epoch, "train": train_stats, eval_set.lower(): eval_stats})

            if config.early_stop_patience is not None and epoch - best_stats["best_epoch"] >= config.early_stop_patience:
                print(
                    f"Early stopping after epoch {epoch}: no {best_stats['best_metric_name']} "
                    f"improvement in {config.early_stop_patience} epochs (best epoch {best_stats['best_epoch']})"
                )
                last_epoch = epoch
                break
    finally:
        # the last handed-off checkpoint must land even when unwinding; a
        # failure here must not hide the error being unwound
        unwinding = sys.exc_info()[0] is not None
        try:
            if profiler is not None:
                _stop_profiler(profiler, config.profile_dir)
            if async_writer is not None:
                async_writer.wait()
        except Exception:
            if not unwinding:
                raise
            traceback.print_exc()

    if start_epoch > config.epochs:
        print("Training already completed!")
    else:
        print(f"Training complete! (Trained epochs {start_epoch} to {last_epoch})")

    # FINAL EVALUATION =======================================================
    print(f"\nEvaluating final model (epoch {last_epoch}) performance")
    print("\nEvaluating final model on test set...")
    test_stats = run_eval(loader_test, "Test")
    if config.final_iwae or config.final_mig:
        # the weights evaluation uses: the EMA averages when tracking is on
        eval_model = model
        if config.ema_decay is not None:
            eval_model = copy.deepcopy(model)
            eval_model.load_state_dict(state.ema_params, strict=False)
        if config.final_iwae:
            # held-out density estimate (nats/sample), against the de-normalised
            # [0, 1] pixels whatever --bce-targets mode trained the run
            test_stats[f"iwae-{config.final_iwae}"] = iwae_bound(
                loader_test, eval_model, k=config.final_iwae, seed=seed,
                target_denorm=(tuple(transform_eval.mean), tuple(transform_eval.std)),
            )
            print(f"  {f'iwae-{config.final_iwae} ':.<24s} {test_stats[f'iwae-{config.final_iwae}']:9.5f} nat/sample")
        if config.final_mig:
            # disentanglement of the test posterior means against the dataset labels
            test_stats["mig"] = mig_from_loader(loader_test, eval_model, bins=config.final_mig)["mig"]
            print(f"  {'mig ':.<24s} {test_stats['mig']:9.5f}")
    logger.log({f"eval/test/{k}": v for k, v in test_stats.items()}, step=total_step)
    results["final_test"] = test_stats
    if distinct_val_test:
        print(f"\nEvaluating final model on {eval_set} set...")
        val_stats = run_eval(loader_val, eval_set)
        logger.log({f"eval/val/{k}": v for k, v in val_stats.items()}, step=total_step)
        results["final_val"] = val_stats

    print("\nEvaluating final model on train set under test conditions (no augmentation)...")
    if hasattr(loader_train, "release"):
        loader_train.release()  # its device copy is done with; the eval copy takes its place
    loader_train_eval = make_loader(
        dataset_train.with_transform(transform_eval), global_batch_size, train=False, **loader_kw
    )
    results["final_train"] = run_eval(loader_train_eval, "Train")
    logger.log({f"eval/train/{k}": v for k, v in results["final_train"].items()}, step=total_step)

    results["state"] = state
    results["total_step"] = total_step
    results["n_samples_seen"] = n_samples_seen
    results["best_epoch"] = best_stats["best_epoch"]
    results["steps_per_epoch"] = len(loader_train)
    results["forwards"] = forwards
    results["duration_total"] = time.time() - t_run_start
    for ldr in (loader_train, loader_val, loader_test, loader_train_eval):
        if hasattr(ldr, "release"):
            ldr.release()
    logger.close()
    return results


def _warm_start(state, path: str) -> None:
    """--pretrained: parameters (the EMA averages when the checkpoint has
    them) and running statistics from a checkpoint of this package;
    optimizer and counters stay fresh."""
    pre = load_checkpoint(path)
    pre_state = pre.get("state") if isinstance(pre, dict) else None
    if not isinstance(pre_state, dict) or "model" not in pre_state:
        raise ValueError(f"--pretrained expects a checkpoint written by this package's trainer: {path}")
    weights = dict(pre_state["model"])
    weights.update(pre_state.get("ema_params") or {})
    state.model.load_state_dict(weights)
    if state.ema_params is not None:  # EMA restarts from the warm-started weights
        with torch.no_grad():
            for name, p in state.model.named_parameters():
                state.ema_params[name].copy_(p)
    print(f"Warm-started parameters from '{path}' (epoch {pre.get('epoch', '?')}); optimizer state and counters start fresh")


def _start_profiler(dev: torch.device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profiler(prof, profile_dir: str) -> None:
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"Wrote profiler trace to {path}")


def train_one_epoch(
    *,
    config: TrainConfig,
    model,
    state,
    train_step,
    loader,
    logger: MetricLogger,
    epoch: int,
    epoch_seed: int,
    lr_schedules,
    n_samples_seen: int = 0,
    n_epoch: Optional[int] = None,
    forwards: Optional[dict] = None,
):
    """Train one epoch; returns (stats, state, total_step, n_samples_seen).
    ``forwards``, when given, counts the epoch's train steps and
    reconstruction-grid forwards into its ``train_steps`` and ``grid``.

    The loss sum stays on the device; the host reads the device at print
    and log points only. ``stats`` holds the mean loss and the epoch's
    host time by phase (``phase_s``): ``dataloader`` (waiting for the next
    batch), ``device_step`` (issuing the step, and waiting for the device
    at log points), ``logging``.
    """
    n_epoch = n_epoch if n_epoch is not None else config.epochs
    print_interval = config.print_interval if config.print_interval is not None else config.log_interval
    num_batches = len(loader)
    world_batch = loader.batch_size
    dev = next(model.parameters()).device
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    t_last_log = time.time()
    steps_since_log = 0
    timer, epoch_phases = PhaseTimer(), {}

    def fold_phases():
        for phase, secs in timer.durations().items():
            epoch_phases[phase] = epoch_phases.get(phase, 0.0) + secs

    batches = iter(loader.epoch(epoch))
    batch_idx = -1
    while True:
        timer.mark("dataloader")
        batch = next(batches, None)
        if batch is None:
            break
        batch_idx += 1
        timer.mark("device_step")
        state, lo, grad_norm = train_step(state, batch.x, epoch_seed)
        if forwards is not None:
            forwards["train_steps"] += 1
        loss_sum += lo.loss.float()
        n_samples_seen += world_batch
        steps_since_log += 1

        is_print = batch_idx <= 2 or batch_idx % print_interval == 0 or batch_idx >= num_batches - 1
        is_log = batch_idx % config.log_interval == 0
        if epoch <= 1 and batch_idx == 0:
            print("stimuli.shape =", tuple(batch.x.shape))
            print("loss.shape    =", tuple(lo.loss.shape) or "scalar")
            print("loss =", float(lo.loss))
        if is_print or is_log:
            step_now = state.step
            loss_f, kld_f, w_f = float(lo.loss), float(lo.kld_loss), float(lo.kld_weight)
            lr_now = {name: float(s(step_now - 1)) for name, s in lr_schedules.items()}
            timer.mark("logging")  # the wait above counts as device_step
            if is_print:
                lr_print = next(iter(lr_now.values())) if lr_now else 0.0
                print(
                    f"Train Epoch:{epoch:4d}/{n_epoch}"
                    f"  Step:{batch_idx + 1:4d}/{num_batches}"
                    f"  Loss:[F: {loss_f:6.3f}, KL: {kld_f:6.3f}]"
                    f"  LR: {lr_print:.5f}"
                    f"  KL Weight: {w_f:.5f}"
                )
            if is_log:
                t_now = time.time()
                throughput = steps_since_log * world_batch / max(t_now - t_last_log, 1e-9)
                t_last_log, steps_since_log = t_now, 0
                log_dict = {
                    "training/stepwise/epoch": epoch,
                    "training/stepwise/epoch_progress": epoch - 1 + (batch_idx + 1) / num_batches,
                    "training/stepwise/n_samples_seen": n_samples_seen,
                    "training/stepwise/train/throughput": throughput,
                    "training/stepwise/train/loss": loss_f,
                    "training/stepwise/train/loss_recon": float(lo.reconstruction_loss),
                    "training/stepwise/train/loss_kld": kld_f,
                    "training/stepwise/train/kld_weight": w_f,
                    "training/stepwise/train/grad_norm": float(grad_norm),
                }
                for name, v in lr_now.items():
                    log_dict[f"training/stepwise/lr-{name}"] = v
                for phase, secs in timer.durations().items():
                    log_dict[f"training/stepwise/duration/{phase}"] = secs
                fold_phases()
                timer.reset()
                logger.log(log_dict, step=step_now)
            timer.mark("device_step")  # the rest of the log block, until the next fetch

        # reconstruction grids of the first two batches
        if config.log_images and batch_idx <= 1 and (logger.wandb_run is not None or logger.output_dir):
            _log_reconstruction_grid(logger, model, batch.x, state.step, loader.dataset.transform)
            if forwards is not None:
                forwards["grid"] += 1

    fold_phases()
    stats = {"loss": float(loss_sum) / num_batches, "phase_s": epoch_phases}
    return stats, state, state.step, n_samples_seen


@torch.no_grad()
def _log_reconstruction_grid(logger, model, x, step: int, spec=None) -> None:
    """Input|reconstruction pairs of up to 8 samples, four pairs a row: to
    wandb when it is on, else a PNG next to the checkpoint."""
    recon = model(x[:8], train=False, seed=0).output.float()
    inputs = denormalize(spec, x[:8]) if spec is not None else x[:8]
    grid = reconstruction_grid(inputs, recon).cpu().numpy()
    if logger.wandb_run is not None:
        import wandb

        logger.wandb_run.log({"training/stepwise/train/reconstruction": wandb.Image(grid)}, step=step)
    elif logger.output_dir:
        arr = (np.clip(grid, 0.0, 1.0) * 255).astype(np.uint8)
        write_png(os.path.join(logger.output_dir, f"reconstruction_step{step:06d}.png"), arr)


"""Training orchestration (counterpart of ``midi_vae_tpu/train/loop.py``).

``run(config, device)`` goes through the JAX package's phases in order:
checkpoint config restore → dataset → "auto" statistics → model →
loaders → optimizer and KL schedule → state (warm start, resume) → epoch
loop (train, validate, collapse alarm, best tracking, save, log, early
stop) → final Test, Val and Train-under-eval sweeps. The step is eager
PyTorch on ``device`` (CUDA unless the caller asks for the CPU); with
``config.fused`` its loss and reparameterization run the kernels K1–K3.
VQ models (``VQVAE``, ``FoldedVQVAE``) train under the VQ objective, which
refuses ``--fused``, and report their codebook health (perplexity, active
codes) with every validation and the final test. ``--conditional`` builds
the Gaussian model over the dataset's classes and passes the batch labels
to every train, eval and grid forward.

Several devices (``num_devices`` > 1; None is every visible GPU): ``run``
outside a process group starts one rank per device
(``parallel/launch.py``) and returns rank 0's results; inside one, it
builds the mesh (``mesh_slices``: the multi-slice mesh), feeds each rank
its rows of every global batch (``batch_size_per_device`` × shards),
trains with the auto step (the one-device step on the global batch) or
the explicit ``shard_map`` step (``parallel/spmd.py``), reduces the
evaluation sums over the ranks, and lets rank 0 alone write checkpoints,
metrics and images, with a barrier after each save. A one-device run with
``step_impl="shard_map"`` or a mesh option runs its collectives over a
one-rank group.

The data and utility options: ``rrd:PATH`` datasets stream through the
native loader; ``--scan-steps N`` runs a device-resident train epoch in
chunks of N steps with one host read per chunk (the per-batch epoch's
steps exactly); ``--checkpoint-backend orbax`` writes sharded directories
(``io/dcp_io.py``) and a resume detects either format and keeps writing
it; ``--pretrained`` takes a JAX package ``.msgpack`` checkpoint too;
``--compilation-cache DIR`` keeps the process's kernel builds in DIR.
"""

from __future__ import annotations

import copy
import os
import shutil
import sys
import time
import traceback
from datetime import datetime
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from midi_vae_tpu_torch.core.compile_cache import enable_compilation_cache
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
    FLAX_STATE,
    AsyncCheckpointWriter,
    copy_best,
    load_checkpoint,
    model_weights,
    restore_config,
    save_checkpoint,
)
from midi_vae_tpu_torch.io.dcp_io import ORBAX_CHECKPOINT_LATEST, DCPAsyncWriter, is_orbax_checkpoint
from midi_vae_tpu_torch.io.logging import MetricLogger, PhaseTimer, generate_id, print_epoch_summary, write_png
from midi_vae_tpu_torch.losses.schedules import kl_weight_schedule
from midi_vae_tpu_torch.models.registry import VQ_ARCHS, build_model
from midi_vae_tpu_torch.models.vae import label_kwarg, param_group_label
from midi_vae_tpu_torch.models.vq import codebook_metrics
from midi_vae_tpu_torch.parallel.collectives import barrier, broadcast_, broadcast_object
from midi_vae_tpu_torch.parallel.mesh import (
    ensure_process_group,
    is_leader,
    make_mesh,
    make_mesh_multislice,
    replicate,
    world_size,
)
from midi_vae_tpu_torch.train.config import TrainConfig
from midi_vae_tpu_torch.train.optim import build_optimizer, scale_lr
from midi_vae_tpu_torch.train.state import (
    create_train_state,
    load_state_dict,
    make_train_step,
    reconcile_ema_state_dict,
    state_dict,
)

def requested_devices(config: TrainConfig, dev: torch.device) -> int:
    """The devices a run asks for: ``num_devices``, else every visible GPU
    (one on the CPU), as the JAX package's ``None`` means every device."""
    if config.num_devices is not None:
        if config.num_devices < 1:
            raise ValueError(f"--num-devices must be >= 1, got {config.num_devices}")
        return config.num_devices
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def build_mesh(config: TrainConfig):
    """The run's mesh over the ranks of the process group, with the JAX
    package's shape errors (``train/loop.py:116-137``)."""
    if config.mesh_slices:
        if config.num_devices is not None:
            if config.num_devices % config.mesh_slices:
                raise ValueError(
                    f"--num-devices {config.num_devices} does not divide into "
                    f"--mesh-slices {config.mesh_slices}"
                )
            return make_mesh_multislice(config.mesh_slices, config.num_devices // config.mesh_slices)
        return make_mesh_multislice(config.mesh_slices)
    return make_mesh(config.num_devices)


def build_run_model(config: TrainConfig, dev: torch.device, *, in_channels: int, seed: int, output_bias=None):
    """The model a run trains, from its resolved config (the conditional
    class count and the VQ objective already settled)."""
    return build_model(
        config.arch,
        in_channels=in_channels,
        latent_dim=config.n_features,
        input_dim=config.image_size,
        hidden_dims=config.hidden_dims,
        dtype=torch.bfloat16 if config.dtype == "bfloat16" else torch.float32,
        fused_reparam=config.fused,
        stem=config.stem,
        head=config.head,
        fold=config.fold,
        verbose=config.verbose,
        remat=config.remat,
        torch_compat=config.torch_compat,
        output_logit_bias=output_bias,
        norm=config.norm,
        num_classes=config.num_classes if config.conditional else 0,
        codebook_size=config.codebook_size,
        vq_decay=config.vq_decay,
        seed=seed,
        device=dev,
    )


def build_run_optimizer(config: TrainConfig, model, global_batch_size: int, total_steps: int):
    """The run's optimizer bundle over ``model``."""
    return build_optimizer(
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


def _with_state(rank0: dict, dev: torch.device) -> dict:
    """Rank 0's results (``parallel/launch.py`` ``train_rank``) with its
    train state rebuilt on ``dev`` from the run's final config."""
    results, config = rank0["results"], TrainConfig.from_dict(rank0["results"]["config"])
    _, _, img_channels = image_dataset_sizes(config.dataset_name)
    model = build_run_model(config, dev, in_channels=img_channels, seed=0)
    n_devices = int(np.prod(results["mesh"]["shape"]))
    bundle = build_run_optimizer(
        config, model, config.batch_size_per_device * n_devices, config.epochs * results["steps_per_epoch"]
    )
    state = create_train_state(model, bundle, ema=config.ema_decay is not None)
    results["state"] = load_state_dict(state, rank0["state_dict"])
    return results


def run(config: TrainConfig, device: DeviceLike = "cuda") -> dict:
    """Run a training job on ``device``; returns the results dict (final
    metrics, counters, the train state, the final config, per-epoch
    history and timings). Outside a process group a run over several
    devices starts one rank each and returns rank 0's results, its state
    rebuilt on ``device``: the same dict as a run on one device."""
    t_run_start = time.time()
    if config.compilation_cache:
        # before any build: what is already built in this process is not cached
        print(f"Persistent compilation cache: {enable_compilation_cache(config.compilation_cache)}")
    dev = resolve_device(device)
    if not dist.is_initialized():
        n = requested_devices(config, dev)
        if config.mesh_slices and n % config.mesh_slices:
            raise ValueError(f"--num-devices {n} does not divide into --mesh-slices {config.mesh_slices}")
        if n > 1:
            from midi_vae_tpu_torch.parallel.launch import spawn, train_rank

            print(f"Starting {n} ranks, one per device")
            return _with_state(spawn(train_rank, n, dev.type, config), dev)
    own_store = mesh = None
    if dist.is_initialized() or config.step_impl == "shard_map" or config.mesh_slices:
        own_store = ensure_process_group(dev)
        mesh = build_mesh(config)
    try:
        return _run(config, dev, mesh, t_run_start)
    finally:
        if own_store is not None:
            dist.destroy_process_group()
            shutil.rmtree(own_store, ignore_errors=True)


def _run(config: TrainConfig, dev: torch.device, mesh, t_run_start: float) -> dict:
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
        # a checkpoint exists as a file or as a complete orbax-backend directory
        if not (os.path.isfile(config.checkpoint_path) or is_orbax_checkpoint(config.checkpoint_path)):
            print(
                "Skipping premature resumption from preemption: no checkpoint file"
                f" found at '{config.checkpoint_path}'"
            )
        else:
            print(f"Loading resumption checkpoint '{config.checkpoint_path}'")
            checkpoint_payload = load_checkpoint(config.checkpoint_path)
            if checkpoint_payload.get("state_format") == FLAX_STATE:
                raise ValueError(
                    f"{config.checkpoint_path} is a JAX package checkpoint: the PyTorch package cannot resume "
                    "its optimizer state (the JAX package cannot resume a port checkpoint either); start from "
                    "its weights with --pretrained instead"
                )
            config = TrainConfig.from_dict(restore_config(config.to_dict(), checkpoint_payload.get("config", {})))
            # keep writing the format resumed from: a file cannot be saved as a directory, nor the reverse
            resumed_backend = "orbax" if is_orbax_checkpoint(config.checkpoint_path) else "msgpack"
            if config.checkpoint_backend != resumed_backend:
                print(f"Note: resumed a {resumed_backend} checkpoint; saves stay {resumed_backend}.")
                config.checkpoint_backend = resumed_backend
    start_epoch = 1 if checkpoint_payload is None else int(checkpoint_payload["epoch"]) + 1

    # MODEL SIZING ===========================================================
    n_class, _, img_channels = image_dataset_sizes(config.dataset_name)
    if config.image_size is None:
        config.image_size = 32
    encoder_config = {"input_size": config.image_size, "n_feature": config.n_features}
    n_devices = 1 if mesh is None else mesh.num_shards
    global_batch_size = config.batch_size_per_device * n_devices
    if mesh is None:
        print(f"One device; global batch size {global_batch_size}")
    else:
        print(
            f"Data-parallel mesh over {n_devices} device(s)"
            + (f" ({config.mesh_slices} slices)" if config.mesh_slices else "")
            + f", {config.step_impl} step; global batch size {global_batch_size}"
        )

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
    if config.seed is None:
        # the loaders' shared order needs one seed on every rank
        seed = broadcast_object(seed)
    if config.conditional and not config.num_classes:
        # resolved once and kept in the config, so the checkpoint rebuilds the
        # same model: the registry's count, else (by-folder datasets) max label + 1
        if n_class and n_class > 0:
            config.num_classes = int(n_class)
        else:
            label_arrays = [
                np.asarray(ds.labels)
                for ds in (dataset_train, dataset_val, dataset_test)
                if getattr(ds, "labels", None) is not None and len(ds.labels)
            ]
            if not label_arrays:
                raise ValueError(
                    f"--conditional needs labels, but dataset '{config.dataset_name}' "
                    "exposes none (streaming corpus without a label table?)"
                )
            config.num_classes = int(max(int(a.max()) for a in label_arrays)) + 1
        print(f"Conditional VAE over {config.num_classes} classes")
    # the VQ models train only under the VQ objective, and it only them
    if config.arch.lower() in VQ_ARCHS:
        if config.loss_type == "elbo":
            config.loss_type = "vq"
            print(f"--model {config.arch}: selecting the VQ objective (loss_type=vq)")
        elif config.loss_type != "vq":
            raise ValueError(f"--model {config.arch} trains with loss_type=vq, not {config.loss_type!r}")
    elif config.loss_type == "vq":
        raise ValueError("loss_type=vq requires a VQ architecture (--model VQVAE|FoldedVQVAE)")
    print(f"loading model '{config.arch}' for '{config.dataset_name}' dataset @ {config.image_size}px")
    model = build_run_model(config, dev, in_channels=img_channels, seed=seed, output_bias=output_bias)
    if mesh is not None:
        replicate(model)  # rank 0's weights on every rank

    loader_kw = dict(device=dev, prefetch=config.prefetch, placement=config.data_placement)
    # rank r's rows of each global batch; the auto step's are its rows of each
    # global micro-batch (train/state.py), the explicit step's one block
    train_rows = eval_rows = None
    if mesh is not None:
        micro = config.grad_accum if config.step_impl == "auto" else 1
        train_rows = mesh.local_rows(global_batch_size, micro)
        eval_rows = mesh.local_rows(global_batch_size)
    loader_train = make_loader(dataset_train, global_batch_size, train=True, seed=seed, rows=train_rows, **loader_kw)
    loader_kw["rows"] = eval_rows
    loader_val = make_loader(dataset_val, global_batch_size, train=False, **loader_kw)
    loader_test = loader_val if not distinct_val_test else make_loader(
        dataset_test, global_batch_size, train=False, **loader_kw
    )

    # OPTIMIZATION ===========================================================
    bundle = build_run_optimizer(config, model, global_batch_size, config.epochs * len(loader_train))
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
    step_kw = dict(
        log_var_clamp=config.log_var_clamp,
        free_bits=config.free_bits,
        pos_weight=pos_weight,
        target_denorm=target_denorm,
        fused_loss=config.fused,
        loss_type=config.loss_type,
        tc_beta=config.tc_beta,
        dataset_size=len(dataset_train),
        grad_accum=config.grad_accum,
        ema_decay=config.ema_decay,
    )
    if config.step_impl == "shard_map":
        from midi_vae_tpu_torch.parallel.spmd import make_spmd_train_step

        train_step = make_spmd_train_step(kl_sched, mesh, **step_kw)
    elif config.step_impl == "auto":
        train_step = make_train_step(kl_sched, mesh=mesh, **step_kw)
    else:
        raise ValueError(f"unknown step_impl: {config.step_impl!r} (auto|shard_map)")
    eval_step = make_eval_step(
        model, target_denorm=target_denorm,
        occupancy_denorm=(tuple(transform_eval.mean), tuple(transform_eval.std)),
    )

    # model forwards by kind over the run: train steps, their forwards (one per
    # micro-batch), reconstruction grids and eval batches (what a caller needs
    # to account for kernel launches)
    forwards = {"train_steps": 0, "train_forwards": 0, "grid": 0, "eval_batches": 0}

    def run_eval(loader, partition_name: str) -> dict:
        """``evaluate`` on the current weights: the EMA averages when tracking is on."""
        forwards["eval_batches"] += len(loader)
        params = state.ema_params if config.ema_decay is not None else None
        return evaluate(loader, model, params, partition_name=partition_name, seed=seed, eval_step=eval_step,
                        mesh=mesh)

    # LOGGING ================================================================
    if config.run_name is None:
        config.run_name = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    if config.run_id is None:
        config.run_id = generate_id()
    config.run_name, config.run_id = broadcast_object((config.run_name, config.run_id))  # rank 0's
    if not config.checkpoint_path and config.models_dir:
        dataset_component = config.dataset_name.replace("/", "_").replace(":", "_")
        config.model_output_dir = os.path.join(config.models_dir, dataset_component, f"{config.run_name}__{config.run_id}")
        latest = CHECKPOINT_LATEST if config.checkpoint_backend == "msgpack" else ORBAX_CHECKPOINT_LATEST
        config.checkpoint_path = os.path.join(config.model_output_dir, latest)
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
        if mesh is not None:  # every rank read the file; rank 0's state is the one kept
            replicate(model)
            if state.ema_params is not None:
                broadcast_(list(state.ema_params.values()))
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
    # the orbax backend's writes are collective: every rank keeps a writer
    if config.async_checkpoint and config.checkpoint_backend == "orbax":
        async_writer = DCPAsyncWriter()
    else:
        async_writer = AsyncCheckpointWriter() if config.async_checkpoint and is_leader() else None
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
            eval_stats.update(codebook_metrics(model))  # VQ models; {} otherwise
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
                    backend=config.checkpoint_backend,
                )
                if async_writer is not None:
                    async_writer.save(config.checkpoint_path, state_dict(state), **save_kwargs)
                else:
                    save_checkpoint(config.checkpoint_path, state_dict(state), **save_kwargs)
                if config.save_best_model and best_stats["best_epoch"] == epoch:
                    if async_writer is not None:
                        async_writer.wait()  # best copies the completed latest file
                    print(f"Copied best model to {copy_best(config.checkpoint_path)}")
                barrier()  # no rank starts an epoch whose checkpoint rank 0 has not handed off
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
    test_stats.update(codebook_metrics(model))  # VQ models; {} otherwise
    is_vq = getattr(model, "latent_kind", "gaussian") == "vq"
    if config.final_iwae and is_vq:
        print("Skipping --final-iwae: the IWAE bound assumes a Gaussian posterior "
              "(VQ-VAE reports reconstruction metrics + codebook perplexity instead)")
    if (config.final_iwae and not is_vq) or config.final_mig:
        # the weights evaluation uses: the EMA averages when tracking is on
        eval_model = model
        if config.ema_decay is not None:
            eval_model = copy.deepcopy(model)
            eval_model.load_state_dict(state.ema_params, strict=False)
        if config.final_iwae and not is_vq:
            # held-out density estimate (nats/sample), against the de-normalised
            # [0, 1] pixels whatever --bce-targets mode trained the run
            test_stats[f"iwae-{config.final_iwae}"] = iwae_bound(
                loader_test, eval_model, k=config.final_iwae, seed=seed,
                target_denorm=(tuple(transform_eval.mean), tuple(transform_eval.std)), mesh=mesh,
            )
            print(f"  {f'iwae-{config.final_iwae} ':.<24s} {test_stats[f'iwae-{config.final_iwae}']:9.5f} nat/sample")
        if config.final_mig and world_size() > 1:
            print("Skipping --final-mig under multi-process SPMD; "
                  "run cli.evaluate --mig on the checkpoint instead")
        elif config.final_mig:
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
    results["mesh"] = None if mesh is None else {"axes": mesh.axis_names, "shape": mesh.shape}
    results["config"] = config.to_dict()
    results["duration_total"] = time.time() - t_run_start
    for ldr in (loader_train, loader_val, loader_test, loader_train_eval):
        if hasattr(ldr, "release"):
            ldr.release()
    logger.close()
    return results


def _warm_start(state, path: str) -> None:
    """--pretrained: parameters (the EMA averages when the checkpoint has
    them) and running statistics from a checkpoint of this package or a
    JAX package ``.msgpack`` one (as the JAX package's warm start, which
    takes ``ema_params or params`` and ``batch_stats``); optimizer and
    counters stay fresh."""
    pre = load_checkpoint(path)
    pre_state = pre.get("state") if isinstance(pre, dict) else None
    if not isinstance(pre_state, dict) or ("model" not in pre_state and pre.get("state_format") != FLAX_STATE):
        raise ValueError(f"--pretrained expects a checkpoint written by this package's or the JAX package's trainer: {path}")
    state.model.load_state_dict(model_weights(pre, state.model))
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
    ``forwards``, when given, counts the epoch's train steps, their
    forwards (``grad_accum`` per step) and reconstruction-grid forwards into
    its ``train_steps``, ``train_forwards`` and ``grid``. The batch labels
    reach the step (and the grid) of a conditional model.

    The loss sum stays on the device; the host reads the device at print
    and log points only. ``stats`` holds the mean loss, the epoch's host
    time by phase (``phase_s``): ``dataloader`` (waiting for the next
    batch), ``device_step`` (issuing the step, and waiting for the device
    at log points), ``logging``, and ``host_syncs``, the epoch's reads of
    device values.

    ``config.scan_steps`` > 1 over a device-resident corpus runs the epoch
    in chunks (:func:`_train_one_epoch_scan`); over a host-fed one it falls
    back to this per-batch path, with the JAX package's message.
    """
    n_epoch = n_epoch if n_epoch is not None else config.epochs
    print_interval = config.print_interval if config.print_interval is not None else config.log_interval
    if (config.scan_steps or 1) > 1:
        if config.step_impl == "shard_map":
            raise ValueError("--scan-steps needs the auto train step (drop --step-impl shard_map)")
        if not hasattr(loader, "epoch_scan"):
            print(
                "--scan-steps: corpus is not device-resident (too large, multi-host, or "
                "--data-placement host); falling back to per-batch dispatch"
            )
        else:
            if config.log_images and epoch == 1:
                print(
                    "--scan-steps: reconstruction grids are skipped in scan mode "
                    "(no per-batch host tensors); use the generate CLI for grids"
                )
            return _train_one_epoch_scan(
                config=config, state=state, train_step=train_step, loader=loader, logger=logger, epoch=epoch,
                epoch_seed=epoch_seed, lr_schedules=lr_schedules, n_samples_seen=n_samples_seen, n_epoch=n_epoch,
                print_interval=print_interval, forwards=forwards,
            )
    num_batches = len(loader)
    world_batch = loader.batch_size
    dev = next(model.parameters()).device
    host_syncs = 0
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
        state, lo, grad_norm = train_step(state, batch.x, epoch_seed, y=batch.y)
        if forwards is not None:
            forwards["train_steps"] += 1
            forwards["train_forwards"] += config.grad_accum
        loss_sum += lo.loss.float()
        n_samples_seen += world_batch
        steps_since_log += 1

        is_print = batch_idx <= 2 or batch_idx % print_interval == 0 or batch_idx >= num_batches - 1
        is_log = batch_idx % config.log_interval == 0
        if epoch <= 1 and batch_idx == 0:
            print("stimuli.shape =", tuple(batch.x.shape))
            print("loss.shape    =", tuple(lo.loss.shape) or "scalar")
            print("loss =", float(lo.loss))
            host_syncs += 1
        if is_print or is_log:
            host_syncs += 1
            step_now = state.step
            loss_f, kld_f, w_f = float(lo.loss), float(lo.kld_loss), float(lo.kld_weight)
            lr_now = {name: float(s(step_now - 1)) for name, s in lr_schedules.items()}
            timer.mark("logging")  # the wait above counts as device_step
            if is_print:
                _print_step(epoch, n_epoch, batch_idx, num_batches, loss_f, kld_f, lr_now, w_f)
            if is_log:
                t_now = time.time()
                throughput = steps_since_log * world_batch / max(t_now - t_last_log, 1e-9)
                t_last_log, steps_since_log = t_now, 0
                row = (loss_f, float(lo.reconstruction_loss), kld_f, w_f, float(grad_norm))
                log_dict = _step_log(epoch, batch_idx, num_batches, n_samples_seen, throughput, row, lr_now,
                                     timer.durations())
                fold_phases()
                timer.reset()
                logger.log(log_dict, step=step_now)
            timer.mark("device_step")  # the rest of the log block, until the next fetch

        # reconstruction grids of the first two batches
        if config.log_images and batch_idx <= 1 and (logger.wandb_run is not None or logger.output_dir):
            _log_reconstruction_grid(logger, model, batch.x, state.step, loader.dataset.transform, y=batch.y)
            if forwards is not None:
                forwards["grid"] += 1

    fold_phases()
    stats = {"loss": float(loss_sum) / num_batches, "phase_s": epoch_phases, "host_syncs": host_syncs + 1}
    return stats, state, state.step, n_samples_seen


def _train_one_epoch_scan(
    *,
    config: TrainConfig,
    state,
    train_step,
    loader,
    logger: MetricLogger,
    epoch: int,
    epoch_seed: int,
    lr_schedules,
    n_samples_seen: int,
    n_epoch: int,
    print_interval: int,
    forwards: Optional[dict],
):
    """The scan-chunked train epoch (counterpart of the JAX package's
    ``_train_one_epoch_scan``): the loader's ``epoch_scan`` issues
    ``config.scan_steps`` steps per chunk and hands back their stacked
    (loss, reconstruction, KL, KL weight, grad norm); the host reads them
    once per chunk. The print and log points of the per-batch epoch fire
    from the read rows; throughput is per chunk (the wall time of a
    row inside a chunk carries no information). The mean loss is the
    per-batch epoch's f32 sum, taken on the host."""
    num_batches = len(loader)
    world_batch = loader.batch_size
    step0 = state.step
    loss_sum = np.float32(0.0)
    t_chunk_start = time.time()
    timer, epoch_phases = PhaseTimer(), {}
    host_syncs = 0
    batch_idx = -1
    timer.mark("device_step")
    for state, ys in loader.epoch_scan(state, train_step, epoch, epoch_seed, chunk=config.scan_steps):
        m = ys.cpu().numpy()  # the chunk's one host sync
        host_syncs += 1
        timer.mark("logging")
        if forwards is not None:
            forwards["train_steps"] += len(m)
            forwards["train_forwards"] += len(m) * config.grad_accum
        t_now = time.time()
        throughput = len(m) * world_batch / max(t_now - t_chunk_start, 1e-9)
        t_chunk_start = t_now
        for row in m:
            batch_idx += 1
            loss_f, recon_f, kld_f, w_f, gn_f = (float(v) for v in row)
            loss_sum = np.float32(loss_sum + row[0])
            n_samples_seen += world_batch
            step_now = step0 + batch_idx + 1
            if epoch <= 1 and batch_idx == 0:
                print(f"scan-chunked training: {config.scan_steps} steps/dispatch")
                print("loss =", loss_f)
            lr_now = {name: float(s(step_now - 1)) for name, s in lr_schedules.items()}
            if batch_idx <= 2 or batch_idx % print_interval == 0 or batch_idx >= num_batches - 1:
                _print_step(epoch, n_epoch, batch_idx, num_batches, loss_f, kld_f, lr_now, w_f)
            if batch_idx % config.log_interval == 0:
                phases = timer.durations()
                for phase, secs in phases.items():
                    epoch_phases[phase] = epoch_phases.get(phase, 0.0) + secs
                timer.reset()
                row = (loss_f, recon_f, kld_f, w_f, gn_f)
                logger.log(_step_log(epoch, batch_idx, num_batches, n_samples_seen, throughput, row, lr_now, phases),
                           step=step_now)
        timer.mark("device_step")
    for phase, secs in timer.durations().items():
        epoch_phases[phase] = epoch_phases.get(phase, 0.0) + secs
    stats = {"loss": float(loss_sum) / num_batches, "phase_s": epoch_phases, "host_syncs": host_syncs}
    return stats, state, state.step, n_samples_seen


def _print_step(epoch: int, n_epoch: int, batch_idx: int, num_batches: int, loss: float, kld: float, lr_now: dict,
                kld_weight: float) -> None:
    lr_print = next(iter(lr_now.values())) if lr_now else 0.0
    print(
        f"Train Epoch:{epoch:4d}/{n_epoch}"
        f"  Step:{batch_idx + 1:4d}/{num_batches}"
        f"  Loss:[F: {loss:6.3f}, KL: {kld:6.3f}]"
        f"  LR: {lr_print:.5f}"
        f"  KL Weight: {kld_weight:.5f}"
    )


def _step_log(epoch: int, batch_idx: int, num_batches: int, n_samples_seen: int, throughput: float, row: tuple,
              lr_now: dict, phases: dict) -> dict:
    """A log point's stepwise metrics: ``row`` is the step's (loss,
    reconstruction, KL, KL weight, grad norm)."""
    log_dict = {
        "training/stepwise/epoch": epoch,
        "training/stepwise/epoch_progress": epoch - 1 + (batch_idx + 1) / num_batches,
        "training/stepwise/n_samples_seen": n_samples_seen,
        "training/stepwise/train/throughput": throughput,
    }
    for key, v in zip(("loss", "loss_recon", "loss_kld", "kld_weight", "grad_norm"), row):
        log_dict[f"training/stepwise/train/{key}"] = v
    for name, v in lr_now.items():
        log_dict[f"training/stepwise/lr-{name}"] = v
    for phase, secs in phases.items():
        log_dict[f"training/stepwise/duration/{phase}"] = secs
    return log_dict


@torch.no_grad()
def _log_reconstruction_grid(logger, model, x, step: int, spec=None, y=None) -> None:
    """Input|reconstruction pairs of up to 8 samples, four pairs a row: to
    wandb when it is on, else a PNG next to the checkpoint. A conditional
    model reconstructs under the labels ``y[:8]``."""
    recon = model(x[:8], train=False, seed=0, **label_kwarg(model, None if y is None else y[:8])).output.float()
    inputs = denormalize(spec, x[:8]) if spec is not None else x[:8]
    grid = reconstruction_grid(inputs, recon).cpu().numpy()
    if logger.wandb_run is not None:
        import wandb

        logger.wandb_run.log({"training/stepwise/train/reconstruction": wandb.Image(grid)}, step=step)
    elif logger.output_dir:
        arr = (np.clip(grid, 0.0, 1.0) * 255).astype(np.uint8)
        write_png(os.path.join(logger.output_dir, f"reconstruction_step{step:06d}.png"), arr)


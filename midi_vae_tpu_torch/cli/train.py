"""Training CLI (counterpart of ``midi_vae_tpu/cli/train.py``).

The same flags, defaults and precedence as the JAX package's CLI: a
``--config`` YAML wins over the CLI's defaults, and a flag typed on the
command line (also as a unique prefix, ``--epoch``) wins over the YAML.
The run is on the GPU (``cuda``) and fails without one; ``--cpu`` runs it
on the CPU. ``--num-devices N`` (default: every visible GPU) trains on N
GPUs, one process each, started here (``parallel/launch.py``); asking for
more GPUs than are visible raises. ``--multihost`` joins the ranks
``torchrun`` started instead, one process per GPU on every host::

    torchrun --nnodes H --nproc-per-node G --rdzv-endpoint HOST:PORT \
        -m midi_vae_tpu_torch.cli.train --multihost --config configs/folded.yaml

``--dataset rrd:PATH`` streams an RRD file through the native threaded
loader, ``--scan-steps N`` runs a device-resident epoch in chunks of N
steps, ``--checkpoint-backend orbax`` writes sharded
``torch.distributed.checkpoint`` directories, ``--pretrained`` also takes
a JAX package ``.msgpack`` checkpoint, and ``--compilation-cache DIR``
keeps every kernel build in DIR. ``--gpu``/``--cpu-workers``/``--no-cuda``
are accepted and inert, as in the JAX package.

Usage::

    python -m midi_vae_tpu_torch.cli.train --config configs/folded.yaml [--fused --bce-targets normalized]
"""

from __future__ import annotations

import argparse
import sys

from midi_vae_tpu_torch.train.config import TrainConfig, from_yaml


def _norm_name(v: str) -> str:
    """--norm validator: batch | batch-subN | group | none (argparse
    ``choices`` can't express the parameterized batch-subN family)."""
    if v in ("batch", "group", "none"):
        return v
    if v.startswith("batch-sub") and v[len("batch-sub"):].isdigit() and int(v[len("batch-sub"):]) >= 2:
        return v
    raise argparse.ArgumentTypeError(
        f"invalid norm {v!r}: expected batch, batch-subN (N>=2, e.g. batch-sub4), group, or none"
    )


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="midi-vae-tpu-torch-train",
        description="Train a MIDI piano-roll VAE with PyTorch on one or more GPUs.",
        add_help=False,
    )
    group = parser.add_argument_group("Help")
    group.add_argument("--help", "-h", action="help", help="Show this help message and exit.")

    # Dataset args (reference train.py:801-852) -------------------------------
    group = parser.add_argument_group("Dataset")
    group.add_argument("--dataset", dest="dataset_name", type=str, default="mnist",
                       help="Name of the dataset to learn. Default: %(default)s")
    group.add_argument("--prototyping", dest="protoval_split_id", nargs="?", const=0, type=int,
                       help="Carve a K-fold validation split out of the train partition; the test"
                            " set is never touched during training. Optional value = split id.")
    group.add_argument("--data-dir", type=str, default=None,
                       help="Directory within which the dataset can be found. Default: ~/Datasets"
                            " (or $MIDI_VAE_DATA_DIR).")
    group.add_argument("--allow-download-dataset", action="store_true",
                       help="Attempt to download the dataset if it is not found locally.")
    group.add_argument("--transform-type", type=str, default="digits",
                       help="Name of transform stack (noaug|midi|digits|pianoroll). Default: %(default)s")
    group.add_argument("--image-size", type=int,
                       help="Size of images to use as model input. Default: 32.")
    group.add_argument("--protoval-split-rate", type=str, default=None,
                       help="Fraction of the train partition carved into the prototyping val fold,"
                            " or 'auto' to size it like the test set. Default: 0.1")

    # Architecture args (train.py:854-879) ------------------------------------
    group = parser.add_argument_group("Architecture")
    group.add_argument("--model", "--encoder", "--arch", "--architecture", dest="arch", type=str,
                       default="VanillaVAE", help="Model architecture name. Default: %(default)s")
    group.add_argument("--stem", type=str, default="conv", choices=("conv", "s2d"),
                       help="Encoder stem: reference stride-2 conv, or space-to-depth fold + "
                            "stride-1 conv (better MXU fill on 1-channel inputs).")
    group.add_argument("--head", type=str, default="deconv", choices=("deconv", "d2s"),
                       help="Decoder head: reference ConvTranspose head, or depth-to-space "
                            "(all head compute at half resolution — avoids the full-resolution "
                            "activation tensors that dominate step time; see RESULTS.md).")
    group.add_argument("--fold", type=int, default=4,
                       help="FoldedVAE input fold factor (power of two). Default: %(default)s")
    group.add_argument("--norm", type=_norm_name, default="batch",
                       help="Conv-block normalization: 'batch' (BatchNorm2d semantics, reference "
                            "parity), 'batch-subN' (BN with training stats from a stride-N batch "
                            "subsample — the round-4 MFU lever, e.g. batch-sub4), 'group' "
                            "(GroupNorm: no running stats, no cross-replica coupling — the "
                            "variant to try if BN's per-block psum shows up in a multi-host "
                            "profile), or 'none' (measured +12.6%% throughput but UNSAFE: "
                            "saturates into the silence attractor — RESULTS.md 'Normalization "
                            "cost'). Default: %(default)s")
    group.add_argument("--remat", action="store_true",
                       help="Rematerialize conv-stack activations in the backward pass "
                            "(torch.utils.checkpoint around the encoder, decoder and head).")
    group.add_argument("--torch-compat", action="store_true",
                       help="Use the reference's exact padding arithmetic and flatten order —"
                            " forward bit-compatible with the torch reference, so weights"
                            " import from it and export back to it (interop/torch_reference.py).")
    group.add_argument("--freeze-encoder", action="store_true")
    group.add_argument("--pretrained", type=str, default=None,
                       help="Warm-start model parameters from an existing checkpoint; optimizer "
                            "state and counters start fresh (fine-tuning — unlike --checkpoint, "
                            "which resumes). EMA weights are preferred when the checkpoint has "
                            "them. A JAX package .msgpack checkpoint works too; for the PyTorch "
                            "reference's state_dict use interop/torch_reference.py.")
    group.add_argument("--n_features", "--latent-dim", dest="n_features", type=int, default=10,
                       help="Latent dimensionality. Default: %(default)s")
    group.add_argument("--hidden-dims", type=int, nargs="+", default=None,
                       help="Encoder channel progression. Default: 32 64 128 256")
    group.add_argument("--conditional", action="store_true",
                       help="Train a conditional VAE (q(z|x,y), p(x|z,y)) over the dataset's "
                            "class labels — class-conditional generation via the generate CLI's "
                            "--label. The class count resolves from the dataset (registry or "
                            "fetched labels) and is stored in the checkpoint config.")

    # Loss args (new surface for C2 options) ----------------------------------
    group = parser.add_argument_group("Loss")
    group.add_argument("--kld-weight", type=float, default=1.0,
                       help="β weight on the KL term. Default: %(default)s (MIDI runs used 2.5e-4)")
    group.add_argument("--kl-schedule", type=str, default="constant",
                       help="KL weight schedule: constant|multiplicative|linear|cyclical")
    group.add_argument("--kl-warmup-steps", type=int, default=1000)
    group.add_argument("--kl-cycle-steps", type=int, default=1000,
                       help="cyclical schedule: full period in steps")
    group.add_argument("--kl-ramp-fraction", type=float, default=0.5,
                       help="cyclical schedule: fraction of each period spent ramping 0->target")
    group.add_argument("--kl-growth", type=float, default=1.005,
                       help="multiplicative schedule: per-step growth factor (models.py:218-219)")
    group.add_argument("--kl-cap", type=float, default=1.0,
                       help="multiplicative schedule: weight ceiling")
    group.add_argument("--log-var-clamp", type=float, nargs=2, default=None, metavar=("MIN", "MAX"),
                       help="Clamp encoder log-variance to [MIN, MAX] in the loss (the option the"
                            " reference left commented out, models.py:210-212).")
    group.add_argument("--free-bits", type=float, default=None,
                       help="Per-dimension KL floor in nats (free bits, Kingma et al. 2016):"
                            " dims below the floor stop contributing KL gradient, preventing"
                            " posterior collapse on sparse corpora. Watch active-units in the"
                            " epoch summaries.")
    group.add_argument("--bce-pos-weight", type=_parse_auto_float, default=None, metavar="W|auto",
                       help="Positive-class weight on the BCE reconstruction term (torch "
                            "BCEWithLogitsLoss pos_weight convention vs the reference's unweighted "
                            "models.py:208). 'auto' = (1-p)/p from the train corpus fill rate — "
                            "the reconstruction-side anti-collapse rebalancer for sparse "
                            "piano-rolls. Default: off (reference parity)")
    group.add_argument("--bce-targets", type=str, default="normalized", choices=("normalized", "raw"),
                       help="BCE target space: 'normalized' = reference parity (BCE against the "
                            "normalized input, targets in [-0.5, 0.5] under the default mean-0.5 "
                            "table); 'raw' de-normalizes targets back to [0, 1] inside the loss — "
                            "true probability space, where --bce-pos-weight and --output-bias-init "
                            "are exact. Default: %(default)s")
    group.add_argument("--output-bias-init", type=_parse_auto_float, default=None, metavar="B|auto",
                       help="Initialize the decoder's output-logit bias to this constant; 'auto' = "
                            "log(p/(1-p)) from the train corpus fill rate, so the decoder starts "
                            "at the corpus base rate instead of the all-0.5 output where ~98%% of "
                            "sparse-corpus cells emit a coherent pull into the silence attractor. "
                            "Default: zeros (reference parity)")

    # Optimization args (train.py:881-932) ------------------------------------
    group = parser.add_argument_group("Optimization routine")
    group.add_argument("--epochs", type=int, default=5,
                       help="Number of epochs to train for. Default: %(default)s")
    group.add_argument("--stop-after-epochs", type=int, default=None,
                       help="Train at most N epochs this invocation, then save and exit (preemption"
                            " simulation / time-budgeted jobs); resume continues toward --epochs.")
    group.add_argument("--final-iwae", type=int, default=None, metavar="K",
                       help="Report the K-sample importance-weighted log-likelihood bound (IWAE, "
                            "nats/sample) on the final test sweep. Default: off")
    group.add_argument("--final-mig", type=int, default=None, metavar="BINS",
                       help="Report the MIG disentanglement score (test posterior means vs dataset "
                            "labels, BINS-bin discretization) on the final test sweep. Default: off")
    group.add_argument("--early-stop-patience", type=int, default=None, metavar="N",
                       help="Stop training when the best-model validation metric hasn't improved "
                            "for N consecutive epochs (counts across resumes via the checkpoint's "
                            "best_epoch). Default: off")
    group.add_argument("--lr", dest="lr_relative", type=float, default=0.01,
                       help="Maximum learning rate, set per 128 batch size; scaled linearly by the"
                            " global batch size. Default: %(default)s")
    group.add_argument("--lr-encoder-mult", type=float, default=1.0,
                       help="Multiplier for encoder learning rate, relative to overall LR.")
    group.add_argument("--lr-decoder-mult", type=float, default=1.0,
                       help="Multiplier for decoder learning rate, relative to overall LR.")
    group.add_argument("--weight-decay", "--wd", dest="weight_decay", type=float, default=0.0,
                       help="Weight decay. Default: %(default)s")
    group.add_argument("--optimizer", type=str, default="AdamW",
                       help="Name of optimizer (AdamW|Adam|SGD|RMSprop|Adagrad|LAMB|Lion).")
    group.add_argument("--scheduler", type=str, default="OneCycle",
                       help="LR scheduler (OneCycle|constant|cosine|step). Default: %(default)s")
    group.add_argument("--grad-accum", type=int, default=1, metavar="N",
                       help="Split each batch into N sequential microbatches inside the compiled "
                            "step (gradients averaged, ONE optimizer update per batch) — cuts peak "
                            "activation memory ~N×. Batch size must be divisible by N. Default: "
                            "%(default)s")
    group.add_argument("--grad-clip", type=float, default=0.0, metavar="NORM",
                       help="Clip the global gradient norm to NORM before each optimizer update "
                            "(the logged grad_norm is the pre-clip value to calibrate against). "
                            "0 = off. Default: %(default)s")
    group.add_argument("--ema-decay", type=float, default=None, metavar="D",
                       help="Track an exponential moving average of the parameters with decay D "
                            "(e.g. 0.999); evaluation and best-model selection then use the "
                            "averaged weights. Default: off")

    # Output checkpoint args (train.py:934-957) --------------------------------
    group = parser.add_argument_group("Output checkpoint")
    group.add_argument("--models-dir", type=str, default="models", metavar="PATH",
                       help="Output directory for all models. Ignored if --checkpoint is set.")
    group.add_argument("--checkpoint", dest="checkpoint_path", default="", type=str, metavar="PATH",
                       help="Save and resume partially trained model state from this checkpoint.")
    group.add_argument("--checkpoint-backend", type=str, default="msgpack",
                       choices=("msgpack", "orbax"),
                       help="Checkpoint format: one atomic file (default; torch.save, named after "
                            "the JAX package's msgpack) or a sharded torch.distributed.checkpoint "
                            "directory that every rank writes its part of (.orbax, the JAX names).")
    group.add_argument("--async-checkpoint", action="store_true",
                       help="Write checkpoints on a background thread (the step loop never "
                            "stalls on serialization; at most one write in flight).")
    group.add_argument("--save-best-model", action="store_true",
                       help="Save a copy of the model with best validation performance.")

    # Reproducibility args (train.py:959-969) ----------------------------------
    group = parser.add_argument_group("Reproducibility")
    group.add_argument("--seed", type=int, help="RNG seed. Default: not controlled")
    group.add_argument("--deterministic", action="store_true",
                       help="Deterministic cuDNN algorithms (the seeds are fixed either way).")
    group.add_argument("--debug-nans", action="store_true",
                       help="Enable autograd anomaly detection (NaN checks in the backward).")
    group.add_argument("--verbose", action="store_true",
                       help="Trace tensor shapes/ranges at each model forward stage "
                            "(printed, one device sync per stage).")
    group.add_argument("--profile-dir", type=str, default=None,
                       help="Write a torch.profiler chrome trace (trace.json) of the first "
                            "--profile-epochs epochs to this directory.")
    group.add_argument("--profile-epochs", type=int, default=1,
                       help="Number of leading epochs to trace. Default: %(default)s")
    group.add_argument("--compilation-cache", type=str, default=None, metavar="DIR",
                       help="Persistent compilation-cache directory: the kernels' builds and Triton's "
                            "and inductor's caches live there, so a restart builds nothing.")

    # Hardware configuration args (train.py:971-1007) --------------------------
    group = parser.add_argument_group("Hardware configuration")
    group.add_argument("--batch-size", dest="batch_size_per_device", type=int, default=128,
                       help="Batch size per device; the global batch is this times the devices. "
                            "Default: %(default)s")
    group.add_argument("--num-devices", type=int, default=None,
                       help="Data-parallel devices, one process each (default: every visible GPU; "
                            "with --cpu, one). More than are visible raises.")
    group.add_argument("--mesh-slices", type=int, default=None,
                       help="Hierarchical multi-slice data parallelism: a (slice, data) mesh of "
                            "this many slices over the devices.")
    group.add_argument("--bf16", dest="bf16", action="store_true",
                       help="Use bfloat16 compute (float32 params).")
    group.add_argument("--loss-type", type=str, default="elbo", choices=("elbo", "beta-tc", "vq"),
                       help="Training objective: plain ELBO, beta-TC-VAE (Chen et al. 2018), or the"
                            " VQ-VAE reconstruction+commitment objective (auto-selected for"
                            " --model VQVAE).")
    group.add_argument("--tc-beta", type=float, default=6.0,
                       help="Total-correlation penalty for --loss-type beta-tc. Default: %(default)s")
    group.add_argument("--codebook-size", type=int, default=512,
                       help="VQ-VAE codebook entries (--model VQVAE). Default: %(default)s")
    group.add_argument("--vq-decay", type=float, default=0.99,
                       help="EMA decay of the VQ codebook statistics. Default: %(default)s")
    group.add_argument("--fused", action="store_true",
                       help="Use the hand-written fused reparameterization + ELBO kernels (K1-K3).")
    group.add_argument("--step-impl", type=str, default="auto", choices=("auto", "shard_map"),
                       help="Train-step partitioning: 'auto' (the one-device step on the global "
                            "batch: BatchNorm over the global batch) or the explicit per-shard step "
                            "(per-shard BatchNorm, one gradient all-reduce).")
    group.add_argument("--prefetch", type=int, default=2,
                       help="Batches whose host→device copy is kept in flight (host loader). "
                            "Default: %(default)s")
    group.add_argument("--scan-steps", type=int, default=1, metavar="N",
                       help="Issue N train steps back to back over the device-resident corpus, "
                            "reading their metrics once per chunk. Default: %(default)s")
    group.add_argument("--data-placement", type=str, default="auto",
                       choices=("auto", "host", "device"),
                       help="Corpus placement: 'auto' uploads corpora that fit the device data "
                            "budget (MIDI_VAE_DEVICE_DATA_BUDGET_MB, default 2048) to the device "
                            "once, and shuffle, gather and transforms run there; 'host' copies "
                            "each batch from pinned host memory on a side stream; 'device' "
                            "forces residency. Default: %(default)s")
    group.add_argument("--multihost", action="store_true",
                       help="Join the ranks torchrun started (one process per GPU, on every host); "
                            "raises without torchrun's environment.")
    group.add_argument("--cpu", dest="force_cpu", action="store_true",
                       help="Run on the CPU instead of the GPU (the kernels' plain PyTorch versions).")
    # accepted-but-inert reference flags, for launch-script compatibility
    group.add_argument("--global-rank", type=int, default=0, help=argparse.SUPPRESS)
    group.add_argument("--gpu", dest="local_rank", default=None, type=int, help=argparse.SUPPRESS)
    group.add_argument("--cpu-workers", "--workers", dest="cpu_workers", type=int, help=argparse.SUPPRESS)
    group.add_argument("--no-cuda", action="store_true", help=argparse.SUPPRESS)

    # Logging args (train.py:1009-1061) ----------------------------------------
    group = parser.add_argument_group("Debugging and logging")
    group.add_argument("--log-interval", type=int, default=10,
                       help="Number of batches between metric logs. Default: %(default)s")
    group.add_argument("--print-interval", type=int, default=None,
                       help="Number of batches between console prints. Default: same as --log-interval.")
    group.add_argument("--log-wandb", action="store_true", help="Log results with Weights & Biases.")
    group.add_argument("--disable-wandb", "--no-wandb", dest="disable_wandb", action="store_true",
                       help="Overrides --log-wandb and ensures wandb is always disabled.")
    group.add_argument("--wandb-entity", type=str)
    group.add_argument("--wandb-project", type=str, default="midi_vae_tpu")
    group.add_argument("--run-name", type=str, default=None)
    group.add_argument("--run-id", type=str, default=None)

    # Config file (makes C14 real) ---------------------------------------------
    group = parser.add_argument_group("Config file")
    group.add_argument("--config", dest="config_yaml", type=str, default=None,
                       help="YAML config file; CLI flags explicitly set override its values.")

    return parser


def _parse_auto_float(value):
    """'auto' stays a string (resolved against the corpus in train/loop.py);
    anything else must parse as a float."""
    if value is None or value == "auto":
        return value
    return float(value)


def args_to_config(args: argparse.Namespace, argv=None) -> TrainConfig:
    """Build a TrainConfig from parsed args (+ optional YAML base)."""
    if args.disable_wandb:
        args.log_wandb = False  # (train.py:1071-1073)

    base = from_yaml(args.config_yaml) if args.config_yaml else TrainConfig()

    # Which flags did the user literally type? Scan the raw argv tokens so an
    # explicit flag overrides YAML even when its value equals the built-in
    # default (e.g. --batch-size 128 on top of a YAML saying 100).
    if argv is None:
        argv = sys.argv[1:]
    explicitly_set = set()
    opt_to_dest = {
        opt: action.dest for action in get_parser()._get_optional_actions() for opt in action.option_strings
    }
    for tok in argv:
        if tok.startswith("--"):
            opt = tok.split("=", 1)[0]
            dest = opt_to_dest.get(opt)
            if dest is None and len(opt) > 2:
                # argparse accepts unique prefix abbreviations (--epoch for
                # --epochs); mirror its resolution so an abbreviated flag
                # still counts as explicitly typed and beats the YAML
                matches = {d for o, d in opt_to_dest.items() if o.startswith(opt)}
                if len(matches) == 1:
                    dest = matches.pop()
            if dest:
                explicitly_set.add(dest)

    config = base
    mapping = dict(
        dataset_name=args.dataset_name,
        protoval_split_id=args.protoval_split_id,
        data_dir=args.data_dir,
        allow_download_dataset=args.allow_download_dataset,
        transform_type=args.transform_type,
        image_size=args.image_size,
        arch=args.arch,
        stem=args.stem,
        head=args.head,
        fold=args.fold,
        norm=args.norm,
        remat=args.remat,
        torch_compat=args.torch_compat,
        pretrained=args.pretrained,
        freeze_encoder=args.freeze_encoder,
        n_features=args.n_features,
        hidden_dims=tuple(args.hidden_dims) if args.hidden_dims else None,
        conditional=args.conditional,
        kld_weight=args.kld_weight,
        kl_schedule=args.kl_schedule,
        kl_warmup_steps=args.kl_warmup_steps,
        kl_cycle_steps=args.kl_cycle_steps,
        kl_ramp_fraction=args.kl_ramp_fraction,
        kl_growth=args.kl_growth,
        kl_cap=args.kl_cap,
        log_var_clamp=tuple(args.log_var_clamp) if args.log_var_clamp else None,
        free_bits=args.free_bits,
        bce_pos_weight=args.bce_pos_weight,
        output_bias_init=args.output_bias_init,
        bce_targets=args.bce_targets,
        protoval_split_rate=_parse_auto_float(args.protoval_split_rate),
        epochs=args.epochs,
        stop_after_epochs=args.stop_after_epochs,
        early_stop_patience=args.early_stop_patience,
        final_iwae=args.final_iwae,
        final_mig=args.final_mig,
        lr_relative=args.lr_relative,
        lr_encoder_mult=args.lr_encoder_mult,
        lr_decoder_mult=args.lr_decoder_mult,
        weight_decay=args.weight_decay,
        optimizer=args.optimizer,
        scheduler=args.scheduler,
        grad_accum=args.grad_accum,
        grad_clip=args.grad_clip,
        ema_decay=args.ema_decay,
        models_dir=args.models_dir,
        checkpoint_path=args.checkpoint_path,
        save_best_model=args.save_best_model,
        async_checkpoint=args.async_checkpoint,
        checkpoint_backend=args.checkpoint_backend,
        seed=args.seed,
        deterministic=args.deterministic,
        debug_nans=args.debug_nans,
        verbose=args.verbose,
        profile_dir=args.profile_dir,
        profile_epochs=args.profile_epochs,
        compilation_cache=args.compilation_cache,
        batch_size_per_device=args.batch_size_per_device,
        num_devices=args.num_devices,
        mesh_slices=args.mesh_slices,
        prefetch=args.prefetch,
        data_placement=args.data_placement,
        scan_steps=args.scan_steps,
        dtype="bfloat16" if args.bf16 else "float32",
        fused=args.fused,
        step_impl=args.step_impl,
        loss_type=args.loss_type,
        tc_beta=args.tc_beta,
        codebook_size=args.codebook_size,
        vq_decay=args.vq_decay,
        log_interval=args.log_interval,
        print_interval=args.print_interval,
        log_wandb=args.log_wandb,
        wandb_entity=args.wandb_entity,
        wandb_project=args.wandb_project,
        run_name=args.run_name,
        run_id=args.run_id,
    )
    for key, value in mapping.items():
        if value is None and getattr(config, key, None) is not None and key not in explicitly_set:
            continue  # keep YAML/default value
        if args.config_yaml and key not in explicitly_set and value == getattr(TrainConfig(), key, object()):
            continue  # YAML wins over CLI defaults
        setattr(config, key, value)

    # prototyping bool derived from split id (train.py:1074-1075)
    config.prototyping = config.protoval_split_id is not None
    return config


def cli(argv=None):
    """Command-line interface for model training; returns ``run``'s results."""
    parser = get_parser()
    args = parser.parse_args(argv)
    if args.no_cuda or getattr(args, "local_rank", None) is not None or args.cpu_workers is not None:
        print("Note: --no-cuda/--gpu/--cpu-workers are accepted but inert; use --cpu for the CPU.")
    device = "cpu" if args.force_cpu else "cuda"
    config = args_to_config(args, argv)

    from midi_vae_tpu_torch.train.loop import run

    if not args.multihost:
        return run(config, device=device)

    import torch.distributed as dist

    from midi_vae_tpu_torch.parallel.mesh import init_from_torchrun

    dev = init_from_torchrun(device)
    print(f"torch.distributed initialized: rank {dist.get_rank()} of {dist.get_world_size()} on {dev}")
    try:
        return run(config, device=dev)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(0 if cli() is not None else 1)

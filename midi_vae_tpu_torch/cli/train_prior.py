"""Train an autoregressive prior over a VQ-VAE checkpoint's code grids
(counterpart of ``midi_vae_tpu/cli/train_prior.py``).

The second stage of the VQ-VAE pipeline: with the VQ-VAE frozen, encode
the train partition to ``[s, s]`` code grids and fit a PixelCNN or a
transformer (``models/prior.py``), or Moonlight-16B-A3B's block of latent
attention and sparse experts (``models/moe_prior.py``; ``--prior-arch
moonlight``, ``--experts-held``; the step adds its balance loss and
updates its routing bias), by maximum likelihood with Adam. The step and
the epoch loop are :func:`make_prior_step` and :func:`train_prior_epoch`,
which the benchmark's driver calls as well. The
result, ``prior_latest.pt`` next to the VQ checkpoint, plugs into
``cli.generate --prior`` and ``serving.server --prior``.

- The ``prior:`` section of a stage-1 config (``--config``) supplies
  defaults; explicit flags win.
- ``--augment-passes N`` adds N encodes of the train partition under the
  train-time transforms (pass p keyed by ``seed + p``).
- The checkpoint (``kind: "vq-code-prior"``, the prior's weights, Adam's
  state and the counters) is written every ``--save-every`` epochs;
  rerunning with the same ``--out`` resumes, and a resumed run reproduces
  an uninterrupted one (epoch-keyed permutations, ``core/rng.py``).
- The code corpus lives on the device; ``--scan-steps`` is the number of
  steps between two reads of their losses by the host (the JAX package's
  scan-chunk length): results are the same for any value.
- ``--bf16`` computes in bfloat16 with f32 parameters and f32 loss math.
- ``metrics.jsonl`` is written under ``prior/`` next to the checkpoint.

Runs on the GPU (``cuda``) and fails without one; ``--cpu`` runs on the
CPU. ``--num-devices N`` trains on N devices, one process each
(``parallel/launch.py``): every rank encodes the corpus, the global batch
is rounded down to a multiple of N (as in the JAX package), each rank
takes its rows of every step's indices, the gradients and the NLL are
mean-reduced over the ranks in one all-reduce, and rank 0 logs and saves.

    python -m midi_vae_tpu_torch.cli.train_prior --config configs/vq16_fold8.yaml --checkpoint CKPT
"""

from __future__ import annotations

import argparse
import os
import sys
import time
import warnings
from typing import Optional

import numpy as np
import torch

PRIOR_LATEST = "prior_latest.pt"

# architecture fields that come from the checkpoint on resume (a changed
# width would make the saved weights unloadable); differing flags warn
RESUME_ARCH_KEYS = ("arch", "features", "layers", "kernel_size", "heads", "experts_held")


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train an autoregressive prior over a VQ-VAE checkpoint's code grids.")
    p.add_argument("--checkpoint", required=True, help="Trained VQ-VAE checkpoint (.pt of this package)")
    p.add_argument("--config", default=None, metavar="YAML",
                   help="Stage-1 config YAML whose `prior:` section supplies defaults for this trainer. "
                        "Explicit CLI flags win.")
    p.add_argument("--out", default=None,
                   help=f"Prior checkpoint path (resumed if it already exists). "
                        f"Default: {PRIOR_LATEST} next to the VQ checkpoint")
    p.add_argument("--dataset", default=None, help="Override the checkpoint's dataset")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--epochs", type=int, default=20, help="TOTAL epochs (a resumed run trains only the remainder)")
    p.add_argument("--batch-size", type=int, default=256,
                   help="Global batch (rounded down to a multiple of --num-devices)")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--prior-arch", choices=("pixelcnn", "transformer", "moonlight"), default="pixelcnn",
                   help="Prior architecture: masked-conv PixelCNN, a decoder-only transformer, or "
                        "Moonlight-16B-A3B's block (latent attention and sparse experts at its published widths; "
                        "--features, --heads and --kernel-size do not apply)")
    p.add_argument("--features", type=int, default=128, help="Prior width (conv features / transformer d_model)")
    p.add_argument("--layers", type=int, default=6, help="Masked-conv layers / transformer blocks / moonlight depth kept")
    p.add_argument("--kernel-size", type=int, default=5, help="PixelCNN only")
    p.add_argument("--heads", type=int, default=4, help="Transformer attention heads")
    p.add_argument("--experts-held", default=None, metavar="LO:HI",
                   help="Moonlight only: the routed experts this device holds of each MoE layer, as one device's "
                        "share under expert parallelism. Tokens route over all experts; the others' part is "
                        "left out. Default: all 64")
    p.add_argument("--conditional", action="store_true",
                   help="Fit a class-conditional prior p(codes | y) from the dataset's labels")
    p.add_argument("--augment-passes", type=int, default=0, metavar="N",
                   help="Extra encode passes of the train partition under the train-time transforms, "
                        "each with fresh shift draws: the code-grid corpus grows (N+1)x")
    p.add_argument("--no-eval", action="store_true",
                   help="Skip the held-out test-partition NLL after training")
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute (f32 parameters and f32 loss math)")
    p.add_argument("--num-devices", type=int, default=None,
                   help="Data-parallel devices, one process each (default: 1)")
    p.add_argument("--scan-steps", type=int, default=16,
                   help="Train steps between two host reads of the losses. 1 = read every step.")
    p.add_argument("--save-every", type=int, default=1, metavar="N",
                   help="Checkpoint the prior (weights + optimizer state + counters) every N epochs. Default: 1")
    p.add_argument("--log-interval", type=int, default=10,
                   help="Stepwise metric cadence (training/stepwise/* every N steps)")
    p.add_argument("--log-wandb", action="store_true")
    p.add_argument("--wandb-entity", default=None)
    p.add_argument("--wandb-project", default="midi_vae_tpu")
    p.add_argument("--run-name", default=None, help="wandb run name (default: prior-<arch>)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true", help="Run on the CPU instead of the GPU")
    return p


def apply_prior_config(args, parser: argparse.ArgumentParser, argv=None):
    """Fold the YAML ``prior:`` section into parsed args as soft defaults:
    a flag typed on the command line (also abbreviated) wins even when its
    value equals the default. Key ``arch`` is ``--prior-arch``; every other
    key must name a parser dest."""
    from midi_vae_tpu_torch.train.config import read_yaml

    section = (read_yaml(args.config) or {}).get("prior") or {}
    if argv is None:
        argv = sys.argv[1:]
    opt_to_dest = {opt: a.dest for a in parser._get_optional_actions() for opt in a.option_strings}
    explicitly_set = set()
    for tok in argv:
        if tok.startswith("--"):
            opt = tok.split("=", 1)[0]
            dest = opt_to_dest.get(opt)
            if dest is None and len(opt) > 2:
                matches = {d for o, d in opt_to_dest.items() if o.startswith(opt)}
                if len(matches) == 1:
                    dest = matches.pop()
            if dest:
                explicitly_set.add(dest)
    for key, value in section.items():
        dest = "prior_arch" if key == "arch" else key
        if not hasattr(args, dest):
            raise SystemExit(f"unknown key in {args.config} prior section: {key!r}")
        if dest not in explicitly_set:
            setattr(args, dest, value)
    return args


def build_prior(arch: str, *, num_codes: int, grid: int, features: int, layers: int, kernel_size: int = 5,
                heads: int = 4, num_classes: int = 0, dtype=torch.float32, seed: int = 0,
                experts_held: Optional[str] = None, widths=None):
    """A code prior by architecture name, initialised from ``seed`` on the
    CPU; one constructor for the trainer and :func:`load_prior`. For
    ``moonlight``: ``layers`` deep, the routed experts ``experts_held``
    ("lo:hi", default all) of each MoE layer, at the published widths
    unless ``widths`` (a ``MoonlightWidths``) says otherwise."""
    from midi_vae_tpu_torch.models.prior import CodePrior, TransformerCodePrior

    gen = torch.Generator().manual_seed(int(seed))
    if arch == "moonlight":
        from midi_vae_tpu_torch.models.moe_prior import MOONLIGHT, MoonlightPrior, parse_held

        w = widths or MOONLIGHT
        held = parse_held(experts_held or f"0:{w.n_routed_experts}", w.n_routed_experts)
        return MoonlightPrior(num_codes=num_codes, num_layers=layers, num_classes=num_classes, dtype=dtype, grid=grid,
                              held=held, widths=w, generator=gen)
    if arch == "pixelcnn":
        return CodePrior(num_codes=num_codes, features=features, num_layers=layers, kernel_size=kernel_size,
                         num_classes=num_classes, dtype=dtype, generator=gen)
    if arch == "transformer":
        return TransformerCodePrior(num_codes=num_codes, features=features, num_layers=layers, num_heads=heads,
                                    num_classes=num_classes, dtype=dtype, grid=grid, generator=gen)
    raise ValueError(f"unknown prior architecture {arch!r}")


def load_prior(path: str, device="cuda"):
    """A trained code prior → (module on ``device``, config). The prior is
    rebuilt in f32 whatever dtype trained it; a checkpoint without ``arch``
    is a PixelCNN."""
    from midi_vae_tpu_torch.core.device import resolve_device
    from midi_vae_tpu_torch.io.checkpoint import load_checkpoint

    payload = load_checkpoint(path)
    pcfg = payload.get("config", {})
    if pcfg.get("kind") != "vq-code-prior":
        raise ValueError(f"{path} is not a VQ code-prior checkpoint (kind={pcfg.get('kind')!r})")
    prior = build_prior(
        str(pcfg.get("arch") or "pixelcnn"), num_codes=int(pcfg["num_codes"]), grid=int(pcfg["grid"]),
        features=int(pcfg["features"]), layers=int(pcfg["layers"]), kernel_size=int(pcfg.get("kernel_size") or 5),
        heads=int(pcfg.get("heads") or 4), num_classes=int(pcfg.get("num_classes") or 0),
        experts_held=pcfg.get("experts_held"),
    )
    prior.load_state_dict(payload["state"]["params"])
    return prior.to(resolve_device(device)), pcfg


def held_out_nll(prior, grids: np.ndarray, labels: Optional[np.ndarray], bs: int) -> float:
    """Mean NLL (nats/position) of a code-grid corpus under ``prior``; the
    ragged tail counts once (per-grid batch means weighted by batch size)."""
    from midi_vae_tpu_torch.models.prior import grid_log_likelihood

    dev = next(prior.parameters()).device
    total, count = 0.0, 0
    with torch.inference_mode():
        for i in range(0, len(grids), bs):
            idx = torch.from_numpy(np.asarray(grids[i:i + bs])).to(dev)
            y = torch.from_numpy(np.asarray(labels[i:i + bs])).to(dev) if labels is not None else None
            total += -float(grid_log_likelihood(prior(idx, y), idx)) * idx.shape[0]
            count += int(idx.shape[0])
    return total / max(count, 1) / (grids.shape[1] * grids.shape[2])


def validate_labels(grids: np.ndarray, labels: Optional[np.ndarray], num_classes: int, partition: str):
    """Drop grids whose labels fall outside ``[0, num_classes)`` (an
    out-of-range label would one-hot to a zero row and evaluate as
    unconditional); returns the filtered ``(grids, labels)``."""
    if labels is None or num_classes <= 0:
        return grids, labels
    ok = (labels >= 0) & (labels < num_classes)
    if not bool(ok.all()):
        dropped = int((~ok).sum())
        print(f"dropping {dropped}/{len(labels)} {partition} grids with labels outside "
              f"[0, {num_classes}) — an out-of-range label would one-hot to a zero row "
              f"and evaluate as unconditional")
        return grids[ok], labels[ok]
    return grids, labels


def make_prior_step(prior, optimizer, grids_dev: torch.Tensor, labels_dev: Optional[torch.Tensor] = None, *,
                    rows_dev: Optional[torch.Tensor] = None, mesh=None):
    """One training step over the device corpus: ``step(sel)`` takes the
    corpus rows ``sel`` of a global batch (this rank's ``rows_dev`` of
    them under a mesh), steps Adam, and returns a device vector: [NLL],
    or for a ``MoonlightPrior`` [NLL, held assignments, the sum over its
    MoE layers of the largest held expert's]. A ``MoonlightPrior``'s loss
    is NLL + α·L_bal (its balance loss), its reported loss the NLL alone,
    and after Adam's step it updates its routing bias from the step's
    loads (mean-reduced over the ranks first)."""
    from midi_vae_tpu_torch.io import tracing
    from midi_vae_tpu_torch.models.moe_prior import BALANCE_ALPHA, MoonlightPrior
    from midi_vae_tpu_torch.models.prior import picked_log_probs, prior_nll
    from midi_vae_tpu_torch.parallel.collectives import psum_mean_

    moe = isinstance(prior, MoonlightPrior)

    def train_step(sel):
        with tracing.span("prior.step"):
            if rows_dev is not None:
                sel = sel[rows_dev]  # this rank's rows of the global batch
            idx = grids_dev[sel]
            y = labels_dev[sel] if labels_dev is not None else None
            optimizer.zero_grad(set_to_none=True)
            if moe:
                logits, aux, loads, held = prior.forward_train(idx, y)
                nll = -torch.mean(picked_log_probs(logits, idx))
                (nll + BALANCE_ALPHA * aux).backward()
            else:
                nll = prior_nll(prior, idx, y)
                nll.backward()
            nll = nll.detach().float().reshape(1)
            if mesh is not None:
                psum_mean_([p.grad for p in prior.parameters() if p.grad is not None] + [nll] + ([loads] if moe else []),
                           mesh.data_group)
            optimizer.step()
            tracing.count("prior.steps", 1)
            if not moe:
                return nll
            prior.update_routing_bias(loads)
            return torch.cat([nll, held.float()])

    return train_step


def train_prior_epoch(train_step, *, n: int, bs: int, seed: int, epoch: int, device, scan_steps: int = 16,
                      max_steps: Optional[int] = None) -> np.ndarray:
    """One epoch of ``train_step`` (:func:`make_prior_step`) over an
    ``n``-grid corpus in batches of ``bs``, in the epoch-keyed order of
    ``host_rng(seed, epoch)`` (a resumed run walks the permutations of an
    uninterrupted one); the host reads the steps' outputs once every
    ``scan_steps`` steps and folds a MoE prior's held counts into the
    counters ``moe.held_assignments`` and ``moe.held_max``. Returns the
    steps' NLLs; ``max_steps`` stops the epoch early."""
    from midi_vae_tpu_torch.core.rng import host_rng
    from midi_vae_tpu_torch.io import tracing

    steps = max(n // bs, 1)
    order = host_rng(seed, epoch).permutation(n)[: steps * bs].reshape(steps, bs)
    steps = steps if max_steps is None else min(steps, max_steps)
    order_dev = torch.from_numpy(order[:steps]).to(device)
    chunk = max(int(scan_steps), 1)
    nlls = []
    for c0 in range(0, steps, chunk):
        out = torch.stack([train_step(order_dev[k]) for k in range(c0, min(c0 + chunk, steps))])
        out = out.float().cpu().numpy()  # the host's one read per chunk
        if out.shape[1] > 1:
            tracing.count("moe.held_assignments", int(round(float(out[:, 1].sum()))))
            tracing.count("moe.held_max", int(round(float(out[:, 2].sum()))))
        nlls.append(out[:, 0])
    return np.concatenate(nlls)


def encode_corpus(model, loader, with_labels: bool = False, epoch: int = 1):
    """The frozen VQ encoder over ``loader.epoch(epoch)`` → [N, s, s] int32
    grids on the host (padding rows dropped); ``with_labels=True`` returns
    ``(grids, labels-or-None)``. ``epoch`` keys the loader's train-time
    transforms, so augment passes draw distinct shifts. The evaluate CLI's
    ``--codes-out`` rides this function."""
    grids, labels = [], []
    with torch.inference_mode():
        for batch in loader.epoch(epoch):
            idx = model.encode_indices(batch.x).cpu().numpy()
            valid = batch.mask.cpu().numpy() > 0
            grids.append(idx[valid])
            if with_labels:
                labels.append(batch.y.cpu().numpy()[valid].astype(np.int32))
    grids = np.concatenate(grids, axis=0)
    if not with_labels:
        return grids
    return grids, (np.concatenate(labels, axis=0) if labels else None)


def cli(argv=None) -> dict:
    """Command-line interface; returns the run's results (``out``, per-epoch
    ``history`` of mean NLLs, ``test_nll``, ``total_step``, the corpus size,
    the batch size and the encode timings)."""
    parser = get_parser()
    args = parser.parse_args(argv)
    if args.config:
        args = apply_prior_config(args, parser, argv)
    if args.experts_held is not None:
        from midi_vae_tpu_torch.models.moe_prior import MOONLIGHT, parse_held

        try:
            parse_held(args.experts_held, MOONLIGHT.n_routed_experts)
        except ValueError as e:
            raise SystemExit(f"--experts-held: {e}") from None
    if args.prior_arch == "transformer" and args.features % args.heads:
        raise SystemExit(f"--features ({args.features}) must be divisible by --heads ({args.heads}) "
                         "for the transformer prior (qkv_features = features)")
    import torch.distributed as dist

    n_dev = args.num_devices or 1
    if n_dev < 1:
        raise SystemExit(f"--num-devices must be >= 1, got {args.num_devices}")
    if n_dev > 1 and not dist.is_initialized():
        from midi_vae_tpu_torch.parallel.launch import spawn

        return spawn(prior_rank, n_dev, "cpu" if args.cpu else "cuda", sys.argv[1:] if argv is None else argv)

    from midi_vae_tpu_torch.cli.generate import _load_model_and_state
    from midi_vae_tpu_torch.core.device import resolve_device
    from midi_vae_tpu_torch.data.fetch import fetch_dataset
    from midi_vae_tpu_torch.data.pipeline import make_loader
    from midi_vae_tpu_torch.data.registry import image_dataset_sizes
    from midi_vae_tpu_torch.data.transforms import VALID_TRANSFORMS, get_transform
    from midi_vae_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
    from midi_vae_tpu_torch.io.logging import MetricLogger, generate_id
    from midi_vae_tpu_torch.parallel.collectives import barrier
    from midi_vae_tpu_torch.parallel.mesh import make_mesh, replicate

    dev = resolve_device("cpu" if args.cpu else "cuda")
    model, cfg, image_size, _, ckpt_dataset = _load_model_and_state(args.checkpoint, device=dev)
    if getattr(model, "latent_kind", "gaussian") != "vq":
        raise SystemExit(
            "the autoregressive prior models DISCRETE code grids; "
            f"this checkpoint is a {type(model).__name__} (Gaussian latent — its prior "
            "is already N(0, I), sample with the generate CLI directly)"
        )
    grid, num_codes = model.last_conv_size, int(model.codebook_size)
    out = args.out or os.path.join(os.path.dirname(os.path.abspath(args.checkpoint)), PRIOR_LATEST)

    resume = None
    if os.path.isfile(out):
        payload = load_checkpoint(out)
        if payload.get("config", {}).get("kind") != "vq-code-prior":
            raise SystemExit(f"{out} exists but is not a VQ code-prior checkpoint")
        resume, rcfg = payload, payload["config"]
        for key in RESUME_ARCH_KEYS:  # num_classes is re-derived below, the checkpoint's winning
            live = args.prior_arch if key == "arch" else getattr(args, key, None)
            if live is not None and rcfg.get(key) is not None and live != rcfg[key]:
                warnings.warn(f"prior {key} differs from the resumed checkpoint: {live} (CLI) vs {rcfg[key]} "
                              "(checkpoint) — the checkpoint wins (same model must continue training)",
                              UserWarning, stacklevel=2)
        args.prior_arch = str(rcfg.get("arch") or "pixelcnn")
        args.features, args.layers = int(rcfg["features"]), int(rcfg["layers"])
        args.kernel_size, args.heads = int(rcfg.get("kernel_size") or 5), int(rcfg.get("heads") or 4)
        args.experts_held = rcfg.get("experts_held")
        if int(rcfg.get("num_classes") or 0) > 0:
            args.conditional = True
        print(f"Resuming prior training from {out} "
              f"(epoch {int(resume.get('epoch', 0))}, step {int(resume.get('total_step', 0))})")
    else:
        print(f"No prior checkpoint at {out} yet; starting fresh")

    # the train partition under eval-condition transforms: the frozen encoder sees clean rolls
    timings = {}
    dataset = args.dataset or ckpt_dataset
    data_dir = args.data_dir or cfg.get("data_dir")
    targs = {"normalization": dataset} if dataset in VALID_TRANSFORMS else {}
    transform_train, transform_eval = get_transform(cfg.get("transform_type", "digits"), image_size, targs)
    fetch_kw = dict(root=data_dir, prototyping=bool(cfg.get("prototyping", False)),
                    protoval_split_id=int(cfg.get("protoval_split_id") or 0), device=dev)
    train, _, test, _ = fetch_dataset(dataset, transform_train=transform_eval, transform_eval=transform_eval,
                                      **fetch_kw)
    t0 = time.perf_counter()
    loader = make_loader(train, min(args.batch_size, len(train)), train=False, device=dev)
    grids, labels = encode_corpus(model, loader, with_labels=True)
    timings["encode_s"] = time.perf_counter() - t0
    print(f"encoded {len(grids)} [{grid}x{grid}] code grids in {timings['encode_s']:.1f}s "
          f"({len(np.unique(grids))} distinct codes in use)")
    if args.augment_passes > 0:
        aug_train, _, _, _ = fetch_dataset(dataset, transform_train=transform_train, transform_eval=transform_eval,
                                           **fetch_kw)
        t0 = time.perf_counter()
        extra_g, extra_l = [grids], [labels]
        for p in range(args.augment_passes):
            aug_loader = make_loader(aug_train, min(args.batch_size, len(aug_train)), train=True,
                                     seed=args.seed + p, device=dev)
            g, lab = encode_corpus(model, aug_loader, with_labels=True, epoch=p + 1)
            extra_g.append(g)
            if labels is not None and lab is not None:
                extra_l.append(lab)
        grids = np.concatenate(extra_g, axis=0)
        labels = np.concatenate(extra_l, axis=0) if labels is not None and len(extra_l) == len(extra_g) else labels
        if labels is not None and len(labels) != len(grids):
            raise SystemExit("an augmentation pass dropped labels; cannot train conditionally "
                             "on a partially-labeled corpus")
        timings["augment_s"] = time.perf_counter() - t0
        print(f"augment passes x{args.augment_passes}: corpus now {len(grids)} grids "
              f"(+{timings['augment_s']:.1f}s encode)")
    test_grids = test_labels = None
    if not args.no_eval and test is not None and len(test) > 0:
        tloader = make_loader(test, min(args.batch_size, len(test)), train=False, device=dev)
        test_grids, test_labels = encode_corpus(model, tloader, with_labels=True)

    num_classes = 0
    if args.conditional:
        if labels is None:
            raise SystemExit(f"--conditional needs labels, but dataset '{dataset}' exposes none")
        if resume is not None and int(resume["config"].get("num_classes") or 0) > 0:
            num_classes = int(resume["config"]["num_classes"])
        else:
            n_class = image_dataset_sizes(dataset)[0]
            num_classes = int(n_class) if n_class and n_class > 0 else int(labels.max()) + 1
        print(f"conditional prior over {num_classes} classes")
        if int(labels.max()) >= num_classes or int(labels.min()) < 0:
            raise SystemExit(
                f"train labels span [{int(labels.min())}, {int(labels.max())}] — outside "
                f"[0, {num_classes}); an out-of-range label one-hots to a zero row and "
                "trains as unconditional. Fix the dataset registry's class count."
            )
        if test_grids is not None and test_labels is not None:
            test_grids, test_labels = validate_labels(test_grids, test_labels, num_classes, "held-out")

    prior = build_prior(
        args.prior_arch, num_codes=num_codes, grid=grid, features=args.features, layers=args.layers,
        kernel_size=args.kernel_size, heads=args.heads, num_classes=num_classes,
        dtype=torch.bfloat16 if args.bf16 else torch.float32, seed=args.seed, experts_held=args.experts_held,
    ).to(dev)
    optimizer = torch.optim.Adam(prior.parameters(), lr=args.lr)
    start_epoch, total_step = 0, 0
    if resume is not None:
        prior.load_state_dict(resume["state"]["params"])
        if "opt_state" in resume["state"]:
            optimizer.load_state_dict(resume["state"]["opt_state"])
        else:
            print("resumed checkpoint has no optimizer state (older format); optimizer restarts fresh")
        start_epoch, total_step = int(resume.get("epoch", 0)), int(resume.get("total_step", 0))

    n = len(grids)
    mesh = make_mesh(n_dev) if dist.is_initialized() else None
    if n < n_dev:
        raise SystemExit(f"corpus has {n} grids but the mesh has {n_dev} devices; reduce --num-devices")
    bs = min(args.batch_size, n)
    bs = max(n_dev, bs - bs % n_dev)  # global batch divisible by the mesh
    rows_dev = None
    if mesh is not None:
        replicate(prior)  # rank 0's weights on every rank
        rows_dev = torch.from_numpy(mesh.local_rows(bs)).to(dev)
        print(f"data-parallel prior training over {n_dev} devices (global batch {bs})")
    grids_dev = torch.from_numpy(grids).long().to(dev)
    labels_dev = torch.from_numpy(labels).long().to(dev) if num_classes else None

    logger = MetricLogger(
        os.path.join(os.path.dirname(os.path.abspath(out)), "prior"),
        use_wandb=args.log_wandb, wandb_entity=args.wandb_entity, wandb_project=args.wandb_project,
        run_name=args.run_name or f"prior-{args.prior_arch}", run_id=generate_id(),
        config={**vars(args), "num_codes": num_codes, "grid": grid},
    )

    def prior_config(final_nll, test_nll):
        return {
            "kind": "vq-code-prior", "arch": args.prior_arch, "num_codes": num_codes, "grid": grid,
            "features": args.features, "layers": args.layers, "kernel_size": args.kernel_size, "heads": args.heads,
            "experts_held": getattr(prior, "held", None) and f"{prior.held[0]}:{prior.held[1]}",
            "num_classes": num_classes, "augment_passes": int(args.augment_passes), "bf16": bool(args.bf16),
            "seed": args.seed, "lr": args.lr, "batch_size": bs, "epochs": args.epochs, "dataset": dataset,
            "vq_checkpoint": os.path.abspath(args.checkpoint), "final_nll": final_nll, "test_nll": test_nll,
        }

    def save(epoch, nll, test_nll=None):
        save_checkpoint(out, {"params": prior.state_dict(), "opt_state": optimizer.state_dict()},
                        config=prior_config(float(nll), test_nll), epoch=epoch, total_step=total_step)
        barrier()  # rank 0 wrote (save_checkpoint writes on rank 0 only)

    train_step = make_prior_step(prior, optimizer, grids_dev, labels_dev, rows_dev=rows_dev, mesh=mesh)
    steps = max(n // bs, 1)
    nll = float(resume["config"].get("final_nll", float("nan"))) if resume else float("nan")
    if start_epoch >= args.epochs:
        print(f"checkpoint already at epoch {start_epoch} >= --epochs {args.epochs}; "
              "skipping training (held-out eval still runs)")
    history = []
    for epoch in range(start_epoch + 1, args.epochs + 1):
        t0 = time.perf_counter()
        epoch_nlls = train_prior_epoch(train_step, n=n, bs=bs, seed=args.seed, epoch=epoch, device=dev,
                                       scan_steps=args.scan_steps)
        for v in epoch_nlls:
            total_step += 1
            if total_step % args.log_interval == 0:
                logger.log({"training/stepwise/nll": float(v), "training/stepwise/epoch": epoch}, total_step)
        duration = time.perf_counter() - t0
        nll = float(epoch_nlls.mean())
        throughput = steps * bs / max(duration, 1e-9)
        history.append({"epoch": epoch, "nll": nll, "duration": duration, "steps": steps})
        print(f"epoch {epoch}/{args.epochs}: nll {nll:.4f} nats/position ({throughput:,.0f} grids/sec)")
        logger.log({f"training/epochwise/{k}": v for k, v in
                    (("nll", nll), ("throughput", throughput), ("duration", duration), ("epoch", epoch))}, total_step)
        if epoch % max(args.save_every, 1) == 0 or epoch == args.epochs:
            save(epoch, nll)

    test_nll = None
    if test_grids is not None and num_classes and test_labels is None:
        print("skipping held-out NLL: conditional prior but the test partition has no labels")
        test_grids = None
    if test_grids is not None and len(test_grids) > 0:
        test_nll = held_out_nll(prior, test_grids, test_labels if num_classes else None,
                                bs=min(bs, len(test_grids)))
        print(f"held-out test nll: {test_nll:.4f} nats/position ({test_nll / np.log(2.0):.4f} bits/code, "
              f"{len(test_grids)} grids; uniform = {np.log(num_codes):.4f} nats)")
        logger.log({"eval/test/nll": test_nll, "eval/test/nll-per-grid": test_nll * grid * grid}, total_step)

    save(max(start_epoch, args.epochs), nll, test_nll)
    logger.close()
    print(f"saved prior to {out}")
    return {"out": out, "history": history, "test_nll": test_nll, "total_step": total_step, "corpus": n,
            "batch_size": bs, "timings": timings}


def prior_rank(rank: int, device, argv) -> dict:
    """One rank of a ``--num-devices`` run (``parallel/launch.py``)."""
    return cli(argv)


def main(argv=None) -> int:
    """Console entry point (``midi-vae-torch-train-prior``): :func:`cli`, whose return value is for
    callers in Python, not an exit status."""
    cli(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())

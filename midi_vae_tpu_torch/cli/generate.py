"""Generation CLI: prior samples, reconstructions, latent interpolations and
traversals from a trained checkpoint, and for VQ-VAE checkpoints samples
and continuations drawn through a trained code prior (counterpart of
``midi_vae_tpu/cli/generate.py``).

Usage::

    python -m midi_vae_tpu_torch.cli.generate --checkpoint CKPT --mode sample -n 16 --out samples.png
    python -m midi_vae_tpu_torch.cli.generate --checkpoint CKPT --mode reconstruct
    python -m midi_vae_tpu_torch.cli.generate --checkpoint CKPT --mode interpolate --steps 8 --slerp
    python -m midi_vae_tpu_torch.cli.generate --checkpoint CKPT --mode sample --export-midi out_dir/
    python -m midi_vae_tpu_torch.cli.generate --checkpoint VQ_CKPT --prior PRIOR [--top-p 0.9] --mode sample
    python -m midi_vae_tpu_torch.cli.generate --checkpoint VQ_CKPT --prior PRIOR --mode continue --keep-cols 8

The model runs on the GPU (``cuda``) and the CLI fails without one;
``--cpu`` runs it on the CPU. Checkpoints are the port's own ``.pt``
files (``io/checkpoint.py``). The model is built from the checkpoint's
config as the JAX package builds it for inference: in f32 whatever
``dtype`` trained it, and without the fused reparameterization, so no
kernel of ``ops/fused_elbo.py`` runs here. A VQ checkpoint's ``--mode
sample`` without ``--prior`` draws codes from the EMA usage marginal;
``--mode continue`` keeps the first ``--keep-cols`` code-grid time columns
of real rolls and lets the prior write the rest. ``--label`` picks the
class of a conditional checkpoint (``--conditional`` run) or of a
class-conditional prior; without it ``--mode sample`` cycles the classes
(one class per grid column) and the other modes use the batch labels.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from midi_vae_tpu_torch.core.device import DeviceLike, resolve_device


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Sample / reconstruct / interpolate from a trained VAE")
    parser.add_argument("--checkpoint", type=str, required=True, help="Checkpoint to load: a .pt file of this package")
    parser.add_argument("--mode", choices=("sample", "reconstruct", "interpolate", "traverse", "continue"), default="sample")
    parser.add_argument("-n", "--num-samples", type=int, default=16)
    parser.add_argument("--steps", type=int, default=8, help="Interpolation steps")
    parser.add_argument("--slerp", action="store_true", help="Spherical instead of linear interpolation")
    parser.add_argument("--dataset", type=str, default=None,
                        help="Dataset for reconstruct/interpolate inputs (default: from checkpoint config)")
    parser.add_argument("--data-dir", type=str, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", type=str, default=None, help="Output PNG path (default: <mode>.png)")
    parser.add_argument("--export-midi", type=str, default=None,
                        help="Directory to also write each generated roll as a .mid file")
    parser.add_argument("--export-threshold", type=str, default=None, metavar="T|auto",
                        help="Binarization threshold for --export-midi note extraction (default 0.1). "
                             "'auto' calibrates it on the checkpoint's own reconstructions of the eval "
                             "partition (midi/calibrate.py)")
    parser.add_argument("--no-ema", action="store_true",
                        help="Use the raw (non-averaged) parameters even when the checkpoint carries EMA "
                             "weights. Default: EMA weights are preferred when present.")
    parser.add_argument("--label", type=int, default=None,
                        help="Conditional checkpoints (--conditional runs) or class-conditional "
                             "code priors (train_prior --conditional): generate this class. "
                             "Default for --mode sample: cycle the classes (one column "
                             "per class in the grid); other modes use the fetched batch labels.")
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU instead of the GPU")
    parser.add_argument("--prior", type=str, default=None,
                        help="VQ-VAE checkpoints, --mode sample/continue: a trained code prior "
                             "(cli/train_prior.py) for ancestral sampling instead of the i.i.d. EMA-marginal draw")
    parser.add_argument("--temperature", type=float, default=1.0,
                        help="Sampling temperature for --prior draws. Default: %(default)s")
    parser.add_argument("--top-p", type=float, default=None, help="Nucleus sampling for --prior draws. Default: off")
    parser.add_argument("--keep-cols", type=int, default=None,
                        help="--mode continue: how many code-grid TIME columns of each input roll to keep "
                             "before the prior writes the rest (default: half the grid)")
    return parser


def _load_model_and_state(checkpoint_path: str, use_ema: bool = True, payload=None, device: DeviceLike = "cuda"):
    """Build the model of a checkpoint on ``device`` and load its weights
    (the EMA averages unless ``use_ema=False``); returns ``(model, config,
    image_size, channels, dataset)``. ``payload``: an already loaded
    checkpoint. The checkpoint may be the port's or a JAX package
    ``.msgpack`` one (its flax weights mapped onto the model). The model computes in f32 and draws z plainly, as the JAX
    package's inference model does, whatever dtype trained it."""
    from midi_vae_tpu_torch.data.registry import image_dataset_sizes
    from midi_vae_tpu_torch.io.checkpoint import has_ema, load_checkpoint, model_weights
    from midi_vae_tpu_torch.models.registry import build_model

    if payload is None:
        payload = load_checkpoint(checkpoint_path)
    cfg = payload.get("config", {})
    enc = payload.get("encoder_config", {})
    image_size = int(enc.get("input_size") or cfg.get("image_size") or 32)
    dataset = cfg.get("dataset_name", "mnist")
    _, _, channels = image_dataset_sizes(dataset)
    model = build_model(
        cfg.get("arch", "VanillaVAE"),
        in_channels=channels,
        latent_dim=int(cfg.get("n_features", 10)),
        input_dim=image_size,
        hidden_dims=tuple(cfg.get("hidden_dims") or (32, 64, 128, 256)),
        # the architecture variants must match the trained weights
        stem=cfg.get("stem", "conv"),
        head=cfg.get("head", "deconv"),
        fold=int(cfg.get("fold", 4)),
        torch_compat=bool(cfg.get("torch_compat", False)),
        norm=cfg.get("norm") or "batch",
        codebook_size=int(cfg.get("codebook_size") or 512),
        vq_decay=float(cfg.get("vq_decay") or 0.99),
        num_classes=int(cfg.get("num_classes") or 0) if cfg.get("conditional") else 0,
        device=device,
    )
    model.load_state_dict(model_weights(payload, model, use_ema))
    if use_ema and has_ema(payload):
        print("Using EMA-averaged weights from the checkpoint (--no-ema for raw)")
    return model, cfg, image_size, channels, dataset


def _fetch_eval_batch(dataset: str, data_dir: Optional[str], image_size: int, n: int, cfg: dict, device):
    """The first ``n`` samples of the test partition under the eval
    transform: ``(x, y, transform_spec)`` on ``device``."""
    from midi_vae_tpu_torch.data.fetch import fetch_dataset
    from midi_vae_tpu_torch.data.pipeline import make_loader
    from midi_vae_tpu_torch.data.transforms import VALID_TRANSFORMS, get_transform

    args = {"normalization": dataset} if dataset in VALID_TRANSFORMS else {}
    _, transform_eval = get_transform(cfg.get("transform_type", "digits"), image_size, args)
    _, _, test, _ = fetch_dataset(
        dataset, root=data_dir, transform_train=transform_eval, transform_eval=transform_eval, device=device
    )
    loader = make_loader(test, min(n, len(test)), train=False, device=device)
    batch = next(iter(loader.epoch(1)))
    return batch.x, batch.y, transform_eval


def _to_grid(images: np.ndarray, cols: int = 8) -> np.ndarray:
    """Tile [N, H, W, C] into one [H', W', C] uint8 image."""
    images = np.clip(np.asarray(images, np.float32), 0.0, 1.0)
    n, h, w, c = images.shape
    cols = min(cols, n)
    rows = -(-n // cols)
    pad = rows * cols - n
    if pad:
        images = np.concatenate([images, np.zeros((pad, h, w, c), images.dtype)])
    grid = images.reshape(rows, cols, h, w, c).transpose(0, 2, 1, 3, 4).reshape(rows * h, cols * w, c)
    return (grid * 255).astype(np.uint8)


def _save_png(grid: np.ndarray, path: str) -> None:
    from midi_vae_tpu_torch.io.logging import write_png

    write_png(path, grid)
    print(f"wrote {path}")


def _export_midi(rolls: np.ndarray, out_dir: str, threshold: float = 0.1) -> list:
    """Write each [H, W, C] roll as ``generated_NNN.mid``; returns the paths."""
    from midi_vae_tpu_torch.midi.derasterize import roll_to_notes
    from midi_vae_tpu_torch.midi.smf import write_smf

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, roll in enumerate(np.asarray(rolls)):
        notes = roll_to_notes(np.clip(roll, 0.0, 1.0), threshold=threshold)
        paths.append(os.path.join(out_dir, f"generated_{i:03d}.mid"))
        write_smf(notes, paths[-1])
    print(f"wrote {len(rolls)} .mid files to {out_dir} (threshold {threshold:g})")
    return paths


def _resolve_export_threshold(args, model, cfg, dataset, data_dir, image_size, seed: int, device, labels_for) -> float:
    """--export-threshold: a fixed float, or 'auto' = calibrated on the
    checkpoint's own reconstructions of the eval partition (midi/calibrate.py)."""
    if args.export_threshold is None:
        return 0.1  # midi/derasterize.py roll_to_notes default
    if args.export_threshold.strip().lower() != "auto":
        return float(args.export_threshold)

    from midi_vae_tpu_torch.data.transforms import denormalize
    from midi_vae_tpu_torch.evaluation.inference import reconstruct
    from midi_vae_tpu_torch.midi.calibrate import calibrate_export_threshold

    n_cal = 256  # enough rolls for stable duration/density histograms
    x, yb, spec = _fetch_eval_batch(dataset, data_dir, image_size, n_cal, cfg, device)
    recon = reconstruct(model, x, seed, y=labels_for(yb, x.shape[0]))
    targets = denormalize(spec, x)[..., 0].cpu().numpy()
    probs = recon[..., 0].float().cpu().numpy()
    best, rows = calibrate_export_threshold(probs, targets)
    fixed = next(r for r in rows if abs(r["threshold"] - 0.1) < 1e-9)
    chosen = next(r for r in rows if r["threshold"] == best)
    print(
        f"calibrated export threshold: {best:g} (JS mean {chosen['js_mean']:.4f}, "
        f"mean note duration {chosen['mean_duration']:.1f} cols) vs fixed 0.1 "
        f"(JS mean {fixed['js_mean']:.4f}, {fixed['mean_duration']:.1f} cols) "
        f"over {len(probs)} reconstructions of '{dataset}'"
    )
    return best


def load_matching_prior(path: str, model, label: Optional[int], device):
    """Load a code prior for ``model`` on ``device``: its geometry must
    match the checkpoint's, and ``label`` its class count. Returns
    ``(prior, number of classes)``."""
    from midi_vae_tpu_torch.cli.train_prior import load_prior

    prior, pcfg = load_prior(path, device=device)
    if int(pcfg["num_codes"]) != int(model.codebook_size) or int(pcfg["grid"]) != model.last_conv_size:
        raise SystemExit(
            f"prior geometry (K={pcfg['num_codes']}, grid={pcfg['grid']}) does not match "
            f"the checkpoint (K={model.codebook_size}, grid={model.last_conv_size})"
        )
    classes = int(pcfg.get("num_classes") or 0)
    if classes > 0 and label is not None and not (0 <= label < classes):
        raise SystemExit(f"--label must be in [0, {classes - 1}] (prior has {classes} classes), got {label}")
    if classes == 0 and label is not None:
        raise SystemExit(
            "--label needs a class-conditional prior (train_prior --conditional); "
            "this prior is unconditional, so the label would be silently ignored"
        )
    return prior, classes


def _prior_images(args, model, dataset, data_dir, image_size, cfg, dev) -> torch.Tensor:
    """Two-stage generation through ``--prior``: ancestral code draws (all
    free in ``sample`` mode; the first ``--keep-cols`` time columns of real
    rolls forced in ``continue`` mode) decoded by the VQ model."""
    from midi_vae_tpu_torch.data.transforms import denormalize
    from midi_vae_tpu_torch.models.prior import sample_codes_autoregressive

    prior, classes = load_matching_prior(args.prior, model, args.label, dev)
    s = model.last_conv_size
    sample_kw = dict(temperature=args.temperature, top_p=args.top_p)
    if args.mode == "sample":
        y = None
        if classes > 0:
            # --label K: every sample class K; default: one class per grid column
            y = (torch.full((args.num_samples,), int(args.label)) if args.label is not None
                 else torch.arange(args.num_samples) % classes)
            print(f"conditional prior sampling: labels {y.tolist()}")
        idx = sample_codes_autoregressive(prior, args.seed, args.num_samples, s, y=y, **sample_kw)
        with torch.inference_mode():
            return model.decode_indices(idx)

    keep = s // 2 if args.keep_cols is None else args.keep_cols
    if not (0 < keep < s):
        raise SystemExit(
            f"--keep-cols must be in [1, {s - 1}] (grid is {s}x{s}; keeping every "
            f"column would be reconstruction, keeping none would be sampling), got {keep}"
        )
    x, yb, spec = _fetch_eval_batch(dataset, data_dir, image_size, args.num_samples, cfg, dev)
    n = int(x.shape[0])
    with torch.inference_mode():
        codes = model.encode_indices(x)
    mask = np.zeros((s, s), bool)
    mask[:, :keep] = True  # grid axis j is time (rolls are [pitch, time])
    y = None
    if classes > 0:
        if args.label is None:
            # dataset labels condition the prior directly: validate them as --label is
            labels = yb[:n].cpu().numpy()
            if labels.size and not ((labels >= 0) & (labels < classes)).all():
                raise SystemExit(
                    f"dataset labels {sorted(set(labels.tolist()) - set(range(classes)))} "
                    f"are outside this prior's class range [0, {classes - 1}]; "
                    "pass --label to condition on a fixed class instead"
                )
        y = torch.full((n,), int(args.label)) if args.label is not None else yb[:n]
    idx = sample_codes_autoregressive(prior, args.seed, n, s, y=y, known=codes, known_mask=mask, **sample_kw)
    with torch.inference_mode():
        cont = model.decode_indices(idx)
    print(f"kept {keep}/{s} code columns = first {keep * image_size // s}/{image_size} roll columns")
    # input | continuation pairs, so the seam is visible
    return torch.stack([denormalize(spec, x), cont], dim=1).reshape(-1, *cont.shape[1:])


def cli(argv=None) -> np.ndarray:
    """Command-line interface; returns the generated images [N, H, W, C]
    (f32, on the host) that the PNG shows."""
    args = get_parser().parse_args(argv)
    # validate the export-threshold spec before paying for generation
    if args.export_threshold is not None:
        if args.export_midi is None:
            raise SystemExit("--export-threshold applies to --export-midi runs only")
        if args.export_threshold.strip().lower() != "auto":
            try:
                t = float(args.export_threshold)
            except ValueError:
                raise SystemExit(
                    f"--export-threshold must be a float in (0, 1) or 'auto', got {args.export_threshold!r}"
                )
            if not (0.0 < t < 1.0):
                raise SystemExit(f"--export-threshold must be in (0, 1), got {t}")
    dev = resolve_device("cpu" if args.cpu else "cuda")

    from midi_vae_tpu_torch.data.transforms import denormalize
    from midi_vae_tpu_torch.evaluation.inference import interpolate, reconstruct, sample_prior, traverse

    model, cfg, image_size, _, ckpt_dataset = _load_model_and_state(args.checkpoint, use_ema=not args.no_ema, device=dev)
    dataset = args.dataset or ckpt_dataset
    data_dir = args.data_dir or cfg.get("data_dir")  # the checkpoint remembers its corpus root
    out_path = args.out or f"{args.mode}.png"
    is_vq = getattr(model, "latent_kind", "gaussian") == "vq"

    conditional = getattr(model, "num_classes", 0) > 0
    if args.label is not None and not (args.prior is not None and args.mode in ("sample", "continue")):
        # with --prior the class may live in the prior instead; load_matching_prior checks it there
        if not conditional:
            raise SystemExit(
                "--label needs a conditional checkpoint (--conditional run); this one is "
                "unconditional, so the label would be silently ignored"
            )
        if not (0 <= args.label < model.num_classes):
            # an out-of-range label one-hots to zeros: garbage decoded without an error
            raise SystemExit(
                f"--label must be in [0, {model.num_classes - 1}] "
                f"(checkpoint has {model.num_classes} classes), got {args.label}"
            )

    def labels_for(y_batch, n):
        """--label wins, else the batch labels (``label_kwarg`` keeps them from unconditional models)."""
        if args.label is not None:
            return torch.full((n,), int(args.label), dtype=torch.long, device=dev)
        return y_batch[:n]

    if args.prior is not None and not (args.mode in ("sample", "continue") and is_vq):
        raise SystemExit("--prior applies to --mode sample/continue on VQVAE checkpoints only")
    if args.mode == "continue" and args.prior is None:
        raise SystemExit(
            "--mode continue needs --prior: a trained code prior writes the "
            "continuation (the EMA marginal has no spatial structure to continue with)"
        )
    if args.keep_cols is not None and args.mode != "continue":
        raise SystemExit("--keep-cols applies to --mode continue only")

    if args.prior is not None:
        images = _prior_images(args, model, dataset, data_dir, image_size, cfg, dev)
    elif args.mode == "sample":
        y = None
        if conditional:
            # --label K: every sample class K; default: one class per grid column
            y = labels_for(None, args.num_samples) if args.label is not None else (
                torch.arange(args.num_samples, device=dev) % model.num_classes)
            print(f"conditional sampling: labels {y.tolist()}")
        images = sample_prior(model, args.num_samples, args.seed, y=y)
    elif args.mode == "reconstruct":
        x, yb, spec = _fetch_eval_batch(dataset, data_dir, image_size, args.num_samples, cfg, dev)
        recon = reconstruct(model, x, args.seed, y=labels_for(yb, x.shape[0]))
        # interleave input | reconstruction pairs
        images = torch.stack([denormalize(spec, x), recon], dim=1).reshape(-1, *recon.shape[1:])
    elif args.mode == "interpolate":
        x, yb, _ = _fetch_eval_batch(dataset, data_dir, image_size, 2, cfg, dev)
        path = interpolate(
            model, x[:1], x[1:2], steps=args.steps, mode="slerp" if args.slerp else "lerp", y=labels_for(yb, 1)
        )
        images = path[:, 0]
    else:  # traverse: one row per latent dimension, varied across ±2.5σ
        if is_vq:
            # the VQ latent is an [s, s, D] grid without a posterior σ
            raise SystemExit(
                "--mode traverse applies to Gaussian-latent models; for a VQVAE "
                "checkpoint use sample/reconstruct/interpolate"
            )
        x, yb, _ = _fetch_eval_batch(dataset, data_dir, image_size, 1, cfg, dev)
        grid_rows = traverse(model, x, steps=args.steps, y=labels_for(yb, 1))
        images = grid_rows.reshape(-1, *grid_rows.shape[2:])

    images = images.float().cpu().numpy()
    # traverse: one grid row per latent dimension (steps columns)
    cols = args.steps if args.mode == "traverse" else 8
    _save_png(_to_grid(images, cols=cols), out_path)
    if args.export_midi:
        threshold = _resolve_export_threshold(
            args, model, cfg, dataset, data_dir, image_size, args.seed + 1, dev, labels_for
        )
        _export_midi(images, args.export_midi, threshold=threshold)
    return images


if __name__ == "__main__":
    cli()

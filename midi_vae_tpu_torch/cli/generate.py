"""Generation CLI: prior samples, reconstructions, latent interpolations and
traversals from a trained checkpoint (counterpart of
``midi_vae_tpu/cli/generate.py``).

Usage::

    python -m midi_vae_tpu_torch.cli.generate --checkpoint CKPT --mode sample -n 16 --out samples.png
    python -m midi_vae_tpu_torch.cli.generate --checkpoint CKPT --mode reconstruct
    python -m midi_vae_tpu_torch.cli.generate --checkpoint CKPT --mode interpolate --steps 8 --slerp
    python -m midi_vae_tpu_torch.cli.generate --checkpoint CKPT --mode sample --export-midi out_dir/

The model runs on the GPU (``cuda``) and the CLI fails without one;
``--cpu`` runs it on the CPU. Checkpoints are the port's own ``.pt``
files (``io/checkpoint.py``). The model is built from the checkpoint's
config as the JAX package builds it for inference: in f32 whatever
``dtype`` trained it, and without the fused reparameterization, so no
kernel of ``ops/fused_elbo.py`` runs here. Not ported yet, each raising
``NotImplementedError`` naming its ROADMAP item: ``--prior``, ``--mode
continue`` and ``--keep-cols`` (item 13, VQ two-stage generation) and
``--label`` (item 17, conditional models).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from midi_vae_tpu_torch.core.device import DeviceLike, resolve_device

_VQ_ARCHS = ("vqvae", "foldedvqvae")


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
                        help="Conditional checkpoints: generate this class (not ported yet, ROADMAP item 17)")
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU instead of the GPU")
    parser.add_argument("--prior", type=str, default=None,
                        help="VQ-VAE checkpoints: a trained code prior (not ported yet, ROADMAP item 13)")
    parser.add_argument("--temperature", type=float, default=1.0,
                        help="Sampling temperature for --prior draws. Default: %(default)s")
    parser.add_argument("--top-p", type=float, default=None, help="Nucleus sampling for --prior draws. Default: off")
    parser.add_argument("--keep-cols", type=int, default=None,
                        help="--mode continue: code-grid time columns to keep (not ported yet, ROADMAP item 13)")
    return parser


def _refuse(gaps) -> None:
    """Raise ``NotImplementedError`` for the first (missing, what, item) gap
    that applies, naming its ROADMAP item (Queue 1)."""
    for missing, what, item in gaps:
        if missing:
            raise NotImplementedError(f"{what} is not ported to the PyTorch package yet (ROADMAP Queue 1 item {item})")


def check_ported(args: argparse.Namespace) -> None:
    """Refuse the flags of features the port does not have yet."""
    _refuse([
        (args.prior is not None, "--prior (two-stage VQ sampling)", 13),
        (args.mode == "continue", "--mode continue", 13),
        (args.keep_cols is not None, "--keep-cols", 13),
        (args.label is not None, "--label (conditional models)", 17),
    ])


def _check_checkpoint_ported(cfg: dict) -> None:
    """Refuse checkpoints of models the port does not have yet."""
    _refuse([
        (str(cfg.get("arch", "")).lower() in _VQ_ARCHS, "a VQ-VAE checkpoint", 12),
        (bool(cfg.get("conditional")), "a conditional checkpoint", 17),
        (bool(cfg.get("torch_compat")), "a torch_compat checkpoint", 17),
        (cfg.get("stem", "conv") != "conv" or cfg.get("head", "deconv") != "deconv", "stem s2d / head d2s", 17),
        ((cfg.get("norm") or "batch") != "batch", f"norm {cfg.get('norm')}", 17),
    ])


def _load_model_and_state(checkpoint_path: str, use_ema: bool = True, payload=None, device: DeviceLike = "cuda"):
    """Build the model of a checkpoint on ``device`` and load its weights
    (the EMA averages unless ``use_ema=False``); returns ``(model, config,
    image_size, channels, dataset)``. ``payload``: an already loaded
    checkpoint. The model computes in f32 and draws z plainly, as the JAX
    package's inference model does, whatever dtype trained it."""
    from midi_vae_tpu_torch.data.registry import image_dataset_sizes
    from midi_vae_tpu_torch.io.checkpoint import load_checkpoint
    from midi_vae_tpu_torch.models.registry import build_model

    if payload is None:
        payload = load_checkpoint(checkpoint_path)
    cfg = payload.get("config", {})
    enc = payload.get("encoder_config", {})
    _check_checkpoint_ported(cfg)
    image_size = int(enc.get("input_size") or cfg.get("image_size") or 32)
    dataset = cfg.get("dataset_name", "mnist")
    _, _, channels = image_dataset_sizes(dataset)
    model = build_model(
        cfg.get("arch", "VanillaVAE"),
        in_channels=channels,
        latent_dim=int(cfg.get("n_features", 10)),
        input_dim=image_size,
        hidden_dims=tuple(cfg.get("hidden_dims") or (32, 64, 128, 256)),
        fold=int(cfg.get("fold", 4)),
        device=device,
    )
    state = payload["state"]
    weights = dict(state["model"])
    if use_ema and state.get("ema_params"):
        weights.update(state["ema_params"])
        print("Using EMA-averaged weights from the checkpoint (--no-ema for raw)")
    model.load_state_dict(weights)
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


def _resolve_export_threshold(args, model, cfg, dataset, data_dir, image_size, seed: int, device) -> float:
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
    x, _, spec = _fetch_eval_batch(dataset, data_dir, image_size, n_cal, cfg, device)
    recon = reconstruct(model, x, seed)
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


def cli(argv=None) -> np.ndarray:
    """Command-line interface; returns the generated images [N, H, W, C]
    (f32, on the host) that the PNG shows."""
    args = get_parser().parse_args(argv)
    check_ported(args)
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

    if args.mode == "sample":
        images = sample_prior(model, args.num_samples, args.seed)
    elif args.mode == "reconstruct":
        x, _, spec = _fetch_eval_batch(dataset, data_dir, image_size, args.num_samples, cfg, dev)
        recon = reconstruct(model, x, args.seed)
        # interleave input | reconstruction pairs
        images = torch.stack([denormalize(spec, x), recon], dim=1).reshape(-1, *recon.shape[1:])
    elif args.mode == "interpolate":
        x, _, _ = _fetch_eval_batch(dataset, data_dir, image_size, 2, cfg, dev)
        path = interpolate(model, x[:1], x[1:2], steps=args.steps, mode="slerp" if args.slerp else "lerp")
        images = path[:, 0]
    else:  # traverse: one row per latent dimension, varied across ±2.5σ
        x, _, _ = _fetch_eval_batch(dataset, data_dir, image_size, 1, cfg, dev)
        grid_rows = traverse(model, x, steps=args.steps)
        images = grid_rows.reshape(-1, *grid_rows.shape[2:])

    images = images.float().cpu().numpy()
    # traverse: one grid row per latent dimension (steps columns)
    cols = args.steps if args.mode == "traverse" else 8
    _save_png(_to_grid(images, cols=cols), out_path)
    if args.export_midi:
        threshold = _resolve_export_threshold(args, model, cfg, dataset, data_dir, image_size, args.seed + 1, dev)
        _export_midi(images, args.export_midi, threshold=threshold)
    return images


if __name__ == "__main__":
    cli()

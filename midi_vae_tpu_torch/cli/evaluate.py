"""Evaluation CLI: the full metric sweep of a trained checkpoint (counterpart
of ``midi_vae_tpu/cli/evaluate.py``).

Usage::

    python -m midi_vae_tpu_torch.cli.evaluate --checkpoint CKPT                     # test partition
    python -m midi_vae_tpu_torch.cli.evaluate --checkpoint CKPT --partition all
    python -m midi_vae_tpu_torch.cli.evaluate --checkpoint CKPT --iwae-samples 16 --mig
    python -m midi_vae_tpu_torch.cli.evaluate --checkpoint CKPT --latents-out z.npz --json results.json

The metrics are the train loop's sweep (``evaluation/evaluate.py``), plus
the IWAE bound (``--iwae-samples``) and MIG (``--mig``) when asked for.
EMA-trained checkpoints evaluate with the averaged weights unless
``--no-ema``. Runs on the GPU and fails without one; ``--cpu`` runs on the
CPU. ``--codes-out`` (VQ code grids) raises ``NotImplementedError``
(ROADMAP item 12).
"""

from __future__ import annotations

import argparse
import json
import math
from typing import Any


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Evaluate a trained VAE checkpoint")
    parser.add_argument("--checkpoint", type=str, required=True, help="Checkpoint to load: a .pt file of this package")
    parser.add_argument("--partition", choices=("test", "val", "train", "all"), default="test",
                        help="Dataset partition(s) to sweep; 'train' uses eval-condition transforms."
                             " Default: %(default)s")
    parser.add_argument("--dataset", type=str, default=None,
                        help="Dataset to evaluate on (default: from checkpoint config)")
    parser.add_argument("--data-dir", type=str, default=None)
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no-ema", action="store_true",
                        help="Use raw (non-averaged) parameters even when the checkpoint carries EMA weights")
    parser.add_argument("--iwae-samples", type=int, default=None, metavar="K",
                        help="Also report the K-sample importance-weighted log-likelihood bound (IWAE, "
                             "nats/sample), against de-normalized [0,1] pixels.")
    parser.add_argument("--mig", action="store_true",
                        help="Also report the Mutual Information Gap of the posterior means against the "
                             "dataset's class labels (NaN for a single-class partition).")
    parser.add_argument("--mig-bins", type=int, default=20, metavar="B",
                        help="Histogram bins per latent dimension for the MIG estimator (default: %(default)s)")
    parser.add_argument("--latents-out", type=str, default=None,
                        help="Also collect per-sample posterior latents and write them to this .npz")
    parser.add_argument("--codes-out", type=str, default=None,
                        help="VQ checkpoints: write code grids (not ported yet, ROADMAP item 12)")
    parser.add_argument("--json", dest="json_out", type=str, default=None,
                        help="Write the results dict as JSON to this path")
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU instead of the GPU")
    return parser


def _stored_split_rate(raw: Any):
    """A checkpoint's stored protoval split rate → fetch_dataset's argument
    ("auto" stays the string; absent means the 0.1 default)."""
    if raw is None:
        return 0.1
    return raw if raw == "auto" else float(raw)


def cli(argv=None) -> dict:
    """Command-line interface; returns the results, partition → metrics."""
    args = get_parser().parse_args(argv)
    if args.codes_out:
        raise NotImplementedError(
            "--codes-out (VQ code grids) is not ported to the PyTorch package yet (ROADMAP Queue 1 item 12)"
        )

    from midi_vae_tpu_torch.cli.generate import _load_model_and_state
    from midi_vae_tpu_torch.core.device import resolve_device
    from midi_vae_tpu_torch.data.fetch import fetch_dataset
    from midi_vae_tpu_torch.data.pipeline import make_loader
    from midi_vae_tpu_torch.data.transforms import VALID_TRANSFORMS, get_transform
    from midi_vae_tpu_torch.evaluation.disentanglement import mig_from_loader
    from midi_vae_tpu_torch.evaluation.evaluate import evaluate, make_eval_step
    from midi_vae_tpu_torch.evaluation.iwae import iwae_bound

    dev = resolve_device("cpu" if args.cpu else "cuda")
    model, cfg, image_size, _, ckpt_dataset = _load_model_and_state(args.checkpoint, use_ema=not args.no_ema, device=dev)
    dataset = args.dataset or ckpt_dataset
    data_dir = args.data_dir or cfg.get("data_dir")
    targs = {"normalization": dataset} if dataset in VALID_TRANSFORMS else {}
    # every partition under eval-condition transforms, train included
    _, transform_eval = get_transform(cfg.get("transform_type", "digits"), image_size, targs)
    train, val, test, distinct = fetch_dataset(
        dataset,
        root=data_dir,
        prototyping=bool(cfg.get("prototyping", False)),
        transform_train=transform_eval,
        transform_eval=transform_eval,
        # the checkpoint's own train/val split: id and rate
        protoval_split_id=int(cfg.get("protoval_split_id") or 0),
        protoval_split_rate=_stored_split_rate(cfg.get("protoval_split_rate")),
        device=dev,
    )

    wanted = ("test", "val", "train") if args.partition == "all" else (args.partition,)
    partitions = []
    for name in wanted:
        if name == "val" and not distinct and "test" in wanted:
            print("val partition is the test set for this dataset (not distinct); skipping duplicate sweep")
            continue
        partitions.append((name, {"test": test, "val": val, "train": train}[name]))

    # one eval step for every partition, with the checkpoint's loss-target semantics
    eval_denorm = (tuple(transform_eval.mean), tuple(transform_eval.std))
    shared_step = make_eval_step(
        model, collect_latents=bool(args.latents_out),
        target_denorm=eval_denorm if cfg.get("bce_targets") == "raw" else None,
        occupancy_denorm=eval_denorm,
    )

    results = {}
    collected = {}
    for name, ds in partitions:
        loader = make_loader(ds, min(args.batch_size, len(ds)), train=False, device=dev)
        out = evaluate(
            loader, model, partition_name=name.capitalize(), seed=args.seed,
            collect_latents=bool(args.latents_out), eval_step=shared_step,
        )
        if args.latents_out:
            collected[name] = out.pop("latents")
        if args.mig:
            mig = mig_from_loader(loader, model, bins=args.mig_bins)
            out["mig"] = mig["mig"]
            top = ", ".join(f"factor{k}→z{int(d)}" for k, d in enumerate(mig["top_dims"]))
            if math.isnan(mig["mig"]):
                print("  mig ................... nan (single-class partition: zero label entropy)")
            else:
                print(f"  {'mig ':.<24s} {mig['mig']:9.5f}  ({top})")
        if args.iwae_samples:
            # the likelihood needs [0, 1] targets: de-normalise with the eval
            # transform's table whatever the checkpoint's loss mode was
            bound = iwae_bound(loader, model, k=args.iwae_samples, seed=args.seed, target_denorm=eval_denorm)
            out[f"iwae-{args.iwae_samples}"] = bound
            print(f"  {f'iwae-{args.iwae_samples} ':.<24s} {bound:9.5f} nat/sample")
        results[name] = out

    if args.latents_out:
        import numpy as np

        np.savez(args.latents_out, **{f"latents_{k}": v for k, v in collected.items()})
        print(f"wrote latents for {list(collected)} to {args.latents_out}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.json_out}")
    return results


if __name__ == "__main__":
    cli()

"""Corpus statistics for the "auto" loss and initialisation settings
(counterpart of ``midi_vae_tpu/data/stats.py``, the same numpy code).

The base rate p is the raw fill rate of the train corpus (mean pixel in
[0, 1], before normalisation):

- ``--output-bias-init auto`` → decoder output bias log(p/(1−p));
- ``--bce-pos-weight auto`` → positive-class weight (1−p)/p.

``python -m midi_vae_tpu_torch.data.stats --dataset NAME [--data-dir DIR]``
is the pre-flight CLI: split sizes, image geometry, class count, and the
fill rate with the settings "auto" would resolve to (on the GPU unless
``--cpu``; only ``pianoroll-synthetic`` computes anything there).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

_P_MIN, _P_MAX = 1e-4, 1.0 - 1e-4


def estimate_base_rate(dataset, max_samples: int = 4096, seed: int = 0) -> float:
    """Mean pixel value in [0, 1] of a row sample of ``dataset``."""
    rng = np.random.default_rng(seed)
    if getattr(dataset, "is_rrd_stream", False):
        from midi_vae_tpu_torch.data.sources import read_rrd

        images, _ = read_rrd(dataset.path, mmap=True)
        rows = dataset.indices
        if len(rows) > max_samples:
            rows = rng.choice(rows, size=max_samples, replace=False)
        sample = images[np.sort(rows)]
    else:
        images = dataset.images
        n = len(images)
        sample = images[np.sort(rng.choice(n, size=max_samples, replace=False))] if n > max_samples else images
    x = sample.astype(np.float64)
    if sample.dtype == np.uint8:
        x = x / 255.0
    return float(np.clip(x.mean(), _P_MIN, _P_MAX))


def base_rate_logit(p: float) -> float:
    """log(p/(1−p)): the constant logit whose sigmoid is the base rate."""
    p = float(np.clip(p, _P_MIN, _P_MAX))
    return float(np.log(p / (1.0 - p)))


def pos_weight_from_base_rate(p: float) -> float:
    """(1−p)/p: equalises the two classes' total BCE mass."""
    p = float(np.clip(p, _P_MIN, _P_MAX))
    return float((1.0 - p) / p)


def resolve_auto(value, dataset, what: str, base_rate: Optional[float] = None) -> Optional[float]:
    """None, a float, or "auto" resolved against the corpus: ``what`` is
    "bias" (:func:`base_rate_logit`) or "pos_weight"
    (:func:`pos_weight_from_base_rate`); pass one shared ``base_rate`` to
    sweep the corpus once."""
    if value is None:
        return None
    if value == "auto":
        p = base_rate if base_rate is not None else estimate_base_rate(dataset)
        out = base_rate_logit(p) if what == "bias" else pos_weight_from_base_rate(p)
        print(f"auto {what}: corpus base rate p={p:.5f} -> {out:.4f}")
        return out
    return float(value)


# ------------------------------------------------------------ pre-flight CLI

_SPARSE_WARN = 0.05  # below this fill rate the silence attractor is live


def _describe(name: str, ds) -> None:
    if getattr(ds, "is_rrd_stream", False):
        shape, dtype = "(rrd stream)", "uint8"
    else:
        shape, dtype = "x".join(map(str, ds.images.shape[1:])), str(ds.images.dtype)
    labels = getattr(ds, "labels", None)
    n_classes = len(np.unique(labels)) if labels is not None and len(np.atleast_1d(labels)) else 0
    print(f"  {name:<6} {len(ds):>8} samples  {shape:>12} {dtype}  {n_classes} classes")


def cli(argv=None) -> None:
    import argparse

    from midi_vae_tpu_torch.core.device import resolve_device
    from midi_vae_tpu_torch.data.fetch import fetch_dataset

    parser = argparse.ArgumentParser(
        prog="python -m midi_vae_tpu_torch.data.stats",
        description="Corpus pre-flight: split sizes, geometry, fill rate, anti-collapse settings.",
    )
    parser.add_argument("--dataset", required=True, help="dataset name (same values cli.train accepts)")
    parser.add_argument("--data-dir", default=None)
    parser.add_argument("--allow-download-dataset", action="store_true")
    parser.add_argument("--max-samples", type=int, default=4096, help="rows sampled for the fill rate")
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU instead of the GPU")
    args = parser.parse_args(argv)

    device = resolve_device("cpu" if args.cpu else "cuda")
    train, val, test, distinct = fetch_dataset(
        args.dataset, root=args.data_dir, download=args.allow_download_dataset, device=device
    )
    print(f"dataset {args.dataset} (val==test: {not distinct})")
    for name, ds in (("train", train), ("val", val), ("test", test)):
        _describe(name, ds)

    p = estimate_base_rate(train, max_samples=args.max_samples)
    print(f"fill rate p = {p:.5f}  ->  --output-bias-init auto = {base_rate_logit(p):.4f}, "
          f"--bce-pos-weight auto = {pos_weight_from_base_rate(p):.2f}")
    if p < _SPARSE_WARN:
        print(f"SPARSE corpus (p < {_SPARSE_WARN}): train with the anti-collapse recipe "
              "--bce-targets raw --output-bias-init auto, and watch eval active-units "
              "(benchmarks/RESULTS.md 'Posterior collapse').")


if __name__ == "__main__":
    cli()

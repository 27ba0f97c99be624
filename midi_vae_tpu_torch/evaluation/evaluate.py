"""Evaluation sweep (counterpart of ``midi_vae_tpu/evaluation/evaluate.py``).

``make_eval_step`` reduces one batch to mask-weighted sums on the device;
``evaluate`` adds them up over the loader on the device and reads them to
the host once, at the end. Metric names and scalings are the JAX
package's:

- ``cross-entropy``: mean binary cross-entropy from the logits against
  the (normalised) input, in nats; ``bce-objective`` the same against the
  de-normalised [0, 1] targets of a ``--bce-targets raw`` run;
- ``mse``, ``mae``: the sigmoid reconstruction against the normalised
  input, ×100;
- ``kl`` (nats per sample) and ``active-units`` (latent dimensions whose
  posterior mean varies by more than 0.01 over the set);
- ``precision``, ``recall``, ``f1`` (×100) of the binary occupancy at 0.5.

The forward samples z as in training (the reference samples in eval
too); batch ``i`` of a sweep draws with ``derive_step_seed(seed, i)``, or
takes an injected ``eps``. A conditional model evaluates under the batch
labels (q(z|x, y)). With ``collect_latents`` the sweep also returns
each real sample's z (``latents`` [N, D], copied to the host per batch).

On a rank of a data-parallel run (``mesh``, and a loader of its rows) the
forward draws its rows of the global batch's noise, and the sums, minima
and maxima are reduced over the data group before the host reads them,
so every rank returns the one-rank sweep's metrics.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

import torch.distributed as dist

from midi_vae_tpu_torch.core.rng import derive_step_seed
from midi_vae_tpu_torch.losses.elbo import bce_from_logits, denormalized_targets
from midi_vae_tpu_torch.models.vae import label_kwarg
from midi_vae_tpu_torch.parallel.collectives import all_reduce_

_SUM = (
    "bce_sum", "bce_raw_sum", "mse_sum", "mae_sum", "n_elem", "n_samples",
    "kl_dim_sum", "mu_sum", "mu_sq_sum", "occ_tp", "occ_fp", "occ_fn",
)
_MIN = ("stim_min", "recon_min")
_MAX = ("stim_max", "recon_max")


def make_eval_step(model, collect_latents: bool = False, target_denorm=None, occupancy_denorm=None) -> Callable:
    """Build ``eval_step(x, mask, seed, *, y=None, params=None, eps=None,
    rows=None) → dict of device tensors``; ``y`` reaches conditional models
    only, ``rows`` the model's reparameterization.

    ``params`` replaces the model's parameters for this call (name →
    tensor, e.g. the EMA averages; BatchNorm statistics stay the model's).
    ``eps`` replaces the reparameterization draw. ``target_denorm`` adds
    ``bce_raw_sum``; ``occupancy_denorm`` (the eval transform's mean and
    std) adds the occupancy counts. ``collect_latents`` adds ``latents``,
    the batch's z [B, D]; the step carries its options as attributes, so
    :func:`evaluate` can tell what a step passed to it provides.
    """

    @torch.no_grad()
    def eval_step(x, mask, seed: int, *, y=None, params=None, eps=None, rows=None) -> Dict[str, torch.Tensor]:
        kwargs = dict(train=False, seed=seed, eps=eps, rows=rows, **label_kwarg(model, y))
        if params is None:
            out = model(x, **kwargs)
        else:
            out = torch.func.functional_call(model, params, (x,), kwargs)
        mask = mask.float()
        m = mask.reshape(-1, 1, 1, 1)
        valid = m > 0
        recon = out.output.float()
        res = {
            "bce_sum": torch.sum(bce_from_logits(out.logits, x) * m),
            "mse_sum": torch.sum(torch.square(recon - x) * m),
        }
        if target_denorm is not None:
            res["bce_raw_sum"] = torch.sum(bce_from_logits(out.logits, denormalized_targets(x, target_denorm)) * m)
        if occupancy_denorm is not None:
            t = denormalized_targets(x, occupancy_denorm) > 0.5
            p = recon > 0.5
            res["occ_tp"] = torch.sum(p & t & valid)
            res["occ_fp"] = torch.sum(p & ~t & valid)
            res["occ_fn"] = torch.sum(~p & t & valid)
        mu, lv = out.encoded.mu.float(), out.encoded.log_var.float()
        mv = mask.reshape(-1, 1)
        inf = x.new_full((), float("inf"))  # a fill on the device, no copy from the host
        res |= {
            "mae_sum": torch.sum(torch.abs(recon - x) * m),
            "n_elem": torch.sum(mask) * float(np.prod(x.shape[1:])),
            "n_samples": torch.sum(mask),
            "stim_min": torch.min(torch.where(valid, x, inf)),
            "stim_max": torch.max(torch.where(valid, x, -inf)),
            "recon_min": torch.min(torch.where(valid, recon, inf)),
            "recon_max": torch.max(torch.where(valid, recon, -inf)),
            "kl_dim_sum": torch.sum(-0.5 * (1.0 + lv - torch.square(mu) - torch.exp(lv)) * mv, dim=0),
            "mu_sum": torch.sum(mu * mv, dim=0),
            "mu_sq_sum": torch.sum(torch.square(mu) * mv, dim=0),
        }
        if collect_latents:
            res["latents"] = out.latents
        return res

    eval_step.collect_latents = collect_latents
    eval_step.target_denorm = target_denorm
    eval_step.occupancy_denorm = occupancy_denorm
    return eval_step


def evaluate(
    loader,
    model,
    params: Optional[Dict[str, torch.Tensor]] = None,
    *,
    partition_name: str = "Val",
    seed: int = 0,
    verbosity: int = 1,
    collect_latents: bool = False,
    eval_step: Optional[Callable] = None,
    mesh=None,
) -> Dict[str, float]:
    """Full-dataset metric sweep over ``loader.epoch(1)``; ``params``
    replaces the model's parameters (the EMA averages). Returns the metrics
    named in the module docstring and ``count``, and with
    ``collect_latents`` ``latents`` (a passed ``eval_step`` that does not
    collect them is rebuilt with its target options). ``mesh``: this rank's
    mesh, for a loader of its rows (see the module docstring)."""
    if collect_latents and mesh is not None:
        raise ValueError("collect_latents gathers one rank's latents only; sweep on one rank")
    if collect_latents and not getattr(eval_step, "collect_latents", False):
        step_fn = make_eval_step(
            model, collect_latents=True,
            target_denorm=getattr(eval_step, "target_denorm", None),
            occupancy_denorm=getattr(eval_step, "occupancy_denorm", None),
        )
    else:
        step_fn = eval_step if eval_step is not None else make_eval_step(model)
    acc = None
    latents = []
    for i, batch in enumerate(loader.epoch(1)):
        # a rank draws its block of the global batch's noise (Mesh.local_rows)
        b = batch.x.shape[0]
        rows = None if mesh is None else (mesh.shard_index * b, mesh.num_shards * b)
        res = step_fn(batch.x, batch.mask, derive_step_seed(seed, i), y=batch.y, params=params, rows=rows)
        z = res.pop("latents", None)
        if collect_latents:
            latents.append(z[batch.mask > 0].float().cpu().numpy())
        if acc is None:
            acc = dict(res)
            continue
        for k in _SUM:
            if k in res:
                acc[k] = acc[k] + res[k]
        for k in _MIN:
            acc[k] = torch.minimum(acc[k], res[k])
        for k in _MAX:
            acc[k] = torch.maximum(acc[k], res[k])
    if acc is None:
        raise ValueError("empty evaluation stream")
    if mesh is not None:
        group = mesh.data_group
        all_reduce_([acc[k] for k in _SUM if k in acc], group)
        all_reduce_([acc[k] for k in _MIN], group, dist.ReduceOp.MIN)
        all_reduce_([acc[k] for k in _MAX], group, dist.ReduceOp.MAX)
    totals = {k: v.double().cpu().numpy() for k, v in acc.items()}  # the sweep's one host read

    if verbosity >= 1:
        print(f"input has range  [{float(totals['stim_min']):.03f}, {float(totals['stim_max']):.03f}]")
        print(f"output has range [{float(totals['recon_min']):.03f}, {float(totals['recon_max']):.03f}]")
    n_elem = max(float(totals["n_elem"]), 1.0)
    n = max(float(totals["n_samples"]), 1.0)
    mu_var = totals["mu_sq_sum"] / n - np.square(totals["mu_sum"] / n)
    results: Dict[str, float] = {
        "count": int(totals["n_samples"]),
        "cross-entropy": float(totals["bce_sum"]) / n_elem,
        "mse": 100.0 * float(totals["mse_sum"]) / n_elem,
        "mae": 100.0 * float(totals["mae_sum"]) / n_elem,
        "kl": float(np.sum(totals["kl_dim_sum"]) / n),
        "active-units": int(np.sum(mu_var > 0.01)),
    }
    if "bce_raw_sum" in totals:
        results["bce-objective"] = float(totals["bce_raw_sum"]) / n_elem
    if "occ_tp" in totals:
        tp, fp, fn = (float(totals[k]) for k in ("occ_tp", "occ_fp", "occ_fn"))
        precision = tp / (tp + fp) if tp + fp else 0.0
        recall = tp / (tp + fn) if tp + fn else 0.0
        results["precision"] = 100.0 * precision
        results["recall"] = 100.0 * recall
        results["f1"] = 100.0 * 2.0 * precision * recall / (precision + recall) if precision + recall else 0.0
    if collect_latents:
        results["latents"] = np.concatenate(latents)

    if verbosity >= 1:
        print(f"\n{partition_name} evaluation results:")
        for k, v in results.items():
            if k == "latents":
                continue
            if "count" in k or "units" in k:
                print(f"  {k + ' ':.<21s}{v:7d}")
            elif "entropy" in k or k in ("kl", "bce-objective"):
                print(f"  {k + ' ':.<24s} {v:9.5f} nat")
            else:
                print(f"  {k + ' ':.<24s} {v:6.2f} %")
    return results

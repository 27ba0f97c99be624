"""The port's side of a held training run, without JAX: the seeded initial
weights, the replay of a JAX run's draws through the port's train loop,
and the comparison of two runs' ``metrics.jsonl`` rows.

``tests/torch_trajectory.py`` (the CPU harness, which records the JAX
run) and ``chip_smoke.py`` ``trajectory_phase`` (which replays the
committed JAX fixture ``trajectory_folded_fold8.npz`` on the card, where
there is no JAX) both use it.

**Initial weights.** A flax-layout ``params``/``batch_stats`` tree drawn
from a seed with numpy alone, so that every side rebuilds the same arrays
from the leaves' paths and shapes. Only uniform doubles are drawn
(``Generator.random``); the fixture stores :func:`checksum` of the
flagship's init so that a card run can tell a changed stream from a
diverged run. By leaf name (the last path component): ``kernel``
Xavier-uniform, ±sqrt(6/(fan_in + fan_out)) with flax's fans (receptive
field × in, receptive field × out); ``bias`` and ``mean`` uniform ±0.1;
``scale`` 1 ± 0.1; ``var`` uniform in [0.5, 1.5]; anything else (a VQ
quantizer's codebook and sums) is not drawn and the caller keeps its own
value. Leaves are drawn in the sorted order of their
"collection/a/b/leaf" paths.

**Replay.** :func:`port_replayers` wraps the port loop's
``make_train_step`` and ``make_eval_step`` so that each step takes the
next recorded draw as its ``eps`` (a list per micro-batch under
``grad_accum``); :func:`port_aug_replayer` stands in for
``augment_pianoroll_batch`` with given per-sample draws. Install them
over the names of ``midi_vae_tpu_torch.train.loop`` and
``midi_vae_tpu_torch.midi.rasterize`` for one run.

**The f64 step.** :func:`f64_step_terms` recomputes a train step in f64
on a copy of the model: the yardstick for a step whose two f32 runs
disagree.
"""

from __future__ import annotations

import contextlib
import copy
import functools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from midi_vae_tpu_torch.interop.from_jax import flax_name_map, to_flax_layout

DRAWN = ("kernel", "bias", "scale", "mean", "var")
# keys only the port's epochwise rows carry (a chosen difference, ROADMAP Queue 3)
PORT_ONLY_KEYS = ("training/epochwise/train/host_syncs", "training/epochwise/train/phase_s")
# wall-clock keys: compared by presence only
WALL_CLOCK = ("/throughput", "/duration/")


# ------------------------------------------------------------------ initial weights


def init_leaves(shapes: Dict[str, Tuple[int, ...]], seed: int) -> Dict[str, np.ndarray]:
    """``{"params/Encoder_0/Conv_0/kernel": shape, ...}`` → f32 arrays for
    the drawn leaves (see the module docstring); other paths are left out."""
    rng = np.random.default_rng(seed)
    out = {}
    for path in sorted(shapes):
        shape, leaf = tuple(shapes[path]), path.rsplit("/", 1)[-1]
        if leaf not in DRAWN:
            continue
        u = rng.random(shape)  # [0, 1)
        if leaf == "kernel":
            receptive = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
            fan_in, fan_out = receptive * shape[-2], receptive * shape[-1]
            v = (2.0 * u - 1.0) * np.sqrt(6.0 / (fan_in + fan_out))
        elif leaf in ("bias", "mean"):
            v = (2.0 * u - 1.0) * 0.1
        elif leaf == "scale":
            v = 1.0 + (2.0 * u - 1.0) * 0.1
        else:  # var
            v = 0.5 + u
        out[path] = v.astype(np.float32)
    return out


def checksum(leaves: Dict[str, np.ndarray]) -> float:
    """Σ over the leaves of Σ|v| in f64: one number that moves with any leaf."""
    return float(sum(np.abs(leaves[k].astype(np.float64)).sum() for k in sorted(leaves)))


def port_shapes(model) -> Dict[str, Tuple[int, ...]]:
    """A port model's leaves as flax paths and flax-layout shapes."""
    shapes = {}
    for name, (collection, path) in flax_name_map(model).items():
        shapes["/".join((collection,) + path)] = to_flax_layout(model, name, model.state_dict()[name]).shape
    return shapes


def nest(leaves: Dict[str, np.ndarray]) -> Dict[str, dict]:
    """Flat "collection/a/b/leaf" paths → ``{collection: nested dict}``."""
    out: Dict[str, dict] = {}
    for path, v in leaves.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def leaf_stats(model) -> Dict[str, Tuple[float, float]]:
    """Each leaf of a port model (flax path) → (sum, L2 norm) in f64."""
    out = {}
    for name, (collection, path) in flax_name_map(model).items():
        v = to_flax_layout(model, name, model.state_dict()[name]).astype(np.float64)
        out["/".join((collection,) + path)] = (float(v.sum()), float(np.sqrt((v * v).sum())))
    return out


# ------------------------------------------------------------------ replay


@dataclass
class Draws:
    """A JAX run's draws in the order its loop made them: ``train`` one
    entry per step (a list of one array per micro-batch, None for a VQ
    model), ``eval`` one list per evaluation sweep of one array per batch
    (empty lists for a VQ model)."""

    train: List[Optional[List[np.ndarray]]] = field(default_factory=list)
    eval: List[List[np.ndarray]] = field(default_factory=list)


def _gaussian(model) -> bool:
    return getattr(model, "latent_kind", "gaussian") != "vq"


def port_replayers(draws: Draws, make_train_step: Callable, make_eval_step: Callable, device="cpu"):
    """Wrappers of the port loop's ``make_train_step`` and ``make_eval_step``
    (passed in) whose steps take the next of ``draws`` as their ``eps``;
    each wrapper's ``.used`` counts the draws it replayed."""
    train_it, eval_it = iter(draws.train), iter([d for sweep in draws.eval for d in sweep])

    def make_train_step_replayed(kl_schedule, **kw):
        step = make_train_step(kl_schedule, **kw)

        def replayed(state, x, epoch_seed, *, y=None, eps=None):
            draw = next(train_it)
            make_train_step_replayed.used += 1
            if draw is not None:
                parts = [torch.from_numpy(d).to(device) for d in draw]
                eps = parts[0] if len(parts) == 1 else parts
            return step(state, x, epoch_seed, y=y, eps=eps)

        return replayed

    def make_eval_step_replayed(model, **kw):
        step = make_eval_step(model, **kw)

        def replayed(x, mask, seed, *, eps=None, **rest):
            if _gaussian(model):
                eps = torch.from_numpy(next(eval_it)).to(device)
                make_eval_step_replayed.used += 1
            return step(x, mask, seed, eps=eps, **rest)

        functools.update_wrapper(replayed, step)
        return replayed

    make_train_step_replayed.used = make_eval_step_replayed.used = 0
    return make_train_step_replayed, make_eval_step_replayed


def port_aug_replayer(augment: Callable, draws_of: Callable):
    """A stand-in for the port's ``augment_pianoroll_batch`` (``augment``)
    that applies ``draws_of(k, batch)`` = (pitch shifts, time shifts,
    velocity scales) at its k-th call; ``.calls`` counts the calls."""

    def replayed(rolls, *, generator=None, max_pitch_shift=6, max_time_shift=16, velocity_scale=(0.7, 1.2),
                 rows=None, **kw):
        dps, dts, scales = draws_of(replayed.calls, rolls.shape[0])
        replayed.calls += 1
        dev = rolls.device
        return augment(rolls, pitch_shift=torch.as_tensor(np.asarray(dps), device=dev),
                       time_shift=torch.as_tensor(np.asarray(dts), device=dev),
                       scale=torch.as_tensor(np.asarray(scales, np.float32), device=dev),
                       max_pitch_shift=max_pitch_shift, max_time_shift=max_time_shift, velocity_scale=velocity_scale)

    replayed.calls = 0
    return replayed


# ------------------------------------------------------------------ rows


def row_errors(got_rows: List[dict], want_rows: List[dict], *, step_rtol: float, step_atol: float,
               eval_rtol: float, eval_atol: float,
               key_rtol: Optional[Dict[str, float]] = None) -> Tuple[List[str], Dict[str, float]]:
    """Two runs' ``metrics.jsonl`` rows, key for key: ``got_rows`` (the
    port's) less :data:`PORT_ONLY_KEYS` carry ``want_rows``' keys; wall-clock
    values are compared by presence, ints and strings exactly, stepwise
    values (``training/stepwise/...``) within ``step_rtol``/``step_atol``
    (or ``key_rtol[name]`` for a key ending in ``/name``), the rest within
    ``eval_rtol``/``eval_atol``. Returns the mismatches and each float
    key's largest relative error."""
    errors, worst = [], {}
    if len(got_rows) != len(want_rows):
        return [f"{len(got_rows)} rows, expected {len(want_rows)}"], worst
    for i, (got, want) in enumerate(zip(got_rows, want_rows)):
        got = {k: v for k, v in got.items() if k not in PORT_ONLY_KEYS}
        if sorted(got) != sorted(want):
            errors.append(f"row {i}: keys differ by {sorted(set(got) ^ set(want))}")
            continue
        for key, v in want.items():
            if any(w in key for w in WALL_CLOCK):
                continue
            what = f"row {i} (step {want['step']}): {key}: {got[key]!r}, expected {v!r}"
            if isinstance(v, (int, str)) or v is None:
                if got[key] != v:
                    errors.append(what)
                continue
            rtol, atol = (step_rtol, step_atol) if key.startswith("training/stepwise/") else (eval_rtol, eval_atol)
            if key.startswith("training/stepwise/") and key_rtol:
                rtol = key_rtol.get(key.rsplit("/", 1)[-1], rtol)
            diff = abs(float(got[key]) - float(v))
            worst[key] = max(worst.get(key, 0.0), diff / max(abs(float(v)), 1e-30))
            if not diff <= atol + rtol * abs(float(v)):
                errors.append(what)
    return errors, worst


# ------------------------------------------------------------------ the f64 step


@contextlib.contextmanager
def _keep_f64():
    """The model and the loss cast to f32 with ``.float()``; here it keeps f64."""
    real = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double
    try:
        yield
    finally:
        torch.Tensor.float = real


def f64_step_terms(model, x: torch.Tensor, eps: torch.Tensor, kl_weight: float, loss_fn: Callable) -> List[float]:
    """(loss, reconstruction, KL loss, global grad norm) of one train step
    of ``model`` on ``x`` with the draw ``eps``, recomputed in f64 on a
    copy (``model`` is not touched): every layer's compute dtype and every
    ``.float()`` of the forward and ``loss_fn`` become f64."""
    m = copy.deepcopy(model).double()
    for module in m.modules():
        if getattr(module, "dtype", None) in (torch.float32, torch.bfloat16):
            module.dtype = torch.float64
    with _keep_f64():
        lo = loss_fn(m(x.double(), train=True, eps=eps.double()), kl_weight)
        lo.loss.backward()
        norm = torch.sqrt(sum((p.grad.double() ** 2).sum() for p in m.parameters() if p.grad is not None))
    return [float(v.detach()) for v in (lo.loss, lo.reconstruction_loss, lo.kld_loss, norm)]

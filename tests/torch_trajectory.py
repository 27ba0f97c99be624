"""Whole training runs of the JAX package and the PyTorch port on the same
inputs, for ``tests/test_torch_trajectory*.py`` and
``tests/fixtures/make_trajectory.py``.

Both trainers' ``train.loop.run`` take one config, written as the same
``TrainConfig`` fields in each package. What they are given alike:

- **Weights**: a seeded numpy init (``tests/fixtures/trajectory_init.py``)
  in flax layout, saved as a JAX ``.msgpack`` checkpoint that both loops
  read through ``pretrained`` (parameters and running statistics; the
  optimizer and the counters start fresh in both).
- **Data**: the corpora, splits and loader order are bitwise equal in the
  two packages already; nothing is injected.
- **Draws**: every reparameterization draw of the JAX run is recovered
  from its own forward under the key the step (or the eval sweep) uses,
  as ``(z − mu)/exp(log_var/2)``, by a wrapper around the JAX loop's
  ``make_train_step``/``make_eval_step``. The port's loop replays them in
  order through a wrapper around its ``make_train_step``/``make_eval_step``
  (their ``eps=``; ``tests/fixtures/trajectory_replay.py``, which
  ``chip_smoke.py`` shares). Pianoroll augmentation replays JAX's
  per-sample draws (pitch shift, time shift, velocity scale) through the
  port's ``augment_pianoroll_batch`` arguments.

A ``quiet`` run also zeroes, in both packages, the gradients of the conv
biases a BatchNorm cancels (:func:`bn_cancelled`), whose rounding noise
Adam would otherwise turn into steps of ±lr that differ between the two.

Neither package is changed for this: the wrappers are installed with
:func:`patched` on the loop modules' names for one run.
"""

from __future__ import annotations

import contextlib
import functools
import glob
import json
import os
import sys
from dataclasses import dataclass
from typing import Dict, List

import jax
import jax.numpy as jnp
import numpy as np
from flax import traverse_util

import midi_vae_tpu.data.fetch as jax_fetch
import midi_vae_tpu.train.loop as jax_loop
import midi_vae_tpu_torch.data.fetch as port_fetch
import midi_vae_tpu_torch.midi.rasterize as port_rasterize
import midi_vae_tpu_torch.train.loop as port_loop
from midi_vae_tpu.core.rng import epoch_key as jax_epoch_key
from midi_vae_tpu.io.checkpoint import save_checkpoint as jax_save_checkpoint
from midi_vae_tpu.models.registry import build_model as jax_build_model
from midi_vae_tpu.train.config import TrainConfig as JaxTrainConfig
from midi_vae_tpu_torch.interop.from_jax import flax_name_map, to_flax_layout
from midi_vae_tpu_torch.train.config import TrainConfig

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures"))
import trajectory_replay as tr  # noqa: E402
from trajectory_replay import Draws, init_leaves  # noqa: E402


@contextlib.contextmanager
def patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _eps(out) -> np.ndarray:
    """The draw behind a forward's latents: (z − mu)/exp(log_var/2), f32."""
    z = np.asarray(out.latents, np.float64)
    mu = np.asarray(out.encoded.mu, np.float64)
    lv = np.asarray(out.encoded.log_var, np.float64)
    return ((z - mu) / np.exp(0.5 * lv)).astype(np.float32)


# ------------------------------------------------------------------ weights


def jax_model(cfg: dict):
    """The JAX model of a config dict's fields (shapes only matter here)."""
    return jax_build_model(
        cfg.get("arch", "VanillaVAE"),
        in_channels=1,
        latent_dim=cfg.get("n_features", 10),
        input_dim=cfg["image_size"],
        hidden_dims=tuple(cfg["hidden_dims"]),
        fold=cfg.get("fold", 4),
        codebook_size=cfg.get("codebook_size", 512),
    )


def write_init_checkpoint(cfg: dict, path: str, seed: int) -> dict:
    """Save the seeded init of ``cfg``'s model as a JAX ``.msgpack``
    checkpoint at ``path``; returns its flat ``{path: array}`` leaves."""
    model = jax_model(cfg)
    s = cfg["image_size"]
    variables = model.init(
        {"params": jax.random.PRNGKey(0), "reparam": jax.random.PRNGKey(1)}, jnp.zeros((2, s, s, 1)), train=True
    )
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(jax.device_get(variables), sep="/").items()}
    flat.update(init_leaves({k: v.shape for k, v in flat.items()}, seed))
    tree = traverse_util.unflatten_dict(flat, sep="/")
    state = {"params": tree["params"], "batch_stats": tree.get("batch_stats", {}), "ema_params": {}}
    jax_save_checkpoint(path, state, config={}, epoch=0)
    return flat


# ------------------------------------------------------------------ draws


def jax_aug_draws(seed: int, epoch: int, batch_idx: int, b: int, spec) -> tuple:
    """The per-sample pianoroll augmentation draws of a JAX train batch
    (``data/pipeline.py`` keys batch i of an epoch with ``fold_in(epoch_key,
    i)``; ``data/transforms.py`` augments under ``fold_in(key, 2)``;
    ``midi/rasterize.py`` splits it per sample, then in three)."""
    key = jax.random.fold_in(jax.random.fold_in(jax_epoch_key(seed, epoch), batch_idx), 2)
    dps, dts, scales = [], [], []
    for k in jax.random.split(key, b):
        k_pitch, k_time, k_vel = jax.random.split(k, 3)
        dps.append(int(jax.random.randint(k_pitch, (), -spec.max_pitch_shift, spec.max_pitch_shift + 1)))
        dts.append(int(jax.random.randint(k_time, (), -spec.max_time_shift, spec.max_time_shift + 1)))
        lo, hi = spec.velocity_scale
        scales.append(float(jax.random.uniform(k_vel, (), minval=lo, maxval=hi)))
    return dps, dts, scales


def jax_recorders(draws: Draws):
    """Wrappers of the JAX loop's ``make_train_step``, ``make_eval_step``
    and ``evaluate`` whose steps record their draws into ``draws`` before
    running (``evaluate`` opens a sweep)."""
    real_train, real_eval, real_evaluate = jax_loop.make_train_step, jax_loop.make_eval_step, jax_loop.evaluate

    def make_train_step(model, tx, kl_schedule, **kw):
        step = real_train(model, tx, kl_schedule, **kw)
        n = kw.get("grad_accum", 1)
        fwd = jax.jit(functools.partial(model.apply, train=True, mutable=["batch_stats"]))

        def recorded(state, x, key):
            if not tr._gaussian(model):
                draws.train.append(None)
                return step(state, x, key)
            # train/state.py:311 keys the step; accumulate_grads folds in micro i
            step_key = jax.random.fold_in(key, state.step)
            variables = {"params": state.params, "batch_stats": state.batch_stats}
            m = x.shape[0] // n
            keys = [step_key] if n == 1 else [jax.random.fold_in(step_key, i) for i in range(n)]
            draws.train.append([_eps(fwd(variables, x[i * m : (i + 1) * m], rngs={"reparam": k})[0])
                                for i, k in enumerate(keys)])
            return step(state, x, key)

        recorded.raw_step_fn = step.raw_step_fn
        recorded.conditional = step.conditional
        return recorded

    def make_eval_step(model, **kw):
        step = real_eval(model, **kw)
        fwd = jax.jit(functools.partial(model.apply, train=False))

        def recorded(params, batch_stats, x, mask, key):
            if tr._gaussian(model):
                draws.eval[-1].append(_eps(fwd({"params": params, "batch_stats": batch_stats}, x, rngs={"reparam": key})))
            return step(params, batch_stats, x, mask, key)

        functools.update_wrapper(recorded, step)
        return recorded

    def evaluate(*args, **kw):
        draws.eval.append([])
        return real_evaluate(*args, **kw)

    return make_train_step, make_eval_step, evaluate


def jax_aug_replayer(seed: int, steps_per_epoch: int, image_size: int):
    """The port's ``augment_pianoroll_batch`` replaying the JAX run's draws:
    call k augments train batch k % steps_per_epoch of epoch 1 + k //
    steps_per_epoch (:func:`tr.port_aug_replayer`)."""
    from midi_vae_tpu.data.transforms import get_transform as jax_get_transform

    spec = jax_get_transform("pianoroll", image_size)[0]
    return tr.port_aug_replayer(
        port_rasterize.augment_pianoroll_batch,
        lambda k, b: jax_aug_draws(seed, 1 + k // steps_per_epoch, k % steps_per_epoch, b, spec),
    )


# ------------------------------------------------------------------ runs


@dataclass
class Run:
    """What a run leaves: its results dict, its ``metrics.jsonl`` rows and
    the files of its run directory (by stem)."""

    results: dict
    rows: List[dict]
    files: List[str]
    run_dir: str


def _run_dir(models_dir: str) -> str:
    dirs = glob.glob(os.path.join(models_dir, "*", "*"))
    assert len(dirs) == 1, dirs
    return dirs[0]


def collect_run(results: dict, models_dir: str) -> Run:
    """A finished run's results with its run directory's rows and files."""
    run_dir = _run_dir(models_dir)
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    files = sorted(os.path.splitext(n)[0] for n in os.listdir(run_dir))
    return Run(results, rows, files, run_dir)


def synthetic_sizes(sizes: Dict[str, int]):
    """Both packages' ``SYNTHETIC_SIZES`` set to ``sizes`` for the block."""
    stack = contextlib.ExitStack()
    for mod in (jax_fetch, port_fetch):
        stack.enter_context(patched(mod, "SYNTHETIC_SIZES", {**mod.SYNTHETIC_SIZES, **sizes}))
    return stack


def bn_cancelled(name: str) -> bool:
    """A conv bias (torch name) whose BatchNorm cancels it: its exact
    gradient is 0, so each side's is rounding noise that Adam scales to a
    step of up to ±lr, and the running mean that follows carries it."""
    return name.endswith(("Conv_0.bias", "ConvTranspose_0.bias")) and "Block_" in name


def _jax_bn_cancelled(path) -> bool:
    keys = [getattr(k, "key", str(k)) for k in path]
    return keys[-1] == "bias" and keys[-2].startswith(("Conv_", "ConvTranspose_")) and any("Block_" in k for k in keys)


def jax_quiet_optimizer():
    """The JAX loop's ``build_optimizer`` with the BN-cancelled conv biases'
    gradients set to zero before the optimizer (see :func:`bn_cancelled`)."""
    import optax

    real = jax_loop.build_optimizer

    def build_optimizer(*args, **kw):
        bundle = real(*args, **kw)

        def mask(params):
            return jax.tree_util.tree_map_with_path(lambda path, _: _jax_bn_cancelled(path), params)

        return bundle._replace(tx=optax.chain(optax.masked(optax.set_to_zero(), mask), bundle.tx))

    return build_optimizer


def port_quiet_optimizer():
    """The port loop's ``build_run_optimizer`` with the same gradients set
    to zero before each optimizer step."""
    real = port_loop.build_run_optimizer

    def build_run_optimizer(config, model, *args):
        bundle = real(config, model, *args)
        quiet = [p for name, p in model.named_parameters() if bn_cancelled(name)]
        step = bundle.optimizer.step

        def quiet_step(*a, **kw):
            for p in quiet:
                if p.grad is not None:
                    p.grad.zero_()
            return step(*a, **kw)

        bundle.optimizer.step = quiet_step
        return bundle

    return build_run_optimizer


def run_jax(cfg: dict, models_dir: str, draws: Draws, checkpoint_path: str = "", quiet: bool = False) -> Run:
    """``midi_vae_tpu.train.loop.run`` on ``cfg`` with its draws recorded;
    ``quiet`` zeroes the BN-cancelled biases' gradients."""
    make_train_step, make_eval_step, evaluate = jax_recorders(draws)
    config = JaxTrainConfig.from_dict({**cfg, "models_dir": models_dir, "checkpoint_path": checkpoint_path})
    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(jax_loop, "make_train_step", make_train_step))
        stack.enter_context(patched(jax_loop, "make_eval_step", make_eval_step))
        stack.enter_context(patched(jax_loop, "evaluate", evaluate))
        if quiet:
            stack.enter_context(patched(jax_loop, "build_optimizer", jax_quiet_optimizer()))
        results = jax_loop.run(config)
    return collect_run(results, models_dir)


def run_port(cfg: dict, models_dir: str, draws: Draws, checkpoint_path: str = "", quiet: bool = False,
             aug_replayer=None) -> Run:
    """``midi_vae_tpu_torch.train.loop.run`` on ``cfg`` (on the CPU), its
    draws replayed from ``draws``; ``quiet`` as for :func:`run_jax`; with
    ``aug_replayer`` (from :func:`jax_aug_replayer`) its augmentation
    replays JAX's too."""
    make_train_step, make_eval_step = tr.port_replayers(draws, port_loop.make_train_step, port_loop.make_eval_step)
    config = TrainConfig.from_dict({**cfg, "models_dir": models_dir, "checkpoint_path": checkpoint_path})
    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(port_loop, "make_train_step", make_train_step))
        stack.enter_context(patched(port_loop, "make_eval_step", make_eval_step))
        if quiet:
            stack.enter_context(patched(port_loop, "build_run_optimizer", port_quiet_optimizer()))
        if aug_replayer is not None:
            stack.enter_context(patched(port_rasterize, "augment_pianoroll_batch", aug_replayer))
        results = port_loop.run(config, device="cpu")
    return collect_run(results, models_dir)


# ------------------------------------------------------------------ comparisons


@dataclass(frozen=True)
class Tol:
    """A case's f32 tolerances (port against JAX).

    ``step``: every stepwise row value (loss, its terms, KL weight, grad
    norm, learning rates), relative with an absolute floor for terms that
    cross zero. ``eval``: epochwise rows and the final sweeps. ``leaf``:
    final parameters, running statistics, EMA averages and quantizer
    buffers. ``moment``: Adam's moments, max |Δ| ≤ moment · max |JAX's
    leaf| (they sum a few steps of gradients, whose rounding the parameter
    updates divide out). ``cancelled``: a natural run's BN-cancelled conv
    biases and the running means of the BatchNorm after them are held to
    |Δ| ≤ 2·Σ lr over the run (:func:`bn_cancelled`); a quiet run holds
    them as every other leaf."""

    step_rtol: float = 5e-5
    step_atol: float = 2e-6
    eval_rtol: float = 1e-4
    eval_atol: float = 1e-6
    leaf_rtol: float = 1e-4
    leaf_atol: float = 1e-6
    moment: float = 2e-3
    cancelled: bool = False


def _close(got, want, rtol: float, atol: float, what: str) -> None:
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=rtol, atol=atol,
                               err_msg=what)


def _exact(v) -> bool:
    return isinstance(v, (int, str)) or v is None


def assert_rows_match(port_rows: List[dict], jax_rows: List[dict], tol: Tol) -> None:
    """Every ``metrics.jsonl`` row key for key (:func:`tr.row_errors`)."""
    errors, _ = tr.row_errors(port_rows, jax_rows, step_rtol=tol.step_rtol, step_atol=tol.step_atol,
                              eval_rtol=tol.eval_rtol, eval_atol=tol.eval_atol)
    assert not errors, errors[:10]


def assert_sweeps_match(port: dict, jax_: dict, tol: Tol) -> None:
    """The final Test, Val (when distinct) and Train-under-eval sweeps."""
    parts = [k for k in ("final_test", "final_val", "final_train") if k in jax_]
    assert [k for k in ("final_test", "final_val", "final_train") if k in port] == parts
    for part in parts:
        assert sorted(port[part]) == sorted(jax_[part]), (part, sorted(set(port[part]) ^ set(jax_[part])))
        for key, v in jax_[part].items():
            if _exact(v):
                assert port[part][key] == v, (part, key, port[part][key], v)
            elif "throughput" not in key:
                _close(port[part][key], v, tol.eval_rtol, tol.eval_atol, f"{part}: {key}")


def _leaf(tree, path) -> np.ndarray:
    for k in path:
        tree = tree[k]
    return np.asarray(tree, np.float32)


def cancelled_bound(jax_rows: List[dict]) -> float:
    """2·Σ lr over the run's steps (every step logs its rates: log_interval 1)."""
    return 2.0 * sum(max(v for k, v in r.items() if "/lr-" in k) for r in jax_rows if "training/stepwise/train/loss" in r)


def _follows_cancelled(name: str) -> bool:
    return bn_cancelled(name) or (name.endswith("BatchNorm_0.running_mean") and "Block_" in name)


def assert_state_matches(port_state, jax_state, tol: Tol, bound: float) -> None:
    """Final parameters, running statistics, EMA averages and Adam moments."""
    model = port_state.model
    fmap = flax_name_map(model)
    trees = {"params": jax.device_get(jax_state.params), "batch_stats": jax.device_get(jax_state.batch_stats)}

    def check(name, got, want, what):
        if tol.cancelled and _follows_cancelled(name):
            assert np.abs(got - want).max() <= bound, (what, float(np.abs(got - want).max()), bound)
        else:
            _close(got, want, tol.leaf_rtol, tol.leaf_atol, what)

    for name, (collection, path) in fmap.items():
        check(name, to_flax_layout(model, name, model.state_dict()[name]), _leaf(trees[collection], path), name)
    assert (port_state.ema_params is None) == (not jax_state.ema_params)
    if port_state.ema_params is not None:
        ema = jax.device_get(jax_state.ema_params)
        assert sorted(port_state.ema_params) == sorted(n for n, p in model.named_parameters())
        for name, t in port_state.ema_params.items():
            check(name, to_flax_layout(model, name, t), _leaf(ema, fmap[name][1]), f"ema {name}")
    got, want = port_adam_moments(port_state), jax_adam_moments(jax_state.opt_state)
    for which in ("mu", "nu"):
        assert sorted(got[which]) == sorted(want[which]), which
        for path, w in want[which].items():
            if tol.cancelled and _jax_bn_cancelled(path.split("/")):
                continue  # the moments of rounding noise
            err, scale = np.abs(got[which][path] - w).max(), np.abs(w).max()
            assert err <= tol.moment * scale, (which, path, float(err), float(scale))


def assert_runs_match(port: Run, jax_: Run, tol: Tol) -> None:
    """The whole comparison of a case (see the module docstring of
    ``tests/test_torch_trajectory.py``)."""
    assert port.files == jax_.files
    assert_rows_match(port.rows, jax_.rows, tol)
    for key in ("total_step", "n_samples_seen", "best_epoch"):
        assert port.results[key] == jax_.results[key], key
    assert_sweeps_match(port.results, jax_.results, tol)
    assert_state_matches(port.results["state"], jax_.results["state"], tol, cancelled_bound(jax_.rows))


def last_epoch(rows: List[dict]) -> int:
    """The last epoch a run trained (where early stopping fired, if it did)."""
    return max(r["training/epochwise/epoch"] for r in rows if "training/epochwise/epoch" in r)


def jax_adam_moments(opt_state) -> Dict[str, Dict[str, np.ndarray]]:
    """optax's Adam moments by flat flax path: ``{"mu": {...}, "nu": {...}}``
    over every group (multi_transform masks each group's tree)."""
    import optax

    out = {"mu": {}, "nu": {}}
    states = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
              if isinstance(s, optax.ScaleByAdamState)]
    for s in states:
        for which in ("mu", "nu"):
            flat = traverse_util.flatten_dict(jax.device_get(getattr(s, which)), sep="/")
            for k, v in flat.items():
                if not isinstance(v, optax.MaskedNode):
                    out[which][k] = np.asarray(v)
    return out


def port_adam_moments(state) -> Dict[str, Dict[str, np.ndarray]]:
    """The port's AdamW moments by flat flax ``params`` path."""
    model, opt = state.model, state.optimizer.optimizer
    names = {id(p): n for n, p in model.named_parameters()}
    fmap = flax_name_map(model)
    out = {"mu": {}, "nu": {}}
    for group in opt.param_groups:
        for p in group["params"]:
            name = names[id(p)]
            for which, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                if key in opt.state.get(p, {}):
                    out[which]["/".join(fmap[name][1])] = to_flax_layout(model, name, opt.state[p][key])
    return out


# ------------------------------------------------------------------ cases

# the narrow main-path run every case starts from: FoldedVAE fold 4, hidden
# (8, 16), latent 4 at 32 px, AdamW + OneCycle, normalized BCE targets,
# unfused; 3 epochs of 4 steps (200 line images: 144 train, 16 val from
# --prototyping, 40 test; the train loader drops its last 16 rows)
BASE = dict(
    dataset_name="vae-lines-synthetic", transform_type="noaug", image_size=32, arch="FoldedVAE", fold=4,
    hidden_dims=[8, 16], n_features=4, kld_weight=0.05, epochs=3, lr_relative=0.004, weight_decay=1e-4,
    optimizer="AdamW", scheduler="OneCycle", bce_targets="normalized", batch_size_per_device=32, seed=0,
    num_devices=1, log_interval=1, log_images=False, run_name="t", run_id="r", prototyping=True,
)
SIZES = {"vae-lines-synthetic": 200, "midi-synthetic": 96, "midi-synthetic-dense": 96}
INIT_SEED = 3


@dataclass(frozen=True)
class Case:
    """A held run: ``overrides`` of :data:`BASE`, whether the BN-cancelled
    biases are quiet (:func:`jax_quiet_optimizer`), and its tolerances."""

    overrides: dict
    quiet: bool = True
    tol: Tol = Tol()


CASES = {
    # the main path's loop as users run it: the cancelled biases drift apart by
    # rounding noise, which the running means carry into every evaluation
    "folded": Case({}, quiet=False, tol=Tol(eval_rtol=5e-3, eval_atol=1e-6, cancelled=True)),
    "folded_fused": Case(dict(fused=True)),
    # best epoch 3, early stop after epoch 4 of 5
    "loop_options": Case(dict(ema_decay=0.9, grad_clip=0.5, lr_encoder_mult=0.5, kl_schedule="cyclical",
                              kl_cycle_steps=6, save_best_model=True, early_stop_patience=1, epochs=5,
                              lr_relative=3e-4)),
    "grad_accum": Case(dict(grad_accum=2)),
    "resume": Case({}),
    "vq": Case(dict(arch="FoldedVQVAE", loss_type="vq", codebook_size=16, fold=2, kld_weight=0.25)),
    "augmented": Case(dict(dataset_name="midi-synthetic-dense", transform_type="pianoroll")),
    "frozen_encoder": Case(dict(freeze_encoder=True, grad_clip=0.5)),
}


def case_config(name: str, root: str) -> dict:
    """The case's config dict with its init checkpoint written under ``root``."""
    cfg = {**BASE, **CASES[name].overrides}
    init = os.path.join(root, "init.msgpack")
    write_init_checkpoint(cfg, init, INIT_SEED)
    return {**cfg, "pretrained": init}

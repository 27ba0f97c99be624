"""Whole training runs with pianoroll augmentation, port against JAX,
step by step (see ``tests/test_torch_trajectory.py`` for what a case
compares and the tolerances, ``tests/torch_trajectory.py`` for the
harness). JAX's per-sample augmentation draws (pitch shift, time shift,
velocity scale) are replayed through the port's
``augment_pianoroll_batch``.

- ``augmented``: on ``midi-synthetic-dense`` (8.5 % fill), where both
  packages' f32 steps are accurate: the case's tolerances hold.
- sparse rolls (``midi-synthetic``, 1.3 % fill): on this corpus the JAX
  package's own f32 steps are off. Against an f64 recomputation of each
  step (the port's model in f64 from the state before the step, on the
  same batch and draw) the port's grad norm is within 1e-6 while JAX's
  is off by up to 3.5e-4 (8.7e-6 at step 1, from the same state), so the
  port and JAX differ there by more than the 1e-4 a step may. This
  test holds the port's loss, its terms and its grad norm to the f64
  step (rtol 1e-5), its loss and reconstruction to JAX's (rtol 5e-5),
  and every step where port and JAX part by more than 1e-4 in grad norm
  to JAX being the one off (JAX's distance to f64 at least 10× the
  port's).
"""

import contextlib

import numpy as np
import torch

import torch_trajectory as tt
from midi_vae_tpu_torch.train.state import make_loss
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _augmented_runs(cfg, tmp_path, port_wrapper=None):
    draws = tt.Draws()
    with tt.synthetic_sizes(tt.SIZES):
        jax_run = tt.run_jax(cfg, str(tmp_path / "jax"), draws, quiet=True)
        replayer = tt.jax_aug_replayer(cfg["seed"], jax_run.results["total_step"] // cfg["epochs"], cfg["image_size"])
        with contextlib.ExitStack() as stack:
            if port_wrapper is not None:
                stack.enter_context(tt.patched(tt.tr, "port_replayers", port_wrapper(tt.tr.port_replayers)))
            port_run = tt.run_port(cfg, str(tmp_path / "port"), draws, quiet=True, aug_replayer=replayer)
    assert replayer.calls == jax_run.results["total_step"]  # one augmented batch per step
    return port_run, jax_run


def test_augmented_run_matches_jax(tmp_path):
    port_run, jax_run = _augmented_runs(tt.case_config("augmented", str(tmp_path)), tmp_path)
    tt.assert_runs_match(port_run, jax_run, tt.CASES["augmented"].tol)


def _f64_steps(records):
    """A wrapper of ``port_replayers`` whose train steps first recompute
    themselves in f64 (a copy of the model, the same batch and draw) into
    ``records``: one (loss, reconstruction, KL loss, grad norm) a step."""

    def wrap(port_replayers):
        def replayers(draws, *makers, device="cpu"):
            make_train_step, make_eval_step = port_replayers(draws, *makers, device=device)
            draws_it = iter(draws.train)

            def make_train_step_f64(kl_schedule, **kw):
                step = make_train_step(kl_schedule, **kw)
                loss_fn = make_loss(**{k: kw[k] for k in ("loss_type", "fused_loss", "log_var_clamp", "free_bits",
                                                          "pos_weight", "target_denorm")})

                def recomputed(state, x, epoch_seed, **rest):
                    (eps,) = next(draws_it)
                    records.append(tt.tr.f64_step_terms(state.model, x, torch.from_numpy(eps),
                                                        kl_schedule(state.step), loss_fn))
                    return step(state, x, epoch_seed, **rest)

                return recomputed

            return make_train_step_f64, make_eval_step

        return replayers

    return wrap


def test_sparse_roll_steps_hold_to_f64_where_the_jax_steps_do_not(tmp_path):
    cfg = {**tt.case_config("augmented", str(tmp_path)), "dataset_name": "midi-synthetic"}
    f64 = []
    port_run, jax_run = _augmented_runs(cfg, tmp_path, _f64_steps(f64))
    keys = ["loss", "loss_recon", "loss_kld", "grad_norm"]
    rows = [r for r in port_run.rows if "training/stepwise/train/loss" in r]
    jrows = [r for r in jax_run.rows if "training/stepwise/train/loss" in r]
    assert len(rows) == len(jrows) == len(f64) == jax_run.results["total_step"]
    port = np.array([[r[f"training/stepwise/train/{k}"] for k in keys] for r in rows])
    jax_ = np.array([[r[f"training/stepwise/train/{k}"] for k in keys] for r in jrows])
    exact = np.array(f64)
    np.testing.assert_allclose(port, exact, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(port[:, :2], jax_[:, :2], rtol=5e-5, atol=2e-6)
    gn = 3
    parted = np.abs(port[:, gn] - jax_[:, gn]) > 1e-4 * np.abs(jax_[:, gn])
    jax_off, port_off = np.abs(jax_[:, gn] - exact[:, gn]), np.abs(port[:, gn] - exact[:, gn])
    assert np.all(jax_off[parted] >= 10 * port_off[parted]), (jax_off[parted], port_off[parted])

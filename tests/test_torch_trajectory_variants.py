"""Whole training runs, port against JAX, step by step (the cases around
the main path; see ``tests/test_torch_trajectory.py`` for what each case
compares and the tolerances, ``tests/torch_trajectory.py`` for the
harness; ``tests/test_torch_trajectory_augmented.py`` holds the
augmented runs).

- ``resume``: the port stops after epoch 1, then resumes its own
  checkpoint to the end; the two port runs together equal JAX's
  uninterrupted run.
- ``vq``: FoldedVQVAE under the VQ objective (codebook 16): the
  quantizer's EMA buffers, the commitment term and code usage over a run.
  The step draws nothing.
- ``frozen_encoder``: ``freeze_encoder`` with clipping; the run that
  showed F7 (the port left the frozen group's ``lr-encoder`` out of its
  rows, where JAX logs 0.0).
"""

import torch_trajectory as tt
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_resumed_run_matches_the_uninterrupted_jax_run(tmp_path):
    tol = tt.CASES["resume"].tol
    cfg = tt.case_config("resume", str(tmp_path))
    draws = tt.Draws()
    with tt.synthetic_sizes(tt.SIZES):
        jax_run = tt.run_jax(cfg, str(tmp_path / "jax"), draws, quiet=True)
        nb = jax_run.results["total_step"] // cfg["epochs"]
        # epoch 1 and its Val sweep, then the stopped run's final Test, Val, Train sweeps
        first = tt.Draws(train=draws.train[:nb], eval=[draws.eval[0]] + draws.eval[-3:])
        rest = tt.Draws(train=draws.train[nb:], eval=draws.eval[1:])
        stopped = tt.run_port({**cfg, "stop_after_epochs": 1}, str(tmp_path / "port"), first, quiet=True)
        # the resumed config takes stop_after_epochs from the checkpoint unless given: 2 more epochs
        resumed = tt.run_port({**cfg, "stop_after_epochs": 2}, str(tmp_path / "port"), rest, quiet=True,
                              checkpoint_path=f"{stopped.run_dir}/checkpoint_latest.pt")
    assert resumed.run_dir == stopped.run_dir and resumed.results["start_epoch"] == 2
    # one metrics.jsonl: the stopped run's epoch-1 rows and final sweeps, then the resumed run's rows
    n_stopped = len(stopped.rows)
    epoch1 = [r for r in resumed.rows[:n_stopped] if not any(k.startswith("eval/") for k in r)]
    resumed.rows = epoch1 + resumed.rows[n_stopped:]
    tt.assert_runs_match(resumed, jax_run, tol)


def test_vq_run_matches_jax(tmp_path):
    cfg = tt.case_config("vq", str(tmp_path))
    draws = tt.Draws()
    with tt.synthetic_sizes(tt.SIZES):
        jax_run = tt.run_jax(cfg, str(tmp_path / "jax"), draws, quiet=True)
        port_run = tt.run_port(cfg, str(tmp_path / "port"), draws, quiet=True)
    assert draws.train and all(d is None for d in draws.train)
    tt.assert_runs_match(port_run, jax_run, tt.CASES["vq"].tol)
    assert any(k.endswith("codebook-perplexity") for r in port_run.rows for k in r)


def test_frozen_encoder_run_matches_jax(tmp_path):
    """F7: the frozen encoder's rate is logged as ``lr-encoder`` 0.0 in every
    step row, as the JAX package logs it."""
    cfg = tt.case_config("frozen_encoder", str(tmp_path))
    draws = tt.Draws()
    with tt.synthetic_sizes(tt.SIZES):
        jax_run = tt.run_jax(cfg, str(tmp_path / "jax"), draws, quiet=True)
        port_run = tt.run_port(cfg, str(tmp_path / "port"), draws, quiet=True)
    tt.assert_runs_match(port_run, jax_run, tt.CASES["frozen_encoder"].tol)
    steps = [r for r in port_run.rows if "training/stepwise/train/loss" in r]
    assert steps and all(r["training/stepwise/lr-encoder"] == 0.0 for r in steps)

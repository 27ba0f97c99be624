"""The port's multi-device entry points on gloo ranks on the CPU.

One group of four ranks (``parallel.launch.spawn`` of
``torch_rank_cases.run_cases``) runs, inside it:

- the auto and explicit steps on the ``(slice, data)`` = (2, 2) mesh
  against the flat 4-rank mesh: the auto step bitwise (the same groups
  and rows), the explicit step with its noise neutralised as in
  ``tests/test_torch_spmd.py`` (losses within 1e-6 relative, parameters
  rtol 1e-5 / atol 1e-7: only the per-shard seeds differ);
- the train CLI with ``--num-devices 4 --mesh-slices 2``, then its resume
  under ``--step-impl shard_map``, and ``train_prior --num-devices 4``;
- the train CLI with ``--checkpoint-backend orbax`` over the four ranks:
  a resumed run bitwise equal to the uninterrupted one on every rank.

The test process runs the same CLIs on one rank at the same global batch
(4 × 8 = 32): the 4-rank run is that run up to summation order (train
and test metrics within 1e-4 relative, IWAE within 1e-4). The runs train
with SGD: AdamW turns the summation-order noise in the zero gradients of
the conv biases that feed a BatchNorm into steps of the learning rate's
size (the port's step tests exempt those biases for that reason). Rank 0 alone
writes the run directory, and every rank ends with the same parameters;
the prior's NLL history within 1e-5. ``--final-mig`` prints JAX's skip
message over several ranks. Last, ``--num-devices 2`` from this process
starts two ranks itself and returns rank 0's results with its train
state rebuilt here: the keys of a run on one device, and equal to one
rank at the same global batch.
"""

import os

import numpy as np
import pytest
import torch

from midi_vae_tpu_torch.cli import train_prior
from midi_vae_tpu_torch.cli.train import cli as train_cli
from midi_vae_tpu_torch.parallel.launch import spawn
from torch_rank_cases import build_spec_model, run_cases

WORLD = 4
FLAT_SPEC = dict(arch="FoldedVAE", model=dict(in_channels=1, latent_dim=4, input_dim=16, hidden_dims=(8, 16), fold=2),
                 batch=16)
MLP = dict(in_channels=1, latent_dim=4, input_dim=16, hidden_dims=(32,))
LINES = ["--dataset", "vae-lines-synthetic", "--transform-type", "noaug", "--image-size", "28", "--hidden-dims", "8",
         "16", "--n_features", "4", "--seed", "0", "--cpu", "--log-interval", "1000", "--optimizer", "SGD"]
VQ_TRAIN = ["--dataset", "vae-lines-synthetic", "--transform-type", "noaug", "--image-size", "32", "--model",
            "FoldedVQVAE", "--fold", "2", "--hidden-dims", "8", "16", "--n_features", "4", "--codebook-size", "16",
            "--kld-weight", "0.25", "--epochs", "1", "--batch-size", "64", "--seed", "0", "--cpu"]
PRIOR = ["--prior-arch", "transformer", "--features", "16", "--layers", "2", "--heads", "2", "--epochs", "2",
         "--batch-size", "32", "--cpu"]


def _mlp_pinned_spec():
    spec = dict(arch="MLPVAE", model=MLP, batch=16, kl=2.5e-4, step=dict(log_var_clamp=(-60.0, -60.0)))
    model = build_spec_model(spec)
    with torch.no_grad():
        model.fc_var.weight.zero_()
        model.fc_var.bias.fill_(-61.0)
    spec["state_dict"] = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    return spec


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multirank")
    train_cli(VQ_TRAIN + ["--models-dir", str(tmp / "vq"), "--run-name", "vq", "--run-id", "1"])
    vq_ckpt = str(tmp / "vq" / "vae-lines-synthetic" / "vq__1" / "checkpoint_latest.pt")
    run_dir = tmp / "ranks" / "vae-lines-synthetic" / "r__4"
    cli = {
        "argv": LINES + ["--epochs", "2", "--stop-after-epochs", "1", "--batch-size", "8", "--num-devices", "4",
                         "--mesh-slices", "2", "--final-iwae", "3", "--final-mig", "4", "--models-dir",
                         str(tmp / "ranks"), "--run-name", "r", "--run-id", "4"],
        "resume_argv": LINES + ["--epochs", "2", "--batch-size", "8", "--num-devices", "4", "--step-impl",
                                "shard_map", "--checkpoint", str(run_dir / "checkpoint_latest.pt")],
        "prior_argv": ["--checkpoint", vq_ckpt, "--num-devices", "4", "--out", str(tmp / "prior4.pt")] + PRIOR,
    }
    orbax_dir = tmp / "orbax"
    orbax = LINES + ["--epochs", "2", "--batch-size", "8", "--num-devices", "4", "--checkpoint-backend", "orbax"]
    orbax_runs = {
        "first": orbax + ["--stop-after-epochs", "1", "--checkpoint", str(orbax_dir / "a" / "checkpoint_latest.orbax")],
        "resumed": orbax + ["--async-checkpoint", "--checkpoint", str(orbax_dir / "a" / "checkpoint_latest.orbax")],
        "straight": orbax + ["--async-checkpoint", "--checkpoint", str(orbax_dir / "b" / "checkpoint_latest.orbax")],
    }
    payload = {"multislice_steps": {"auto": FLAT_SPEC, "spmd": _mlp_pinned_spec()}, "cli_runs": cli,
               "orbax_runs": orbax_runs}
    ranks = spawn(run_cases, WORLD, "cpu", list(payload), payload, timeout_s=300)
    return {"tmp": tmp, "ranks": ranks, "vq_ckpt": vq_ckpt, "run_dir": run_dir, "orbax_dir": orbax_dir}


def result(setup, name):
    status, value = setup["ranks"][name]
    if status != "ok":
        pytest.fail(f"rank case {name} failed:\n{value}")
    return value


def test_multislice_mesh_steps_match_the_flat_mesh(setup):
    got = result(setup, "multislice_steps")
    flat_axes, sliced_axes, coords = got["axes"]
    assert flat_axes == ("data",) and sliced_axes == ("slice", "data") and coords == {"slice": 0, "data": 0}
    assert got["auto_sliced"]["fields"] == got["auto_flat"]["fields"]
    for name, t in got["auto_flat"]["state"].items():
        assert torch.equal(got["auto_sliced"]["state"][name], t), name
    np.testing.assert_allclose(got["spmd_sliced"]["fields"], got["spmd_flat"]["fields"], rtol=1e-6)
    for name, t in got["spmd_flat"]["state"].items():
        np.testing.assert_allclose(got["spmd_sliced"]["state"][name], t, rtol=1e-5, atol=1e-7, err_msg=name)


@pytest.fixture(scope="module")
def one_rank(setup):
    tmp = setup["tmp"]
    r = train_cli(LINES + ["--epochs", "2", "--stop-after-epochs", "1", "--batch-size", "32", "--final-iwae", "3",
                           "--final-mig", "4", "--models-dir", str(tmp / "one"), "--run-name", "r", "--run-id", "1"])
    p = train_prior.cli(["--checkpoint", setup["vq_ckpt"], "--out", str(tmp / "prior1.pt")] + PRIOR)
    return {"run": r, "prior": p}


def _assert_metrics_match(got: dict, want: dict, rtol=1e-4):
    for k, v in want.items():
        if isinstance(v, (int, float)) and k != "throughput":
            np.testing.assert_allclose(got[k], v, rtol=rtol, atol=1e-6, err_msg=k)


def test_four_ranks_train_as_one_rank_at_four_times_the_batch(setup, one_rank):
    per_rank = result(setup, "cli_runs")
    want = one_rank["run"]
    for r, out in enumerate(per_rank):
        got = out["run"]
        assert got["total_step"] == want["total_step"] and got["n_samples_seen"] == want["n_samples_seen"]
        np.testing.assert_allclose(got["train"]["loss"], want["train"]["loss"], rtol=1e-4)
        _assert_metrics_match(got["final_test"], {k: v for k, v in want["final_test"].items() if k != "mig"})
        _assert_metrics_match(got["final_train"], want["final_train"])
        assert "mig" in want["final_test"] and "mig" not in got["final_test"]
        assert torch.equal(got["params"], per_rank[0]["run"]["params"]), f"rank {r} parameters differ"
    np.testing.assert_allclose(per_rank[0]["run"]["params"], torch.cat(
        [p.detach().reshape(-1) for p in want["state"].model.parameters()]), rtol=1e-4, atol=1e-5)


def test_rank_zero_alone_writes_and_every_rank_resumes_under_the_explicit_step(setup):
    per_rank = result(setup, "cli_runs")
    runs = os.listdir(setup["run_dir"].parent)
    assert runs == ["r__4"], runs
    files = set(os.listdir(setup["run_dir"]))
    assert {"checkpoint_latest.pt", "metrics.jsonl"} <= files and any(f.endswith(".png") for f in files)
    for out in per_rank:
        res = out["resumed"]
        assert res["start_epoch"] == 2 and [h["epoch"] for h in res["history"]] == [2]
        assert res["total_step"] == 2 * out["run"]["total_step"]
        assert torch.equal(res["params"], per_rank[0]["resumed"]["params"])


def test_prior_on_four_ranks_is_the_one_rank_prior(setup, one_rank):
    per_rank = result(setup, "cli_runs")
    want = one_rank["prior"]
    for out in per_rank:
        got = out["prior"]
        assert got["batch_size"] == want["batch_size"] == 32 and got["total_step"] == want["total_step"]
        np.testing.assert_allclose([h["nll"] for h in got["history"]], [h["nll"] for h in want["history"]],
                                   rtol=1e-5)
        np.testing.assert_allclose(got["test_nll"], want["test_nll"], rtol=1e-5)


def test_num_devices_two_starts_two_ranks_and_returns_rank_zero(setup, one_rank):
    tmp = setup["tmp"]
    argv = LINES + ["--epochs", "2", "--stop-after-epochs", "1", "--final-iwae", "3", "--final-mig", "4",
                    "--models-dir", str(tmp / "two"), "--run-name", "r", "--run-id", "2"]
    r = train_cli(argv + ["--batch-size", "16", "--num-devices", "2"])
    want = one_rank["run"]
    # what a run on one device returns: the same keys, the live state rebuilt here from rank 0's
    assert set(r) == set(want) and r["state"].step == r["total_step"] == want["total_step"]
    np.testing.assert_allclose(torch.cat([p.detach().reshape(-1) for p in r["state"].model.parameters()]), torch.cat(
        [p.detach().reshape(-1) for p in want["state"].model.parameters()]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(r["train"]["loss"], want["train"]["loss"], rtol=1e-4)
    _assert_metrics_match(r["final_test"], {k: v for k, v in want["final_test"].items() if k != "mig"})


def test_orbax_resume_over_four_ranks_is_the_uninterrupted_run_bitwise(setup):
    """Every rank writes its part of the directory (sync, then async); the
    resume reads it on every rank and trains what the straight run trains."""
    per_rank = result(setup, "orbax_runs")
    for out in per_rank:
        assert out["resumed"]["start_epoch"] == 2 and out["resumed"]["total_step"] == out["straight"]["total_step"]
        assert torch.equal(out["resumed"]["params"], out["straight"]["params"])
        assert torch.equal(out["resumed"]["params"], per_rank[0]["resumed"]["params"])
        assert out["resumed"]["final_test"] == out["straight"]["final_test"]
    for run in ("a", "b"):
        ckpt = setup["orbax_dir"] / run / "checkpoint_latest.orbax"
        assert sorted(os.listdir(ckpt)) == ["midi_vae_meta.json", "state", "structure.pt"]
        assert not os.path.exists(str(ckpt) + ".staging")

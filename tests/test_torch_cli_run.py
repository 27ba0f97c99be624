"""The train loop of the PyTorch port end to end on the CPU (mirroring
``tests/test_train_integration.py``) at a small size: ``vae-lines-synthetic``
at 28 px with a narrow VanillaVAE, and the flagship config as written on
a 16-file ``midi-synthetic`` corpus with narrow widths. A resumed run is
held to the uninterrupted one bitwise (weights, optimizer moments and
final metrics).
"""

import json
import os
import tempfile

import numpy as np
import pytest
import torch

import midi_vae_tpu_torch.data.fetch as fetch
import midi_vae_tpu_torch.train.loop as loop_mod
from midi_vae_tpu_torch.cli.train import cli
from midi_vae_tpu_torch.io.checkpoint import load_checkpoint
from midi_vae_tpu_torch.train.loop import run
from midi_vae_tpu_torch.train.state import state_dict
from torch_cli_helpers import small_config
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def first_run(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("run")
    config = small_config(tmp_path, run_name="itest", run_id="abc123", log_images=True)
    return tmp_path, config, run(config, device="cpu")


# ------------------------------------------------------------- the loop


def test_loss_decreases_and_final_sweeps(first_run):
    _, _, r = first_run
    losses = [h["train"]["loss"] for h in r["history"]]
    assert len(losses) == 2 and losses[1] < losses[0]
    assert "final_test" in r and "final_train" in r and "final_val" not in r  # val is test
    for key in ("count", "cross-entropy", "mse", "mae", "kl", "active-units", "precision", "recall", "f1"):
        assert key in r["final_test"]
    assert r["final_train"]["count"] == r["corpus"]["train"] == 819
    assert set(r["history"][0]["train"]["phase_s"]) == {"dataloader", "device_step", "logging"}


def test_counters(first_run):
    _, config, r = first_run
    steps = r["corpus"]["train"] // config.batch_size_per_device
    assert r["steps_per_epoch"] == steps
    assert r["total_step"] == config.epochs * steps and r["state"].step == r["total_step"]
    assert r["n_samples_seen"] == r["total_step"] * config.batch_size_per_device
    # forwards: one train forward per step (no grad_accum); a grid for each of
    # an epoch's first two batches; a val sweep per epoch (val is test here),
    # then the final test and train sweeps
    batches = lambda n: -(-n // config.batch_size_per_device)  # noqa: E731
    eval_batches = (config.epochs + 1) * batches(r["corpus"]["test"]) + batches(r["corpus"]["train"])
    assert r["forwards"] == {"train_steps": r["total_step"], "train_forwards": r["total_step"],
                             "grid": 2 * config.epochs, "eval_batches": eval_batches}


def test_checkpoint_metrics_and_grids_written(first_run):
    tmp_path, _, r = first_run
    run_dir = tmp_path / "models" / "vae-lines-synthetic" / "itest__abc123"
    payload = load_checkpoint(str(run_dir / "checkpoint_latest.pt"))
    assert payload["epoch"] == 2 and payload["total_step"] == r["total_step"]
    assert payload["config"]["run_id"] == "abc123" and payload["encoder_config"] == {"input_size": 28, "n_feature": 4}
    png = sorted(run_dir.glob("reconstruction_step*.png"))
    assert len(png) == 4 and png[0].read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    keys = set()
    with open(run_dir / "metrics.jsonl") as f:
        for line in f:
            keys.update(json.loads(line))
    assert any(k.startswith("training/stepwise/train/loss") for k in keys)
    assert any(k.startswith("training/epochwise/") for k in keys)
    assert any(k.startswith("eval/test/") for k in keys) and any(k.startswith("eval/train/") for k in keys)
    assert any(k.startswith("training/stepwise/lr-") for k in keys)
    for phase in ("dataloader", "device_step", "logging"):
        assert f"training/stepwise/duration/{phase}" in keys


def test_resume_continues_counters(tmp_path):
    ckpt = str(tmp_path / "m" / "checkpoint_latest.pt")
    r1 = run(small_config(tmp_path, epochs=1, checkpoint_path=ckpt, models_dir=None), device="cpu")
    r2 = run(small_config(tmp_path, epochs=2, checkpoint_path=ckpt, models_dir=None), device="cpu")
    assert r2["start_epoch"] == 2
    assert r2["total_step"] == 2 * r1["total_step"] and r2["n_samples_seen"] == 2 * r1["n_samples_seen"]


def test_resume_already_complete_and_premature(tmp_path, capsys):
    ckpt = str(tmp_path / "nope" / "checkpoint_latest.pt")
    c = small_config(tmp_path, epochs=1, checkpoint_path=ckpt, models_dir=None)
    run(c, device="cpu")  # no file yet: a fresh run, with a notice
    out = capsys.readouterr().out
    assert "Skipping premature resumption" in out and os.path.isfile(ckpt)
    r = run(c, device="cpu")  # the same epochs again
    assert "Training already completed!" in capsys.readouterr().out and r["history"] == []


@pytest.mark.parametrize("async_checkpoint", [False, True], ids=["sync", "async"])
def test_resumed_run_matches_uninterrupted_bitwise(tmp_path, async_checkpoint):
    kw = dict(epochs=2, models_dir=None, async_checkpoint=async_checkpoint, ema_decay=0.9, save_best_model=True)
    ckpt_a = str(tmp_path / "a" / "checkpoint_latest.pt")
    run(small_config(tmp_path, stop_after_epochs=1, checkpoint_path=ckpt_a, **kw), device="cpu")
    resumed = run(small_config(tmp_path, checkpoint_path=ckpt_a, **kw), device="cpu")
    straight = run(small_config(tmp_path, checkpoint_path=str(tmp_path / "b" / "checkpoint_latest.pt"), **kw), device="cpu")
    assert resumed["final_test"] == straight["final_test"] and resumed["final_train"] == straight["final_train"]
    a, b = state_dict(resumed["state"]), state_dict(straight["state"])
    for part in ("model", "ema_params"):
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    for pa, pb in zip(a["optimizer"]["state"].values(), b["optimizer"]["state"].values()):
        assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert os.path.isfile(tmp_path / "a" / "best_model.pt")


def test_early_stop_when_the_metric_plateaus(tmp_path, monkeypatch):
    """A validation metric that never improves after epoch 1 (BatchNorm's
    running statistics keep moving even at lr 0, so the metric is pinned):
    patience 2 stops after epoch 3."""
    real = loop_mod.evaluate

    def plateau(*a, **kw):
        out = real(*a, **kw)
        out["cross-entropy"] = 0.5
        return out

    monkeypatch.setattr(loop_mod, "evaluate", plateau)
    r = run(small_config(tmp_path, epochs=6, early_stop_patience=2, models_dir=None), device="cpu")
    assert r["best_epoch"] == 1 and r["total_step"] == 3 * r["steps_per_epoch"]
    with pytest.raises(ValueError, match="early_stop_patience"):
        run(small_config(tmp_path, early_stop_patience=0, models_dir=None), device="cpu")


def test_collapse_alarm_warns_once(tmp_path, monkeypatch, capsys):
    real = loop_mod.evaluate

    def collapsed(*a, **kw):
        out = real(*a, **kw)
        out["active-units"] = 0
        return out

    monkeypatch.setattr(loop_mod, "evaluate", collapsed)
    run(small_config(tmp_path, epochs=3, models_dir=None), device="cpu")
    out = capsys.readouterr().out
    assert out.count("WARNING: 0 active latent units") == 1 and "--bce-targets raw" in out


def test_pretrained_warm_start(first_run, tmp_path):
    prev_path, prev_config, prev = first_run
    r = run(small_config(tmp_path, pretrained=prev_config.checkpoint_path, epochs=1, ema_decay=0.5, models_dir=None),
            device="cpu")
    assert r["total_step"] == r["steps_per_epoch"]  # counters start fresh
    assert r["final_train"]["cross-entropy"] <= prev["final_train"]["cross-entropy"] + 0.02
    bogus = tmp_path / "bogus.pt"
    torch.save({"epoch": 1}, bogus)
    with pytest.raises(ValueError, match="--pretrained"):
        run(small_config(tmp_path, pretrained=str(bogus), models_dir=None), device="cpu")


def test_fused_cli_run_on_the_cpu(tmp_path):
    r = cli([
        "--dataset", "vae-lines-synthetic", "--transform-type", "noaug", "--image-size", "28", "--model", "FoldedVAE",
        "--fold", "4", "--hidden-dims", "8", "16", "--n_features", "4", "--epochs", "1", "--batch-size", "128",
        "--fused", "--bf16", "--seed", "0", "--models-dir", str(tmp_path), "--cpu",
    ])
    assert np.isfinite(r["train"]["loss"]) and np.isfinite(r["final_test"]["cross-entropy"])


def test_flagship_config_as_written_trains_at_narrow_width(tmp_path, monkeypatch):
    """configs/folded.yaml: raw targets, output_bias_init auto, bf16, unfused."""
    monkeypatch.setitem(fetch.SYNTHETIC_SIZES, "midi-synthetic", 16)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    r = cli(["--config", os.path.join(_REPO, "configs", "folded.yaml"), "--hidden-dims", "8", "8", "16", "16",
             "--batch-size", "8", "--epochs", "1", "--models-dir", str(tmp_path / "m"), "--cpu"])
    metrics = [r["train"]["loss"]] + [r["final_test"][k] for k in ("cross-entropy", "bce-objective", "kl", "mse")]
    assert all(np.isfinite(metrics)) and r["final_test"]["bce-objective"] > 0


def test_cli_runs_on_the_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli(["--dataset", "vae-lines-synthetic", "--epochs", "1"])

"""Scan-chunked epochs and sharded (``orbax`` backend) checkpoints of the
port's train loop, on the CPU, one rank (several ranks:
``tests/test_torch_multirank_cli.py``).

- ``--scan-steps 4`` trains exactly what ``--scan-steps 1`` trains: the
  per-step losses, the weights, the optimizer moments, the epoch means and
  the logged rows bitwise, with one host read per chunk; over a host-fed
  corpus it falls back to per-batch dispatch with the JAX package's
  message, and it refuses the explicit step as the JAX package does.
- ``--checkpoint-backend orbax``: a run resumed from its directory is the
  uninterrupted run, bitwise, with synchronous and asynchronous writes; the
  ``.staging`` → path swap leaves a loadable ``.old`` when it is cut short;
  a resume keeps the format it resumed from.
"""

import json
import os

import numpy as np
import pytest
import torch

import midi_vae_tpu_torch.data.fetch as fetch
import midi_vae_tpu_torch.train.loop as loop_mod
from midi_vae_tpu_torch.io import dcp_io
from midi_vae_tpu_torch.io.checkpoint import load_checkpoint
from midi_vae_tpu_torch.train.config import TrainConfig
from midi_vae_tpu_torch.train.loop import run
from midi_vae_tpu_torch.train.state import state_dict
from torch_cli_helpers import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def small_corpus(monkeypatch):
    monkeypatch.setitem(fetch.SYNTHETIC_SIZES, "vae-lines-synthetic", 256)


def config(tmp_path, **overrides) -> TrainConfig:
    base = dict(dataset_name="vae-lines-synthetic", transform_type="noaug", image_size=28, arch="VanillaVAE",
                n_features=4, hidden_dims=(8, 16), epochs=2, batch_size_per_device=24, lr_relative=0.02,
                kld_weight=0.00025, seed=0, models_dir=None, log_interval=3, log_images=False)
    return TrainConfig(**{**base, **overrides})


def _recording_steps(monkeypatch):
    """Each train step's loss, as the step returns it (no host read)."""
    losses = []
    real = loop_mod.make_train_step

    def make(*a, **k):
        step = real(*a, **k)

        def recorded(state, x, seed, **kw):
            state, lo, gn = step(state, x, seed, **kw)
            losses.append(lo.loss.detach())
            return state, lo, gn

        return recorded

    monkeypatch.setattr(loop_mod, "make_train_step", make)
    return losses


def _assert_states_equal(a, b):
    a, b = state_dict(a["state"]), state_dict(b["state"])
    for part in ("model", "ema_params"):
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    for pa, pb in zip(a["optimizer"]["state"].values(), b["optimizer"]["state"].values()):
        assert all(torch.equal(pa[k], pb[k]) for k in pa)


def _stepwise_rows(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    keys = ("loss", "loss_recon", "loss_kld", "kld_weight", "grad_norm")
    return [tuple(r[f"training/stepwise/train/{k}"] for k in keys) for r in rows if "training/stepwise/train/loss" in r]


def test_scan_chunked_epochs_are_the_per_batch_epochs_bitwise(tmp_path, monkeypatch):
    runs = {}
    for n in (1, 4):
        losses = _recording_steps(monkeypatch)
        r = run(config(tmp_path, scan_steps=n, data_placement="device", ema_decay=0.9,
                       models_dir=str(tmp_path / f"scan{n}"), run_name="r", run_id=str(n)), device="cpu")
        runs[n] = (r, torch.stack(losses))
    (per_batch, l1), (scan, l4) = runs[1], runs[4]
    assert len(l1) == 2 * per_batch["steps_per_epoch"] == 16 and torch.equal(l1, l4)
    _assert_states_equal(per_batch, scan)
    assert [h["train"]["loss"] for h in per_batch["history"]] == [h["train"]["loss"] for h in scan["history"]]
    assert per_batch["final_test"] == scan["final_test"] and per_batch["forwards"] == scan["forwards"]
    assert [h["train"]["host_syncs"] for h in scan["history"]] == [2, 2]  # 8 steps in chunks of 4
    assert all(h["train"]["host_syncs"] > 2 for h in per_batch["history"])
    rows = {n: _stepwise_rows(tmp_path / f"scan{n}" / "vae-lines-synthetic" / f"r__{n}") for n in (1, 4)}
    assert rows[1] == rows[4] and len(rows[1]) == 6  # steps 0, 3, 6 of each epoch


def test_scan_steps_fall_back_when_host_fed_and_refuse_the_explicit_step(tmp_path, capsys):
    r = run(config(tmp_path, epochs=1, scan_steps=4, data_placement="host"), device="cpu")
    assert "falling back to per-batch dispatch" in capsys.readouterr().out and r["history"][0]["train"]["host_syncs"] > 2
    with pytest.raises(ValueError, match="--scan-steps needs the auto train step"):
        run(config(tmp_path, epochs=1, scan_steps=4, step_impl="shard_map"), device="cpu")


@pytest.mark.parametrize("async_checkpoint", [False, True], ids=["sync", "async"])
def test_orbax_resume_is_the_uninterrupted_run_bitwise(tmp_path, async_checkpoint):
    kw = dict(checkpoint_backend="orbax", async_checkpoint=async_checkpoint, ema_decay=0.9, save_best_model=True)
    ckpt = str(tmp_path / "a" / dcp_io.ORBAX_CHECKPOINT_LATEST)
    first = run(config(tmp_path, stop_after_epochs=1, checkpoint_path=ckpt, **kw), device="cpu")
    assert dcp_io.is_orbax_checkpoint(ckpt) and os.path.isdir(tmp_path / "a" / dcp_io.ORBAX_BEST_MODEL)
    assert sorted(os.listdir(ckpt)) == ["midi_vae_meta.json", "state", "structure.pt"]
    assert not os.path.exists(ckpt + ".staging") and not os.path.exists(ckpt + ".old")
    payload = load_checkpoint(ckpt)
    assert payload["epoch"] == 1 and payload["total_step"] == first["total_step"] and "format" not in payload
    resumed = run(config(tmp_path, checkpoint_path=ckpt, **kw), device="cpu")
    straight = run(config(tmp_path, checkpoint_path=str(tmp_path / "b" / dcp_io.ORBAX_CHECKPOINT_LATEST), **kw),
                   device="cpu")
    assert resumed["start_epoch"] == 2 and resumed["total_step"] == straight["total_step"]
    _assert_states_equal(resumed, straight)
    assert resumed["final_test"] == straight["final_test"] and resumed["final_train"] == straight["final_train"]


def test_swap_leaves_a_loadable_old_copy_and_resume_keeps_its_format(tmp_path, capsys):
    ckpt = str(tmp_path / "c" / dcp_io.ORBAX_CHECKPOINT_LATEST)
    run(config(tmp_path, epochs=1, checkpoint_path=ckpt, checkpoint_backend="orbax"), device="cpu")
    os.rename(ckpt, ckpt + ".old")  # a cut between the swap's two renames
    assert dcp_io.is_orbax_checkpoint(ckpt) and load_checkpoint(ckpt)["epoch"] == 1
    assert "swap-window fallback" in capsys.readouterr().out
    # a .pt run resumed with --checkpoint-backend orbax keeps writing its file
    pt = str(tmp_path / "d" / "checkpoint_latest.pt")
    run(config(tmp_path, epochs=1, checkpoint_path=pt), device="cpu")
    r = run(config(tmp_path, epochs=2, checkpoint_path=pt, checkpoint_backend="orbax"), device="cpu")
    assert "resumed a msgpack checkpoint; saves stay msgpack" in capsys.readouterr().out
    assert r["config"]["checkpoint_backend"] == "msgpack" and load_checkpoint(pt)["epoch"] == 2
    assert not os.path.exists(tmp_path / "d" / dcp_io.ORBAX_CHECKPOINT_LATEST)


def test_async_dcp_writer_surfaces_errors(tmp_path):
    w = dcp_io.DCPAsyncWriter()
    blocker = tmp_path / "file"
    blocker.write_text("x")
    with pytest.raises(OSError):
        w.save(str(blocker / "sub" / "c.orbax"), {"a": torch.zeros(1)}, epoch=1)
    w.save(str(tmp_path / "ok.orbax"), {"a": torch.arange(3.0), "n": 4}, epoch=2, backend="orbax")
    w.wait()
    got = load_checkpoint(str(tmp_path / "ok.orbax"))
    assert got["epoch"] == 2 and got["state"]["n"] == 4 and torch.equal(got["state"]["a"], torch.arange(3.0))
    assert "backend" not in got and not np.isnan(got["epoch"])

"""The train CLI of the PyTorch port: its config and flags against the JAX
package's, and its training loop end to end on the CPU (mirroring
``tests/test_train_integration.py``) at a small size — ``vae-lines-synthetic``
at 28 px with a narrow VanillaVAE, and the flagship config as written on
a 16-file ``midi-synthetic`` corpus with narrow widths.

Configs and flag parsing are held to the JAX package key for key; a
resumed run to the uninterrupted one bitwise (weights, optimizer moments
and final metrics).
"""

import argparse
import dataclasses
import glob
import json
import os
import tempfile

import numpy as np
import pytest
import torch
import yaml

import midi_vae_tpu_torch.data.fetch as fetch
import midi_vae_tpu_torch.train.loop as loop_mod
from midi_vae_tpu.cli.train import args_to_config as jax_args_to_config
from midi_vae_tpu.cli.train import get_parser as jax_get_parser
from midi_vae_tpu.train.config import from_yaml as jax_from_yaml
from midi_vae_tpu_torch.cli.train import args_to_config, cli, get_parser
from midi_vae_tpu_torch.io.checkpoint import load_checkpoint
from midi_vae_tpu_torch.train.config import TrainConfig, from_yaml, read_yaml
from midi_vae_tpu_torch.train.loop import run
from midi_vae_tpu_torch.train.state import state_dict

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(_REPO, "configs", "*.yaml")))


def small_config(tmp_path, **overrides) -> TrainConfig:
    base = dict(
        dataset_name="vae-lines-synthetic",
        transform_type="noaug",
        image_size=28,
        arch="VanillaVAE",
        n_features=4,
        hidden_dims=(8, 16),
        epochs=2,
        batch_size_per_device=128,
        lr_relative=0.02,
        kld_weight=0.00025,
        seed=0,
        models_dir=str(tmp_path / "models"),
        log_interval=2,
        log_images=False,
    )
    base.update(overrides)
    return TrainConfig(**base)


@pytest.fixture(scope="module")
def first_run(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("run")
    config = small_config(tmp_path, run_name="itest", run_id="abc123", log_images=True)
    return tmp_path, config, run(config, device="cpu")


# ------------------------------------------------------------ config parity


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_from_yaml_matches_jax(path):
    assert from_yaml(path).to_dict() == jax_from_yaml(path).to_dict()
    with open(path) as f:
        assert read_yaml(path) == yaml.safe_load(f)


def test_reference_yaml_schema_and_scalars_match_jax(tmp_path):
    p = tmp_path / "vae.yaml"
    p.write_text(
        "# reference schema\nmodel_params:\n  latent_dim: 10   # z\n  hidden_dims: [32, 64, 128, 256]\n"
        "data_params:\n  train_batch_size: 100\n  data_path: '/data/x # not a comment'\n"
        "exp_params:\n  LR: 0.001\n  weight_decay: 1e-4\n  kld_weight: .25\n  manual_seed: 0\n"
        "trainer_params:\n  max_epochs: 100\n  flag: yes\n  empty:\n  nothing: ~\n  inf: -.inf\n"
    )
    assert read_yaml(str(p)) == yaml.safe_load(p.read_text())
    assert from_yaml(str(p)).to_dict() == jax_from_yaml(str(p)).to_dict()
    (tmp_path / "empty.yaml").write_text("# nothing\n")
    assert read_yaml(str(tmp_path / "empty.yaml")) is None
    assert from_yaml(str(tmp_path / "empty.yaml")) == TrainConfig()
    (tmp_path / "bad.yaml").write_text("a: {b: 1}\n")
    with pytest.raises(ValueError, match="unsupported"):
        read_yaml(str(tmp_path / "bad.yaml"))


def test_parser_matches_jax():
    def surface(parser):
        return sorted(
            (tuple(a.option_strings), a.dest, repr(a.default), repr(a.choices), a.nargs, getattr(a, "const", None))
            for a in parser._actions
        )

    assert surface(get_parser()) == surface(jax_get_parser())


ARGVS = {
    "defaults": [],
    "flagship_fused": ["--config", "configs/folded.yaml", "--fused", "--bce-targets", "normalized", "--epochs", "3"],
    "yaml_wins_over_defaults": ["--config", "configs/midi.yaml"],
    "typed_default_beats_yaml": ["--config", "configs/folded.yaml", "--batch-size=128", "--lr", "0.01"],
    "abbreviated_beats_yaml": ["--config", "configs/folded.yaml", "--epoch", "5", "--stop-after", "2"],
    "many_flags": [
        "--dataset", "vae-lines-synthetic", "--model", "FoldedVAE", "--fold", "8", "--hidden-dims", "8", "16",
        "--log-var-clamp", "-10", "10", "--free-bits", "0.1", "--bce-pos-weight", "auto", "--output-bias-init", "-2.5",
        "--prototyping", "3", "--protoval-split-rate", "auto", "--ema-decay", "0.99", "--bf16", "--kl-schedule", "linear",
        "--async-checkpoint", "--save-best-model", "--data-placement", "host", "--disable-wandb", "--log-wandb",
    ],
}


@pytest.mark.parametrize("name", list(ARGVS))
def test_args_to_config_matches_jax(name, monkeypatch):
    monkeypatch.chdir(_REPO)
    argv = ARGVS[name]
    got = args_to_config(get_parser().parse_args(argv), argv)
    want = jax_args_to_config(jax_get_parser().parse_args(argv), argv)
    assert got.to_dict() == want.to_dict()


def test_yaml_and_flag_precedence(monkeypatch):
    monkeypatch.chdir(_REPO)
    argv = ["--config", "configs/folded.yaml", "--epoch", "5", "--batch-size", "128"]
    config = args_to_config(get_parser().parse_args(argv), argv)
    assert (config.epochs, config.batch_size_per_device, config.arch, config.fold) == (5, 128, "FoldedVAE", 8)
    assert config.bce_targets == "raw" and config.output_bias_init == "auto" and config.dtype == "bfloat16"


def test_every_enum_and_switch_flag_reaches_config():
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    parser = get_parser()
    defaults = parser.parse_args([])
    covered = 0
    for action in parser._actions:
        d = action.dest
        if d not in fields or not action.option_strings:
            continue
        default = getattr(defaults, d)
        if action.choices:
            alts = [c for c in action.choices if c != default]
            if not alts:
                continue
            argv, expected = [action.option_strings[0], str(alts[0])], alts[0]
        elif isinstance(action, argparse._StoreTrueAction) and not default:
            argv, expected = [action.option_strings[0]], True
        elif action.type in (int, float) and action.nargs is None:
            expected = action.type(3 if action.type is int else 0.1875)
            if expected in (default, getattr(TrainConfig(), d, None)):
                expected = action.type(7 if action.type is int else 0.4375)
            argv = [action.option_strings[0], repr(expected)]
        else:
            continue
        config = args_to_config(parser.parse_args(argv), argv)
        assert getattr(config, d) == expected, f"{action.option_strings[0]} parsed but not wired into TrainConfig.{d}"
        covered += 1
    assert covered >= 10


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
    # forwards: a grid for each of an epoch's first two batches; a val sweep
    # per epoch (val is test here), then the final test and train sweeps
    batches = lambda n: -(-n // config.batch_size_per_device)  # noqa: E731
    eval_batches = (config.epochs + 1) * batches(r["corpus"]["test"]) + batches(r["corpus"]["train"])
    assert r["forwards"] == {"train_steps": r["total_step"], "grid": 2 * config.epochs, "eval_batches": eval_batches}


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


@pytest.mark.parametrize(
    "overrides,item",
    [
        (dict(arch="VQVAE"), 12), (dict(loss_type="beta-tc"), 17), (dict(loss_type="vq"), 12),
        (dict(pretrained="checkpoint_latest.msgpack"), 10),
        (dict(grad_accum=2), 7), (dict(scan_steps=8), 9), (dict(checkpoint_backend="orbax"), 10),
        (dict(num_devices=2), 16), (dict(mesh_slices=2), 16), (dict(step_impl="shard_map"), 16),
        (dict(conditional=True), 17), (dict(stem="s2d"), 17), (dict(norm="group"), 17), (dict(remat=True), 17),
        (dict(torch_compat=True), 17), (dict(verbose=True), 17), (dict(compilation_cache="/c"), 17),
        (dict(optimizer="Lion"), 17), (dict(scheduler="cosine"), 17), (dict(arch="MLPVAE"), 17),
        (dict(dataset_name="rrd:/x.rrd"), 9),
    ],
)
def test_unported_options_raise_with_their_roadmap_item(tmp_path, overrides, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 item {item}\\b"):
        run(small_config(tmp_path, models_dir=None, **overrides), device="cpu")


def test_multihost_flag_raises():
    with pytest.raises(NotImplementedError, match="item 16"):
        cli(["--multihost", "--cpu"])

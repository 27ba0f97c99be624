"""The generate and evaluate CLIs of the PyTorch port, and the train CLI's
``--final-iwae`` / ``--final-mig``, end to end on the CPU at a small size:
a one-epoch ``vae-lines-synthetic`` run (28 px, VanillaVAE hidden (8, 16),
latent 4, EMA on) writes the checkpoint they read.

The parsers are held to the JAX package's flag for flag; each mode runs to
completion with finite output in [0, 1], PNGs and readable ``.mid`` files
written; flags of features not ported yet raise ``NotImplementedError``
naming their ROADMAP item.
"""

import json
import os

import numpy as np
import pytest
import torch

from midi_vae_tpu.cli.evaluate import get_parser as jax_evaluate_parser
from midi_vae_tpu.cli.generate import get_parser as jax_generate_parser
from midi_vae_tpu_torch.cli import evaluate, generate
from midi_vae_tpu_torch.cli.train import cli as train_cli
from midi_vae_tpu_torch.evaluation.inference import sample_prior
from midi_vae_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from midi_vae_tpu_torch.midi.smf import read_smf

TRAIN = ["--dataset", "vae-lines-synthetic", "--transform-type", "noaug", "--image-size", "28", "--model", "VanillaVAE",
         "--hidden-dims", "8", "16", "--n_features", "4", "--epochs", "1", "--batch-size", "128", "--seed", "0",
         "--ema-decay", "0.9", "--cpu"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gen")
    r = train_cli(TRAIN + ["--models-dir", str(tmp / "m"), "--run-name", "g", "--run-id", "1"])
    ckpt = tmp / "m" / "vae-lines-synthetic" / "g__1" / "checkpoint_latest.pt"
    assert ckpt.is_file()
    return {"ckpt": str(ckpt), "tmp": tmp, "results": r}


def _surface(parser):
    return sorted(
        (tuple(a.option_strings), a.dest, repr(a.default), repr(a.choices), a.nargs, getattr(a, "const", None))
        for a in parser._actions
    )


@pytest.mark.parametrize("ours,theirs", [(generate.get_parser, jax_generate_parser),
                                         (evaluate.get_parser, jax_evaluate_parser)], ids=["generate", "evaluate"])
def test_parsers_match_jax(ours, theirs):
    assert _surface(ours()) == _surface(theirs())


MODES = {
    "sample": (["--mode", "sample", "-n", "6"], (6, 28, 28, 1)),
    "reconstruct": (["--mode", "reconstruct", "-n", "4"], (8, 28, 28, 1)),  # input | reconstruction pairs
    "interpolate": (["--mode", "interpolate", "--steps", "5", "--slerp"], (5, 28, 28, 1)),
    "traverse": (["--mode", "traverse", "--steps", "3"], (4 * 3, 28, 28, 1)),  # latent dims × steps
}


@pytest.mark.parametrize("mode", list(MODES))
def test_generate_modes_write_png_and_midi(trained, mode):
    argv, shape = MODES[mode]
    out, mid = trained["tmp"] / f"{mode}.png", trained["tmp"] / f"mid_{mode}"
    images = generate.cli(["--checkpoint", trained["ckpt"], "--cpu", "--out", str(out), "--export-midi", str(mid)] + argv)
    assert images.shape == shape and images.dtype == np.float32
    assert np.isfinite(images).all() and images.min() >= 0.0 and images.max() <= 1.0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    files = sorted(mid.glob("generated_*.mid"))
    assert len(files) == shape[0]
    for f in files:
        notes = read_smf(str(f))
        assert np.all(notes.pitch < 28) and np.all(notes.velocity >= 1)


def test_generate_sample_is_the_seeded_prior_decode(trained):
    images = generate.cli(["--checkpoint", trained["ckpt"], "--cpu", "--out", str(trained["tmp"] / "s.png"),
                           "-n", "3", "--seed", "4"])
    model, *_ = generate._load_model_and_state(trained["ckpt"], device="cpu")
    np.testing.assert_array_equal(images, sample_prior(model, 3, 4).numpy())


def test_generate_calibrates_the_export_threshold(trained, capsys):
    generate.cli(["--checkpoint", trained["ckpt"], "--cpu", "--out", str(trained["tmp"] / "a.png"), "-n", "2",
                  "--export-midi", str(trained["tmp"] / "mid_auto"), "--export-threshold", "auto"])
    out = capsys.readouterr().out
    assert "calibrated export threshold" in out and len(list((trained["tmp"] / "mid_auto").glob("*.mid"))) == 2


@pytest.mark.parametrize("argv,message", [
    (["--export-threshold", "0.3"], "--export-midi runs only"),
    (["--export-midi", "d", "--export-threshold", "1.5"], "must be in"),
    (["--export-midi", "d", "--export-threshold", "high"], "float in"),
], ids=["without_export", "out_of_range", "not_a_number"])
def test_generate_refuses_bad_export_thresholds(trained, argv, message):
    with pytest.raises(SystemExit, match=message):
        generate.cli(["--checkpoint", trained["ckpt"], "--cpu"] + argv)


def test_evaluate_iwae_mig_latents_json(trained):
    tmp = trained["tmp"]
    res = evaluate.cli(["--checkpoint", trained["ckpt"], "--cpu", "--iwae-samples", "4", "--mig",
                        "--latents-out", str(tmp / "z.npz"), "--json", str(tmp / "r.json")])
    test = res["test"]
    assert set(res) == {"test"} and test["count"] == trained["results"]["final_test"]["count"]
    for key in ("cross-entropy", "kl", "mse", "f1", "mig", "iwae-4"):
        assert np.isfinite(test[key]), key
    assert test["iwae-4"] < 0  # a log-likelihood of 784 Bernoulli pixels
    assert json.loads((tmp / "r.json").read_text()) == res
    z = np.load(tmp / "z.npz")
    assert z["latents_test"].shape == (test["count"], 4) and np.isfinite(z["latents_test"]).all()


def test_evaluate_all_partitions_with_raw_weights(trained, capsys):
    res = evaluate.cli(["--checkpoint", trained["ckpt"], "--cpu", "--partition", "all", "--no-ema"])
    assert set(res) == {"test", "train"}  # val is the test set here
    assert "not distinct" in capsys.readouterr().out
    assert res["train"]["count"] == trained["results"]["final_train"]["count"]


def test_train_final_iwae_and_mig(tmp_path):
    r = train_cli(TRAIN + ["--models-dir", str(tmp_path), "--final-iwae", "4", "--final-mig", "10"])
    final = r["final_test"]
    assert np.isfinite(final["iwae-4"]) and final["iwae-4"] < 0 and 0.0 <= final["mig"] <= 1.0
    rows = [json.loads(line) for p in tmp_path.rglob("metrics.jsonl") for line in p.read_text().splitlines()]
    assert any("eval/test/iwae-4" in row and "eval/test/mig" in row for row in rows)


@pytest.mark.parametrize("argv,item", [
    (["--prior", "p.msgpack"], 13), (["--mode", "continue"], 13), (["--keep-cols", "4"], 13), (["--label", "1"], 17),
], ids=["prior", "continue", "keep_cols", "label"])
def test_unported_generate_flags_raise_with_their_roadmap_item(trained, argv, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 item {item}\\b"):
        generate.cli(["--checkpoint", trained["ckpt"], "--cpu"] + argv)


@pytest.mark.parametrize("overrides,item", [
    ({"arch": "VQVAE"}, 12), ({"conditional": True}, 17), ({"torch_compat": True}, 17), ({"norm": "group"}, 17),
], ids=["vq", "conditional", "torch_compat", "norm"])
def test_unported_checkpoints_raise_with_their_roadmap_item(trained, tmp_path, overrides, item):
    payload = load_checkpoint(trained["ckpt"])
    payload["config"].update(overrides)
    path = str(tmp_path / "c.pt")
    save_checkpoint(path, payload.pop("state"), **payload)
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 item {item}\\b"):
        evaluate.cli(["--checkpoint", path, "--cpu"])


def test_evaluate_codes_out_raises_with_its_roadmap_item(trained):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 12\\b"):
        evaluate.cli(["--checkpoint", trained["ckpt"], "--cpu", "--codes-out", "codes.npz"])


@pytest.mark.parametrize("entry", [generate.cli, evaluate.cli], ids=["generate", "evaluate"])
def test_cli_runs_on_the_gpu_unless_asked_for_the_cpu(trained, entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry(["--checkpoint", trained["ckpt"], "--out", os.devnull] if entry is generate.cli
              else ["--checkpoint", trained["ckpt"]])

"""The generate and evaluate CLIs of the PyTorch port, and the train CLI's
``--final-iwae`` / ``--final-mig``, end to end on the CPU at a small size:
a one-epoch ``vae-lines-synthetic`` run (28 px, VanillaVAE hidden (8, 16),
latent 4, EMA on) writes the checkpoint they read.

The parsers are held to the JAX package's flag for flag; each mode runs to
completion with finite output in [0, 1], PNGs and readable ``.mid`` files
written; flags of features not ported yet raise ``NotImplementedError``
naming their ROADMAP item, and the two-stage VQ flags and ``--label``
refuse an unconditional Gaussian checkpoint (their own paths are
``tests/test_torch_two_stage_cli.py`` and ``tests/test_torch_conditional.py``);
checkpoints of the model variants (a VQVAE with the s2d stem, torch_compat,
GroupNorm) load in evaluate, generate and serve.
"""

import json
import os

import numpy as np
import pytest
import torch

import midi_vae_tpu_torch.data.fetch as fetch
from midi_vae_tpu.cli.evaluate import get_parser as jax_evaluate_parser
from midi_vae_tpu.cli.generate import get_parser as jax_generate_parser
from midi_vae_tpu_torch.cli import evaluate, generate
from midi_vae_tpu_torch.cli.train import cli as train_cli
from midi_vae_tpu_torch.evaluation.inference import sample_prior
from midi_vae_tpu_torch.io.checkpoint import load_checkpoint
from midi_vae_tpu_torch.midi.smf import read_smf
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

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


@pytest.mark.parametrize("argv,error,match", [
    (["--prior", "p.pt"], SystemExit, "VQVAE checkpoints only"),
    (["--mode", "continue"], SystemExit, "needs --prior"),
    (["--keep-cols", "4"], SystemExit, "--mode continue only"),
    (["--label", "1"], SystemExit, "needs a conditional checkpoint"),
], ids=["prior", "continue", "keep_cols", "label"])
def test_generate_flags_refuse_an_unconditional_gaussian_checkpoint(trained, argv, error, match):
    """The two-stage flags and --label are ported, and refuse this
    unconditional Gaussian checkpoint as the JAX CLI does."""
    with pytest.raises(error, match=match):
        generate.cli(["--checkpoint", trained["ckpt"], "--cpu"] + argv)


# checkpoints of the variants ported since they were refused here: the train CLI's flags for each
_VARIANT_FLAGS = {
    "vq": ["--model", "VQVAE", "--stem", "s2d", "--codebook-size", "16"],
    "torch_compat": ["--torch-compat"],
    "norm": ["--norm", "group"],
}


@pytest.mark.parametrize("overrides", [
    {"arch": "VQVAE", "stem": "s2d"}, None, {"torch_compat": True}, {"norm": "group"},
], ids=["vq", "conditional", "torch_compat", "norm"])
def test_once_refused_checkpoints_train_evaluate_generate_and_serve(trained, tmp_path, monkeypatch, request,
                                                                     overrides):
    """Every checkpoint kind these cases once refused is ported. A
    conditional checkpoint trained on a 256-image corpus evaluates under the
    batch labels, IWAE and MIG included. A VQVAE with the s2d stem, a
    torch_compat VanillaVAE and a GroupNorm one are trained by the CLI with
    their flags, and evaluate, generate and serve each rebuild the model
    from the checkpoint's config."""
    if overrides is None:
        monkeypatch.setitem(fetch.SYNTHETIC_SIZES, "vae-lines-synthetic", 256)
        train_cli(TRAIN + ["--conditional", "--models-dir", str(tmp_path / "m"), "--run-name", "c", "--run-id", "1"])
        ckpt = tmp_path / "m" / "vae-lines-synthetic" / "c__1" / "checkpoint_latest.pt"
        assert load_checkpoint(str(ckpt))["config"]["num_classes"] == 3
        res = evaluate.cli(["--checkpoint", str(ckpt), "--cpu", "--iwae-samples", "2", "--mig"])["test"]
        assert all(np.isfinite(res[k]) for k in ("cross-entropy", "kl", "iwae-2")) and 0.0 <= res["mig"] <= 1.0
        return
    from midi_vae_tpu_torch.serving import server as server_mod

    case = request.node.callspec.id
    vq = case == "vq"
    train_cli(TRAIN + _VARIANT_FLAGS[case] + ["--image-size", "32", "--models-dir", str(tmp_path / "m"),
                                              "--run-name", case, "--run-id", "1"])
    ckpt = str(tmp_path / "m" / "vae-lines-synthetic" / f"{case}__1" / "checkpoint_latest.pt")
    assert {k: load_checkpoint(ckpt)["config"][k] for k in overrides} == overrides
    res = evaluate.cli(["--checkpoint", ckpt, "--cpu"])["test"]
    assert np.isfinite(res["cross-entropy"])
    out = tmp_path / "gen"
    images = generate.cli(["--checkpoint", ckpt, "--cpu", "--mode", "reconstruct", "-n", "2", "--out", str(out)])
    assert np.all(np.isfinite(images)) and 0.0 <= float(images.min()) and float(images.max()) <= 1.0
    service = server_mod.InferenceService(ckpt, device="cpu")
    try:
        x = np.random.default_rng(0).random((2, 32, 32, 1)).astype(np.float32)
        model = service.model
        assert (getattr(model, "stem", None), getattr(model, "torch_compat", False), getattr(model, "norm", None)) == (
            "s2d" if vq else "conv", case == "torch_compat", "group" if case == "norm" else "batch")
        with torch.no_grad():
            want = model.decode(model.encode(torch.from_numpy(x), train=False).mu, train=False).numpy()
        np.testing.assert_array_equal(service.reconstruct(x), want)
        assert service.sample(3, 1).shape == (3, 32, 32, 1)
    finally:
        service.close()


def test_evaluate_codes_out_raises_with_its_roadmap_item(trained):
    """--codes-out is ported (tests/test_torch_two_stage_cli.py); a Gaussian checkpoint has no codes."""
    with pytest.raises(SystemExit, match="Gaussian latent"):
        evaluate.cli(["--checkpoint", trained["ckpt"], "--cpu", "--codes-out", "codes.npz"])


@pytest.mark.parametrize("entry", [generate.cli, evaluate.cli], ids=["generate", "evaluate"])
def test_cli_runs_on_the_gpu_unless_asked_for_the_cpu(trained, entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry(["--checkpoint", trained["ckpt"], "--out", os.devnull] if entry is generate.cli
              else ["--checkpoint", trained["ckpt"]])

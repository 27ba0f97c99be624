"""The two-stage VQ path of the PyTorch port end to end on the CPU, at a
small size: the train CLI on a FoldedVQVAE (fold 2, 32 px, hidden (8, 16),
D = 4, K = 16, one epoch of ``vae-lines-synthetic``) → the prior trainer
(transformer and PixelCNN; resume, chunk length, augment passes, the
config's ``prior:`` section) → ``generate --prior`` (sample and continue)
→ ``evaluate --codes-out`` → a server with ``--prior`` answering
``/sample`` and ``/continue`` — and the guards on the way (the JAX
package's ``tests/test_prior.py`` pipeline).

Served answers are held against the direct sampler and decoder within
1e-6 (the same computation on the same device); a resumed prior run and
one with another ``--scan-steps`` are held bitwise to the uninterrupted
run.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from midi_vae_tpu.cli.train_prior import get_parser as jax_prior_parser
from midi_vae_tpu_torch.cli import evaluate, generate, train_prior
from midi_vae_tpu_torch.cli.generate import _fetch_eval_batch, _load_model_and_state
from midi_vae_tpu_torch.cli.train import args_to_config, get_parser as train_parser
from midi_vae_tpu_torch.cli.train import cli as train_cli
from midi_vae_tpu_torch.data.fetch import fetch_dataset
from midi_vae_tpu_torch.data.pipeline import make_loader
from midi_vae_tpu_torch.data.transforms import get_transform
from midi_vae_tpu_torch.io.checkpoint import load_checkpoint
from midi_vae_tpu_torch.models.prior import sample_codes_autoregressive
from midi_vae_tpu_torch.serving import server as server_mod
from midi_vae_tpu_torch.serving.client import ServingClient, ServingError
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 16
TRAIN = ["--dataset", "vae-lines-synthetic", "--transform-type", "noaug", "--image-size", "32", "--model",
         "FoldedVQVAE", "--fold", "2", "--hidden-dims", "8", "16", "--n_features", "4", "--codebook-size", str(K),
         "--kld-weight", "0.25", "--epochs", "1", "--batch-size", "64", "--seed", "0", "--final-iwae", "4", "--cpu"]
PRIOR = {"transformer": ["--prior-arch", "transformer", "--features", "16", "--layers", "2", "--heads", "2"],
         "pixelcnn": ["--prior-arch", "pixelcnn", "--features", "16", "--layers", "2", "--kernel-size", "3"]}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The VQ run, its checkpoint and a transformer prior over it."""
    tmp = tmp_path_factory.mktemp("two_stage")
    r = train_cli(TRAIN + ["--models-dir", str(tmp / "m"), "--run-name", "vq", "--run-id", "1"])
    ckpt = str(tmp / "m" / "vae-lines-synthetic" / "vq__1" / "checkpoint_latest.pt")
    p = train_prior.cli(["--checkpoint", ckpt, "--epochs", "2", "--batch-size", "64", "--cpu"] + PRIOR["transformer"])
    return {"tmp": tmp, "results": r, "ckpt": ckpt, "prior": p}


def _prior_args(run, out, epochs, arch="pixelcnn", extra=()):
    return ["--checkpoint", run["ckpt"], "--out", str(out), "--epochs", str(epochs), "--batch-size", "64",
            "--cpu", *PRIOR[arch], *extra]


def _surface(parser):
    return sorted((tuple(a.option_strings), a.dest, repr(a.default), repr(a.choices), a.nargs) for a in parser._actions)


def test_prior_parser_matches_jax():
    """The JAX parser's surface, and the port's one addition, the moonlight
    prior: its choice of ``--prior-arch`` and ``--experts-held``."""
    port = _surface(train_prior.get_parser())
    added = [a for a in port if a[1] == "experts_held"]
    assert added == [(("--experts-held",), "experts_held", "None", "None", None)]
    arch = next(a for a in port if a[1] == "prior_arch")
    assert arch[3] == repr(("pixelcnn", "transformer", "moonlight"))
    port = [a[:3] + (repr(("pixelcnn", "transformer")),) + a[4:] if a[1] == "prior_arch" else a
            for a in port if a[1] != "experts_held"]
    assert port == _surface(jax_prior_parser())


# ---------------------------------------------------------------- stage 1


def test_vq_train_run_reports_codebook_health_and_checkpoints_the_codebook(run):
    r = run["results"]
    final = r["final_test"]
    assert final["codebook-perplexity"] > 1 and final["active-codes"] > 1
    assert "iwae-4" not in final  # the IWAE bound refuses a VQ posterior: skipped, as in JAX
    assert all("codebook-perplexity" in h["test"] for h in r["history"])
    payload = load_checkpoint(run["ckpt"])
    assert payload["config"]["loss_type"] == "vq" and payload["config"]["arch"] == "FoldedVQVAE"
    model = r["state"].model
    for name in ("codebook", "cluster_size", "embed_avg"):
        saved = payload["state"]["model"][f"quantizer.{name}"]
        assert torch.equal(saved, getattr(model.quantizer, name).cpu()), name
    assert not torch.allclose(model.quantizer.cluster_size, torch.ones(K))  # the EMA moved


def test_vq16_config_loads_for_both_stages():
    """configs/vq16_fold8.yaml: stage 1 reads its flat keys (the prior:
    section is not a TrainConfig field); stage 2 reads the prior: section,
    and an explicit flag wins over it."""
    path = os.path.join(_REPO, "configs", "vq16_fold8.yaml")
    argv = ["--config", path]
    config = args_to_config(train_parser().parse_args(argv), argv)
    assert (config.arch, config.fold, config.loss_type, config.codebook_size, config.n_features) == (
        "FoldedVQVAE", 8, "vq", 512, 16)
    assert tuple(config.hidden_dims) == (64, 128, 256) and config.dtype == "bfloat16"
    parser = train_prior.get_parser()
    argv = ["--checkpoint", "c.pt", "--config", path, "--epochs", "2"]
    args = train_prior.apply_prior_config(parser.parse_args(argv), parser, argv)
    assert (args.prior_arch, args.features, args.layers, args.heads, args.lr, args.batch_size,
            args.augment_passes, args.epochs) == ("transformer", 128, 6, 4, 3e-4, 256, 10, 2)


# ---------------------------------------------------------------- stage 2


@pytest.mark.parametrize("arch", list(PRIOR))
def test_train_prior_fits_and_saves(run, tmp_path, arch):
    out = tmp_path / "prior.pt"
    p = run["prior"] if arch == "transformer" else train_prior.cli(_prior_args(run, out, 2, arch))
    nlls = [h["nll"] for h in p["history"]]
    assert len(nlls) == 2 and all(np.isfinite(nlls)) and nlls[1] < nlls[0]
    assert 0 < p["test_nll"] < np.log(K)
    prior, pcfg = train_prior.load_prior(p["out"], device="cpu")
    assert (pcfg["kind"], pcfg["arch"], pcfg["num_codes"], pcfg["grid"]) == ("vq-code-prior", arch, K, 8)
    assert pcfg["test_nll"] == p["test_nll"] and pcfg["final_nll"] == nlls[-1]
    rows = [json.loads(line) for line in
            (open(os.path.join(os.path.dirname(p["out"]), "prior", "metrics.jsonl")).read().splitlines())]
    assert any("training/epochwise/nll" in row for row in rows) and any("eval/test/nll" in row for row in rows)


def test_prior_resume_and_chunk_length_reproduce_the_uninterrupted_run(run, tmp_path):
    whole = train_prior.cli(_prior_args(run, tmp_path / "whole.pt", 2, extra=["--scan-steps", "4"]))
    train_prior.cli(_prior_args(run, tmp_path / "cut.pt", 1, extra=["--no-eval"]))
    resumed = train_prior.cli(_prior_args(run, tmp_path / "cut.pt", 2, extra=["--scan-steps", "1"]))
    assert resumed["history"][0]["epoch"] == 2 and resumed["total_step"] == whole["total_step"]
    assert resumed["history"][0]["nll"] == whole["history"][1]["nll"] and resumed["test_nll"] == whole["test_nll"]
    a, b = load_checkpoint(str(tmp_path / "whole.pt")), load_checkpoint(str(tmp_path / "cut.pt"))
    assert a["epoch"] == b["epoch"] == 2
    for name, t in a["state"]["params"].items():
        assert torch.equal(t, b["state"]["params"][name]), name


def test_augment_passes_multiply_the_corpus_with_distinct_grids(run, tmp_path, capsys):
    p = train_prior.cli(_prior_args(run, tmp_path / "aug.pt", 1, extra=["--no-eval", "--augment-passes", "2"]))
    printed = capsys.readouterr().out
    clean = int(re.search(r"encoded (\d+) \[", printed).group(1))
    assert 2 * clean < p["corpus"] <= 3 * clean  # each pass drops at most the train loader's ragged tail
    assert train_prior.load_prior(p["out"], device="cpu")[1]["augment_passes"] == 2

    model, cfg, size, _, dataset = _load_model_and_state(run["ckpt"], device="cpu")
    spec_train, spec_eval = get_transform(cfg["transform_type"], size, {})
    train, _, _, _ = fetch_dataset(dataset, transform_train=spec_train, transform_eval=spec_eval, device="cpu")
    a, b = (train_prior.encode_corpus(model, make_loader(train, 64, train=True, seed=0, device="cpu"), epoch=e)
            for e in (1, 2))
    assert a.shape == b.shape and not np.array_equal(a, b)


@pytest.mark.parametrize("argv,error,match", [
    (["--num-devices", "-1"], SystemExit, "--num-devices must be >= 1"),
    (["--prior-arch", "transformer", "--features", "10", "--heads", "4"], SystemExit, "divisible"),
], ids=["num_devices", "heads"])
def test_train_prior_guards(run, argv, error, match):
    with pytest.raises(error, match=match):
        train_prior.cli(["--checkpoint", run["ckpt"], "--cpu"] + argv)


# ------------------------------------------------------- generate, evaluate


def test_generate_prior_sample_continue_and_marginal(run):
    tmp, ckpt, prior = run["tmp"], run["ckpt"], run["prior"]["out"]
    base = ["--checkpoint", ckpt, "--cpu", "-n", "4"]
    sampled = generate.cli(base + ["--prior", prior, "--top-p", "0.9", "--temperature", "0.8",
                                   "--out", str(tmp / "s.png"), "--export-midi", str(tmp / "mid_s")])
    model, _, _, _, _ = _load_model_and_state(ckpt, device="cpu")
    prior_model, _ = train_prior.load_prior(prior, device="cpu")
    with torch.inference_mode():
        want = model.decode_indices(sample_codes_autoregressive(prior_model, 0, 4, 8, temperature=0.8, top_p=0.9))
    np.testing.assert_array_equal(sampled, want.numpy())
    assert len(list((tmp / "mid_s").glob("*.mid"))) == 4

    cont = generate.cli(base + ["--prior", prior, "--mode", "continue", "--keep-cols", "3", "--out", str(tmp / "c.png")])
    assert cont.shape == (8, 32, 32, 1) and np.isfinite(cont).all() and cont.min() >= 0 and cont.max() <= 1
    marginal = generate.cli(base + ["--out", str(tmp / "m.png")])
    with torch.inference_mode():
        np.testing.assert_array_equal(marginal, model.sample(4, 0).numpy())


@pytest.mark.parametrize("argv,match", [
    (["--mode", "continue"], "needs --prior"),
    (["--mode", "continue", "--prior", "P", "--keep-cols", "8"], "--keep-cols must be in"),
    (["--mode", "sample", "--prior", "P", "--keep-cols", "1"], "--keep-cols applies"),
    (["--mode", "reconstruct", "--prior", "P"], "sample/continue on VQVAE"),
    (["--mode", "traverse"], "Gaussian-latent"),
    (["--mode", "sample", "--prior", "P", "--label", "1"], "class-conditional prior"),
], ids=["continue_without_prior", "keep_cols_range", "keep_cols_sample", "prior_mode", "traverse", "label"])
def test_generate_guards(run, argv, match):
    argv = [run["prior"]["out"] if a == "P" else a for a in argv]
    with pytest.raises(SystemExit, match=match):
        generate.cli(["--checkpoint", run["ckpt"], "--cpu", "-n", "2", "--out", os.devnull] + argv)


def test_conditional_prior_takes_labels(run, tmp_path):
    p = train_prior.cli(_prior_args(run, tmp_path / "cond.pt", 1, extra=["--conditional", "--no-eval"]))
    classes = train_prior.load_prior(p["out"], device="cpu")[1]["num_classes"]
    assert classes > 1
    base = ["--checkpoint", run["ckpt"], "--cpu", "-n", "2", "--prior", p["out"], "--out", os.devnull]
    assert generate.cli(base + ["--label", "1"]).shape == (2, 32, 32, 1)
    with pytest.raises(SystemExit, match="--label must be in"):
        generate.cli(base + ["--label", str(classes)])


def test_evaluate_codes_out_writes_the_encoded_corpus(run):
    path = run["tmp"] / "codes.npz"
    evaluate.cli(["--checkpoint", run["ckpt"], "--cpu", "--partition", "test", "--codes-out", str(path)])
    z = np.load(path)
    assert sorted(z.files) == ["codes_test", "labels_test"]
    codes = z["codes_test"]
    assert codes.dtype == np.int32 and codes.shape[1:] == (8, 8) and codes.min() >= 0 and codes.max() < K
    model, cfg, size, _, dataset = _load_model_and_state(run["ckpt"], device="cpu")
    x, _, _ = _fetch_eval_batch(dataset, None, size, 16, cfg, "cpu")
    with torch.inference_mode():
        np.testing.assert_array_equal(codes[:16], model.encode_indices(x).numpy())


# ----------------------------------------------------------------- serving


def test_server_with_prior_answers_sample_and_continue(run):
    service = server_mod.InferenceService(run["ckpt"], device="cpu", prior_path=run["prior"]["out"])
    httpd = server_mod.make_server(service)
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        health = ServingClient(url).healthz()
        assert health["prior"]["arch"] == "transformer" and health["latent_dim"] == 8 * 8 * 4
        x, _, _ = _fetch_eval_batch("vae-lines-synthetic", None, 32, 3, {"transform_type": "noaug"}, "cpu")
        model, prior = service.model, service.prior
        with torch.inference_mode():
            # n = 3 is drawn as the bucket of 4 rows, the first 3 returned
            want_sample = model.decode_indices(
                sample_codes_autoregressive(prior, 5, 4, 8, temperature=0.7, top_p=0.95))[:3].numpy()
            mask = np.zeros((8, 8), bool)
            mask[:, :2] = True
            known = model.encode_indices(torch.cat([x, torch.zeros(1, 32, 32, 1)]))
            want_cont = model.decode_indices(
                sample_codes_autoregressive(prior, 2, 4, 8, known=known, known_mask=mask))[:3].numpy()
        for wire in ("npy", "json"):
            c = ServingClient(url, wire=wire)
            np.testing.assert_allclose(c.sample(3, 5, temperature=0.7, top_p=0.95), want_sample, atol=1e-6)
            np.testing.assert_allclose(c.continue_(x.numpy(), keep_cols=2, seed=2), want_cont, atol=1e-6)
        with pytest.raises(ServingError, match="keep_cols"):
            ServingClient(url, wire="json")._post_params("/continue", {"images": x.numpy().tolist()})
        with pytest.raises(ServingError, match="keep_cols must be in"):
            ServingClient(url).continue_(x.numpy(), keep_cols=8)
        with pytest.raises(ServingError, match="top_p"):
            ServingClient(url).sample(2, top_p=1.5)
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()


def test_server_prior_guards(run, monkeypatch):
    """A VQ server without a prior refuses /continue and the sampling knobs;
    a prior of another geometry is refused at start-up."""
    service = server_mod.InferenceService(run["ckpt"], device="cpu")
    try:
        with pytest.raises(ValueError, match="--prior"):
            service.continue_rolls(np.zeros((1, 32, 32, 1), np.float32), 2)
        with pytest.raises(ValueError, match="no code prior"):
            service.sample(2, temperature=0.5)
        assert service.sample(2, 1).shape == (2, 32, 32, 1)  # the EMA marginal
        real = train_prior.load_prior
        monkeypatch.setattr(train_prior, "load_prior", lambda path, device: (
            real(path, device)[0], {**real(path, device)[1], "grid": 4}))
        with pytest.raises(ValueError, match="geometry"):
            service.attach_prior(run["prior"]["out"])
    finally:
        service.close()

"""The exported serving artifact of the PyTorch port
(``midi_vae_tpu_torch/interop/aot_export.py``) and ``serve --artifact``,
mirroring ``tests/test_aot_export.py``: programs against the live model at
several batch sizes (one symbolic-batch export), conditional programs,
the loader without model code, the manifest checks at load, the CLI, the
artifact server against the checkpoint server on every endpoint and
against the JAX package's ``InferenceService.from_parts`` on the same
weights (reconstruct, encode, interpolate), and the two-stage sampler
against ``sample_codes_autoregressive`` for the same seed.

Small widths (32 px, hidden (8, 16), latent 4; VQ: D = 4, K = 16 on an
8×8 grid, a 2-layer transformer prior of width 16), f32 on the CPU.
Tolerances: artifact outputs within 1e-5 absolute of the live model, of
the checkpoint server and of the JAX service (the exported graph runs the same ops; batches
of other sizes may sum in another order); sampled code grids equal.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from midi_vae_tpu.serving.server import InferenceService as JaxInferenceService
from midi_vae_tpu_torch.cli.train_prior import build_prior
from midi_vae_tpu_torch.interop import aot_export
from midi_vae_tpu_torch.interop.aot_export import AOTServingBundle, export_serving_programs
from midi_vae_tpu_torch.io.checkpoint import save_checkpoint
from midi_vae_tpu_torch.models.prior import sample_codes_autoregressive
from midi_vae_tpu_torch.models.registry import build_model
from midi_vae_tpu_torch.models.vae import param_group_label
from midi_vae_tpu_torch.serving import server as server_mod
from midi_vae_tpu_torch.serving.client import ServingClient, ServingError
from midi_vae_tpu_torch.train.optim import build_optimizer
from midi_vae_tpu_torch.train.state import create_train_state, state_dict
from test_torch_variants import _pair as variant_pair
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-5
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(in_channels=1, latent_dim=4, input_dim=32, hidden_dims=(8, 16))
K, GRID = 16, 8

# (arch, build kwargs): one variant of each family the artifact must carry
MODELS = {
    "vanilla_s2d_d2s_group": ("VanillaVAE", dict(stem="s2d", head="d2s", norm="group")),
    "folded_sub4": ("FoldedVAE", dict(fold=2, norm="batch-sub4")),
    "vq": ("VQVAE", dict(codebook_size=K)),
    "mlp": ("MLPVAE", {}),
}


def _x(n, seed):
    return np.random.default_rng(seed).random((n, 32, 32, 1)).astype(np.float32)


def _model(case, **extra):
    arch, kw = MODELS[case]
    model = build_model(arch, device="cpu", seed=3, **BASE, **kw, **extra)
    # random running statistics, so the eval-mode norms carry signal
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=gen))
            elif name.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=gen))
    return model


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=0, atol=atol)


# ----------------------------------------------------------------- programs


@pytest.mark.parametrize("case", list(MODELS))
def test_matches_live_model_and_symbolic_batch(case, tmp_path):
    model = _model(case)
    manifest = export_serving_programs(model, str(tmp_path / "art"), image_size=32, channels=1, platforms=["cpu"])
    assert set(manifest["programs"]) == {"reconstruct", "encode", "decode"}
    assert manifest["format"].startswith("torch.export") and manifest["platforms"] == ["cpu"]
    assert manifest["torch_version"] == torch.__version__
    bundle = AOTServingBundle(str(tmp_path / "art"), device="cpu")
    d = manifest["latent_dim"]
    with torch.no_grad():
        for n in (1, 5, 8):  # one artifact, several batch sizes (symbolic b)
            x = torch.from_numpy(_x(n, n))
            enc = model.encode(x, train=False)
            _close(bundle.reconstruct(x.numpy()), model.decode(enc.mu, train=False))
            got = bundle.encode(x)
            _close(got[:, :d], enc.mu)
            _close(got[:, d:], enc.log_var)
        z = torch.randn((4, d), generator=torch.Generator().manual_seed(9))
        _close(bundle.decode(z), model.decode(z, train=False))


def test_conditional_programs_take_labels(tmp_path):
    model = _model("mlp", num_classes=4)
    manifest = export_serving_programs(model, str(tmp_path / "cond"), image_size=32, channels=1)
    assert manifest["conditional"] is True and manifest["programs"]["decode"]["in_dtypes"] == ["float32", "int64"]
    bundle = AOTServingBundle(str(tmp_path / "cond"), device="cpu")
    assert bundle.conditional and bundle.num_classes == 4
    z = torch.randn((3, 4), generator=torch.Generator().manual_seed(2))
    d0, d1 = bundle.decode(z, np.zeros(3, np.int32)), bundle.decode(z, np.full(3, 2, np.int32))
    assert d0.shape == (3, 32, 32, 1) and not torch.allclose(d0, d1)  # the label is load-bearing
    y = torch.tensor([0, 1, 3])
    with torch.no_grad():
        _close(bundle.decode(z, y), model.decode(z, train=False, y=y))
        x = torch.from_numpy(_x(3, 1))
        _close(bundle.reconstruct(x, y), model.decode(model.encode(x, y=y).mu, y=y))


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("art") / "mlp")
    export_serving_programs(_model("mlp"), out, image_size=32, channels=1)
    return out


def test_loader_needs_no_model_code(exported, tmp_path):
    """A fresh interpreter loads the bundle and serves a reconstruction
    without importing ``midi_vae_tpu_torch.models`` (nor JAX)."""
    out = exported
    assert sorted(os.listdir(out)) == ["cpu", "manifest.json"]
    assert sorted(os.listdir(os.path.join(out, "cpu"))) == ["decode.pt2", "encode.pt2", "reconstruct.pt2"]
    code = (
        "import sys, numpy as np\n"
        "from midi_vae_tpu_torch.interop.aot_export import AOTServingBundle\n"
        f"b = AOTServingBundle({out!r}, device='cpu')\n"
        "r = b.reconstruct(np.zeros((2, 32, 32, 1), np.float32))\n"
        "assert tuple(r.shape) == (2, 32, 32, 1) and b.conditional is False\n"
        "bad = [m for m in sys.modules if m.startswith(('midi_vae_tpu_torch.models', 'jax', 'flax', 'midi_vae_tpu.'))]\n"
        "assert not bad, bad\n"
    )
    env = {**os.environ, "PYTHONPATH": _REPO}
    subprocess.run([sys.executable, "-c", code], check=True, cwd=str(tmp_path), env=env, timeout=120)


def _edited(src, dst, **changes):
    shutil.copytree(src, dst)
    path = os.path.join(dst, "manifest.json")
    with open(path) as f:
        manifest = json.load(f)
    manifest.update(changes)
    with open(path, "w") as f:
        json.dump(manifest, f)
    return str(dst)


def test_platform_mismatch_fails_at_load(exported, tmp_path):
    """A cuda-only artifact refuses to load for the CPU (not a 500 at the first request)."""
    with pytest.raises(ValueError, match="exported for platforms \\['cuda'\\].*--platforms cpu"):
        AOTServingBundle(_edited(exported, tmp_path / "cuda_only", platforms=["cuda"]), device="cpu")


def test_newer_torch_fails_at_load(exported, tmp_path):
    with pytest.raises(ValueError, match="exported with torch 99.0.0.*upgrade torch"):
        AOTServingBundle(_edited(exported, tmp_path / "future", torch_version="99.0.0"), device="cpu")


def test_loader_runs_on_the_gpu_unless_asked_for_the_cpu(exported):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AOTServingBundle(exported)


# --------------------------------------------------------------------- CLI


def _write_checkpoint(path, case, **extra):
    model = _model(case, **extra)
    arch, kw = MODELS[case]
    state = create_train_state(model, build_optimizer(model, param_group_label))
    config = {"arch": arch, "dataset_name": "midi-synthetic", "n_features": 4, "hidden_dims": [8, 16],
              "image_size": 32, "codebook_size": K, "fold": kw.get("fold", 4), **{
                  k: v for k, v in kw.items() if k in ("stem", "head", "norm")}}
    if extra.get("num_classes"):
        config.update(conditional=True, num_classes=extra["num_classes"])
    save_checkpoint(path, state_dict(state), config=config, encoder_config={"input_size": 32, "n_feature": 4})
    return model


def _write_prior(path, arch="transformer", num_codes=K):
    prior = build_prior(arch, num_codes=num_codes, grid=GRID, features=16, layers=2, heads=2)
    config = {"kind": "vq-code-prior", "arch": arch, "num_codes": num_codes, "grid": GRID, "features": 16,
              "layers": 2, "heads": 2, "num_classes": 0, "test_nll": 1.5}
    save_checkpoint(path, {"params": prior.state_dict()}, config=config)
    return prior


def test_cli_exports_from_checkpoint(tmp_path, capsys):
    ckpt = str(tmp_path / "c.pt")
    _write_checkpoint(ckpt, "mlp")
    out = str(tmp_path / "artifacts")
    manifest = aot_export.main(["--checkpoint", ckpt, "--out", out, "--cpu"])
    assert "exported 3 programs" in capsys.readouterr().out
    with open(os.path.join(out, "manifest.json")) as f:
        assert json.load(f) == manifest
    assert manifest["image_size"] == 32 and manifest["model"] == "MLPVAE" and manifest["platforms"] == ["cpu"]
    assert all(p["bytes"]["cpu"] == os.path.getsize(os.path.join(out, p["files"]["cpu"]))
               for p in manifest["programs"].values())
    r = AOTServingBundle(out, device="cpu").reconstruct(np.zeros((2, 32, 32, 1), np.float32))
    assert r.shape == (2, 32, 32, 1)


@pytest.mark.parametrize("argv,error,match", [
    (["--top-p", "0.9"], SystemExit, "needs --prior"),
    (["--prior", "PRIOR", "--top-p", "1.5"], SystemExit, "--top-p must be in"),
    (["--prior", "BADPRIOR"], SystemExit, "does not match the checkpoint"),
    (["--prior", "PRIOR", "--platforms", "cuda"], RuntimeError, "no CUDA device"),
], ids=["top_p_without_prior", "top_p_range", "prior_geometry", "cuda_without_gpu"])
def test_cli_guards(tmp_path, argv, error, match):
    if "cuda" in argv and torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ckpt = str(tmp_path / "vq.pt")
    _write_checkpoint(ckpt, "vq")
    paths = {"PRIOR": str(tmp_path / "p.pt"), "BADPRIOR": str(tmp_path / "bad.pt")}
    _write_prior(paths["PRIOR"])
    _write_prior(paths["BADPRIOR"], arch="pixelcnn", num_codes=K + 1)
    argv = [paths.get(a, a) for a in argv]
    with pytest.raises(error, match=match):
        aot_export.main(["--checkpoint", ckpt, "--out", str(tmp_path / "o"), "--cpu"] + argv)


# ----------------------------------------------------------------- serving


def _server(**kw):
    httpd = server_mod.serve(port=0, device="cpu", **kw)
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _stop(*servers):
    for httpd in servers:
        httpd.shutdown()
        httpd.server_close()
        httpd.service.close()


@pytest.fixture(scope="module", params=["folded", "mlp_conditional"])
def servers(request, tmp_path_factory):
    """(checkpoint server URL, artifact server URL, labels kwarg) over one
    checkpoint (FoldedVAE, or a conditional MLPVAE), the artifact exported
    by the CLI."""
    tmp = tmp_path_factory.mktemp("serve")
    ckpt = str(tmp / "c.pt")
    extra = {"num_classes": 3} if request.param == "mlp_conditional" else {}
    _write_checkpoint(ckpt, "mlp" if extra else "folded_sub4", **extra)
    art = str(tmp / "art")
    aot_export.main(["--checkpoint", ckpt, "--out", art, "--cpu"])
    (ck, ck_url), (ar, ar_url) = _server(checkpoint=ckpt), _server(artifact=art)
    yield ck_url, ar_url, ({"labels": [2, 0, 1]} if extra else {})
    _stop(ck, ar)


def test_healthz_identifies_the_artifact(servers):
    _, art, labels = servers
    health = ServingClient(art).healthz()
    assert health["status"] == "ok" and health["model"] in ("FoldedVAE (AOT artifact)", "MLPVAE (AOT artifact)")
    assert health["artifact"]["platforms"] == ["cpu"] and health["latent_dim"] == 4
    assert health["conditional"] is bool(labels)


@pytest.mark.parametrize("wire", ["npy", "json"])
def test_reconstruct_and_encode_match_the_checkpoint_server(servers, wire):
    ckpt, art, labels = servers
    a, b = ServingClient(ckpt, wire=wire), ServingClient(art, wire=wire)
    x = _x(3, 0)
    _close(b.reconstruct(x, **labels), a.reconstruct(x, **labels))
    for got, want in zip(b.encode(x, **labels), a.encode(x, **labels)):
        _close(got, want)


def test_sample_matches_the_checkpoint_server(servers):
    """Same seed → the same z drawn → the same decode, on both backends."""
    ckpt, art, labels = servers
    got = ServingClient(art).sample(3, 7, **labels)
    assert got.shape == (3, 32, 32, 1)
    _close(got, ServingClient(ckpt).sample(3, 7, **labels))


@pytest.mark.parametrize("slerp", [False, True], ids=["lerp", "slerp"])
def test_interpolate_matches_the_checkpoint_server(servers, slerp):
    ckpt, art, labels = servers
    a_img, b_img = _x(2, 2)
    lab = {"labels": 1} if labels else {}
    got = ServingClient(art).interpolate(a_img, b_img, steps=4, slerp=slerp, **lab)
    _close(got, ServingClient(ckpt).interpolate(a_img, b_img, steps=4, slerp=slerp, **lab))


def test_artifact_server_refusals(servers):
    _, art, labels = servers
    c = ServingClient(art, wire="json")
    with pytest.raises(ServingError, match="cannot encode-and-continue"):
        c._post_params("/continue", {"images": _x(1, 0).tolist(), "keep_cols": 2})
    with pytest.raises(ServingError, match="temperature"):
        c.sample(2, temperature=0.5, **({"labels": [0, 1]} if labels else {}))


# ------------------------------------------------------------ against JAX


@pytest.fixture(scope="module", params=["folded_sub4", "vanilla_s2d_d2s"])
def jax_served(request, tmp_path_factory):
    """The artifact server over a port model carrying flax weights (moved
    by ``interop/from_jax.py``), and the JAX package's service over the
    same variables."""
    jmodel, variables, model, _, _ = variant_pair(request.param)
    art = str(tmp_path_factory.mktemp("jax") / "art")
    export_serving_programs(model, art, image_size=32, channels=1, platforms=["cpu"])
    ar, ar_url = _server(artifact=art)
    jax_service = JaxInferenceService.from_parts(jmodel, variables["params"], variables["batch_stats"], 32, 1)
    yield ar_url, jax_service
    _stop(ar)
    jax_service.close()


def test_reconstruct_and_encode_match_jax(jax_served):
    url, jax_service = jax_served
    c = ServingClient(url)
    x = _x(3, 5)
    _close(c.reconstruct(x), jax_service.reconstruct(x))
    _close(np.concatenate(c.encode(x), axis=1), jax_service.encode(x))


@pytest.mark.parametrize("slerp", [False, True], ids=["lerp", "slerp"])
def test_interpolate_matches_jax(jax_served, slerp):
    url, jax_service = jax_served
    a_img, b_img = _x(2, 6)
    got = ServingClient(url).interpolate(a_img, b_img, steps=4, slerp=slerp)
    _close(got, jax_service.interpolate(a_img, b_img, steps=4, mode="slerp" if slerp else "lerp"))


# ------------------------------------------------------------- two-stage


@pytest.fixture(scope="module")
def vq_run(tmp_path_factory):
    """A VQ checkpoint and a transformer prior over its grid, exported
    together by the CLI with ``--top-p 0.9`` baked in."""
    tmp = tmp_path_factory.mktemp("vq")
    ckpt, prior_path, art = str(tmp / "vq.pt"), str(tmp / "prior.pt"), str(tmp / "art")
    model = _write_checkpoint(ckpt, "vq")
    prior = _write_prior(prior_path)
    manifest = aot_export.main(["--checkpoint", ckpt, "--out", art, "--prior", prior_path, "--top-p", "0.9",
                                "--platforms", "cpu", "--cpu"])
    return {"tmp": tmp, "ckpt": ckpt, "prior": prior_path, "art": art, "manifest": manifest, "model": model,
            "prior_model": prior}


def test_two_stage_sample_matches_sample_codes_autoregressive(vq_run):
    """The loader's sampler draws what the port's sampler draws for a seed;
    ``--top-p`` is baked into the manifest and applied."""
    manifest = vq_run["manifest"]
    assert set(manifest["programs"]) == {"reconstruct", "encode", "decode", "prior_logits", "decode_indices"}
    assert manifest["prior"]["top_p"] == 0.9 and manifest["prior"]["grid"] == GRID and manifest["platforms"] == ["cpu"]
    for top_p in (None, 0.9):
        art = _edited(vq_run["art"], vq_run["tmp"] / f"top_p_{top_p}", prior={**manifest["prior"], "top_p": top_p})
        with torch.inference_mode():
            idx = sample_codes_autoregressive(vq_run["prior_model"], 11, 4, GRID, temperature=0.8, top_p=top_p)
            want = vq_run["model"].decode_indices(idx)
        _close(AOTServingBundle(art, device="cpu").sample(11, 0.8, np.zeros(4, np.int32)), want)


def test_two_stage_serving_matches_the_checkpoint_server_with_prior(vq_run):
    (ck, ck_url), (ar, ar_url) = _server(checkpoint=vq_run["ckpt"], prior=vq_run["prior"]), _server(artifact=vq_run["art"])
    try:
        health = ServingClient(ar_url).healthz()
        assert health["prior"]["arch"] == "transformer" and health["latent_dim"] == GRID * GRID * 4
        for seed, temperature in ((5, 1.0), (6, 0.7)):  # the artifact's top_p 0.9 is baked in
            want = ServingClient(ck_url).sample(3, seed, temperature=temperature, top_p=0.9)
            _close(ServingClient(ar_url).sample(3, seed, temperature=temperature), want, atol=0)
        x = _x(2, 3)
        _close(ServingClient(ar_url).reconstruct(x), ServingClient(ck_url).reconstruct(x))
        _close(ServingClient(ar_url).interpolate(x[0], x[1], steps=3),
               ServingClient(ck_url).interpolate(x[0], x[1], steps=3))
    finally:
        _stop(ck, ar)


def test_vq_artifact_without_prior_refuses_sample_and_prior_beside_artifact(vq_run):
    m = vq_run["manifest"]
    programs = {k: v for k, v in m["programs"].items() if k in ("reconstruct", "encode", "decode")}
    out = _edited(vq_run["art"], vq_run["tmp"] / "plain", prior=None, programs=programs)
    service = server_mod.InferenceService.from_artifact(out, device="cpu")
    try:
        with pytest.raises(ValueError, match="re-export with --prior"):
            service.sample(2)
    finally:
        service.close()
    with pytest.raises(ValueError, match="carry their prior from export time"):
        server_mod.serve(artifact=out, prior=vq_run["prior"], device="cpu")

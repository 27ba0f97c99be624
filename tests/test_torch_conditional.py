"""Conditional models in the PyTorch port against the JAX package's, on the
CPU: the forward and one train step of a conditional VanillaVAE, FoldedVAE
and MLPVAE, inference under labels, the labelled micro-batcher, the server
and client with labels (against ``InferenceService.from_parts`` of the JAX
package), ``generate --label`` end to end on ``vae-lines-synthetic`` and a
two-class conditional code prior served with labels.

Weights go from flax to torch through the weight bridge (the widened
``fc_mu``/``fc_var``/``decoder_input`` kernels included); inputs, labels
and noise from a seed with numpy; f32. Tolerances: forward outputs within
1e-5 of each output's largest magnitude (the conv and dense sums run in
another order on each side), served answers within 1e-5 absolute; the
train step as
``tests/test_torch_accum.py`` holds it.
"""

import functools
import json
import re
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midi_vae_tpu.evaluation import inference as jax_inf
from midi_vae_tpu.losses import schedules as jax_kl_schedules
from midi_vae_tpu.models.registry import build_model as jax_build_model
from midi_vae_tpu.models.vae import param_group_label as jax_param_group_label
from midi_vae_tpu.serving.batcher import MicroBatcher as JaxMicroBatcher
from midi_vae_tpu.serving.server import InferenceService as JaxInferenceService
from midi_vae_tpu.train.optim import build_optimizer as jax_build_optimizer
from midi_vae_tpu.train.state import create_train_state as jax_create_train_state
from midi_vae_tpu.train.state import make_train_step as jax_make_train_step
from midi_vae_tpu_torch.cli import generate
from midi_vae_tpu_torch.cli.train import cli as train_cli
from midi_vae_tpu_torch.cli.train_prior import build_prior
from midi_vae_tpu_torch.evaluation import inference
from midi_vae_tpu_torch.interop.from_jax import load_flax_variables
from midi_vae_tpu_torch.io.checkpoint import save_checkpoint
from midi_vae_tpu_torch.losses import schedules as kl_schedules
from midi_vae_tpu_torch.models.prior import sample_codes_autoregressive
from midi_vae_tpu_torch.models.registry import build_model
from midi_vae_tpu_torch.models.vae import param_group_label
from midi_vae_tpu_torch.serving import server as server_mod
from midi_vae_tpu_torch.serving.batcher import MicroBatcher
from midi_vae_tpu_torch.serving.client import ServingClient, ServingError
from midi_vae_tpu_torch.train import schedules
from midi_vae_tpu_torch.train.optim import build_optimizer
from midi_vae_tpu_torch.train.state import create_train_state, make_train_step
from test_torch_accum import assert_losses_match, assert_state_matches
from test_torch_models import _randomize
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

C, ATOL = 3, 1e-5
ARCH_KW = {
    "VanillaVAE": dict(in_channels=1, latent_dim=4, input_dim=28, hidden_dims=(8, 16)),
    "FoldedVAE": dict(in_channels=1, latent_dim=4, input_dim=32, hidden_dims=(8, 16, 16), fold=4),
    "MLPVAE": dict(in_channels=1, latent_dim=4, input_dim=12, hidden_dims=(24, 16)),
}


def _x(arch, n, seed):
    d = ARCH_KW[arch]["input_dim"]
    return (np.random.default_rng(seed).uniform(size=(n, d, d, 1)) > 0.7).astype(np.float32)


def _labels(n, seed=0):
    return np.random.default_rng(seed).integers(0, C, n).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_side(arch):
    jmodel = jax_build_model(arch, num_classes=C, **ARCH_KW[arch])
    variables = jmodel.init({"params": jax.random.PRNGKey(0), "reparam": jax.random.PRNGKey(1)},
                            jnp.asarray(_x(arch, 2, 0)), train=True, y=jnp.zeros((2,), jnp.int32))
    return jmodel, _randomize(variables, np.random.default_rng(7))


def _pair(arch):
    jmodel, variables = _jax_side(arch)
    model = build_model(arch, num_classes=C, device="cpu", **ARCH_KW[arch])
    load_flax_variables(model, variables["params"], variables.get("batch_stats", {}))
    return jmodel, variables, model


def _eps_under(jmodel, variables, x, y, key):
    """The noise of a JAX train-mode forward under ``key``, recovered from its z."""
    out, _ = jax.jit(functools.partial(jmodel.apply, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x), y=jnp.asarray(y), rngs={"reparam": key})
    z, mu = np.asarray(out.latents, np.float64), np.asarray(out.encoded.mu, np.float64)
    return torch.from_numpy((z - mu) / np.exp(0.5 * np.asarray(out.encoded.log_var, np.float64)))


def _jax_forward_with_eps(mdl, x, eps, y):
    enc = mdl.encode(x, train=True, y=y)
    z = enc.mu + eps * jnp.exp(0.5 * enc.log_var)
    return enc.mu, enc.log_var, mdl.decode_logits(z, train=True, y=y)


@pytest.mark.parametrize("arch", list(ARCH_KW))
def test_conditional_forward_matches_flax(arch):
    jmodel, variables, model = _pair(arch)
    x, y = _x(arch, 5, 1), _labels(5)
    eps = np.random.default_rng(2).normal(size=(5, 4)).astype(np.float32)
    (mu, lv, logits), _ = jax.jit(functools.partial(jmodel.apply, method=_jax_forward_with_eps,
                                                    mutable=["batch_stats"]))(
        variables, jnp.asarray(x), jnp.asarray(eps), jnp.asarray(y))
    out = model(torch.from_numpy(x), train=True, eps=torch.from_numpy(eps), y=torch.from_numpy(y))
    assert model.fc_mu.weight.shape[1] == model.fc_var.weight.shape[1] and model.num_classes == C
    for got, want in ((out.encoded.mu, mu), (out.encoded.log_var, lv), (out.logits, logits)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=ATOL * np.abs(want).max())
    # pre_latents stay the unconditioned features
    assert out.encoded.pre_latents.shape[1] == model.fc_mu.weight.shape[1] - C


def test_conditional_model_needs_labels():
    _, _, model = _pair("FoldedVAE")
    x = torch.from_numpy(_x("FoldedVAE", 2, 0))
    with pytest.raises(ValueError, match=r"FoldedVAE\(num_classes=3\) is conditional: encode requires labels y"):
        model(x, eps=torch.zeros(2, 4))
    with pytest.raises(ValueError, match="decode requires labels y"):
        model.decode(torch.zeros(2, 4))


@pytest.mark.parametrize("arch,n", [("VanillaVAE", 1), ("FoldedVAE", 2), ("MLPVAE", 1)],
                         ids=["VanillaVAE", "FoldedVAE_grad_accum2", "MLPVAE"])
def test_conditional_step_matches_jax(arch, n):
    """One step with the batch labels (split per micro-batch at n = 2)."""
    jmodel, variables, model = _pair(arch)
    x, y, epoch_key = _x(arch, 8, 3), _labels(8, 1), jax.random.PRNGKey(4)
    opt_kw = dict(optimizer="AdamW", lr=1e-3, scheduler="OneCycle", total_steps=10000)
    bundle = jax_build_optimizer(None, jax_param_group_label, **opt_kw)
    jstate = jax_create_train_state(jmodel, bundle.tx, jax.random.PRNGKey(0), jnp.asarray(x[:2]))
    jstate = jstate.replace(params=variables["params"], batch_stats=variables.get("batch_stats", {}),
                            opt_state=bundle.tx.init(variables["params"]))
    # the draw of each micro-batch: the step key itself at n = 1, fold_in(step key, i) for micro i
    step_key, m = jax.random.fold_in(epoch_key, 0), len(x) // n
    keys = [step_key] if n == 1 else [jax.random.fold_in(step_key, i) for i in range(n)]
    eps = [_eps_under(jmodel, variables, x[i * m:(i + 1) * m], y[i * m:(i + 1) * m], k) for i, k in enumerate(keys)]
    jstep = jax_make_train_step(jmodel, bundle.tx, jax_kl_schedules.kl_weight_schedule("constant", 0.05),
                                grad_accum=n, donate=False)
    jstate, jlo, jgn = jstep(jstate, jnp.asarray(x), jnp.asarray(y), epoch_key)

    state = create_train_state(model, build_optimizer(model, param_group_label, **opt_kw))
    step = make_train_step(kl_schedules.kl_weight_schedule("constant", 0.05), grad_accum=n)
    state, lo, grad_norm = step(state, torch.from_numpy(x), 4, y=torch.from_numpy(y), eps=eps[0] if n == 1 else eps)
    assert_losses_match(lo, jlo, grad_norm, jgn)
    assert_state_matches(model, jstate, schedules.onecycle_lr(1e-3, 10000)(0))


# ------------------------------------------------------------- inference


def test_inference_under_labels_matches_jax():
    """sample (given z), interpolate and traverse of a conditional model
    under labels, against the JAX functions."""
    jmodel, v, model = _pair("FoldedVAE")
    x, y = _x("FoldedVAE", 2, 5), _labels(4, 2)
    z = np.random.default_rng(3).normal(size=(4, 4)).astype(np.float32)
    want = jmodel.apply(v, jnp.asarray(z), train=False, y=jnp.asarray(y), method=type(jmodel).decode)
    got = inference.sample_prior(model, 4, z=torch.from_numpy(z), y=torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    yt, yj = torch.from_numpy(y[:1]), jnp.asarray(y[:1])
    got = inference.interpolate(model, torch.from_numpy(x[:1]), torch.from_numpy(x[1:]), steps=4, mode="slerp", y=yt)
    want = jax_inf.interpolate(jmodel, v["params"], v["batch_stats"], jnp.asarray(x[:1]), jnp.asarray(x[1:]),
                               steps=4, mode="slerp", y=yj)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    got = inference.traverse(model, torch.from_numpy(x), steps=3, y=torch.from_numpy(y[1:3]))
    want = jax_inf.traverse(jmodel, v["params"], v["batch_stats"], jnp.asarray(x), steps=3, y=jnp.asarray(y[1:3]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


# ---------------------------------------------------------------- batcher


def test_labelled_batcher_pads_labels_with_the_rows_as_jax():
    """Requests of different classes share a dispatch; ``fn`` gets the rows
    and their labels padded to the bucket, as the JAX batcher gives them."""
    seen = {"port": [], "jax": []}

    def fn(key):
        def run(rows, labels):
            seen[key].append((rows.copy(), labels.copy()))
            return rows * 0 + labels[:, None].astype(np.float32)
        return run

    for key, cls in (("port", MicroBatcher), ("jax", JaxMicroBatcher)):
        batcher = cls(fn(key), max_batch=8, max_wait_ms=50.0, labeled=True)
        futs = [batcher.submit(np.full((n, 2), float(i), np.float32), np.full(n, i)) for i, n in ((0, 1), (1, 2), (2, 2))]
        for (i, n), f in zip(((0, 1), (1, 2), (2, 2)), futs):
            np.testing.assert_array_equal(f.result(timeout=5), np.full((n, 2), float(i)))
        with pytest.raises(ValueError, match="needs labels"):
            batcher.submit(np.zeros((1, 2), np.float32))
        with pytest.raises(ValueError, match=r"labels must be int \[n=2\]"):
            batcher.submit(np.zeros((2, 2), np.float32), np.zeros(3))
        batcher.close()
    assert len(seen["port"]) == len(seen["jax"])
    for (rp, lp), (rj, lj) in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(rp, rj)
        np.testing.assert_array_equal(lp, lj)
    plain = MicroBatcher(lambda r: r, max_wait_ms=1.0)
    with pytest.raises(ValueError, match="unconditional model; drop the labels"):
        plain.submit(np.zeros((1, 2), np.float32), np.zeros(1))
    plain.close()


# ----------------------------------------------------------------- server


def _start(service):
    httpd = server_mod.make_server(service)
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _stop(httpd):
    httpd.shutdown()
    httpd.server_close()
    httpd.service.close()


@pytest.fixture(scope="module")
def served():
    """The port's server over a conditional FoldedVAE and the JAX package's
    service over the same weights."""
    jmodel, v, model = _pair("FoldedVAE")
    httpd, url = _start(server_mod.InferenceService.from_parts(model, 32, 1, max_wait_ms=20.0))
    jax_service = JaxInferenceService.from_parts(jmodel, v["params"], v["batch_stats"], 32, 1)
    yield {"url": url, "model": model, "jax": jax_service}
    _stop(httpd)
    jax_service.close()


@pytest.mark.parametrize("wire", ["npy", "json"])
def test_served_answers_with_labels_match_jax(served, wire):
    c, js = ServingClient(served["url"], wire=wire), served["jax"]
    x, y = np.random.default_rng(11).uniform(size=(3, 32, 32, 1)).astype(np.float32), np.array([2, 0, 1])
    np.testing.assert_allclose(c.reconstruct(x, labels=y), np.asarray(js.reconstruct(x, y)), rtol=0, atol=ATOL)
    mu, log_var = c.encode(x, labels=1)  # a scalar covers every row
    np.testing.assert_allclose(np.concatenate([mu, log_var], 1), np.asarray(js.encode(x, np.full(3, 1, np.int32))),
                               rtol=0, atol=ATOL)
    got = c.interpolate(x[0], x[1], steps=4, labels=2)
    np.testing.assert_allclose(got, np.asarray(js.interpolate(x[0], x[1], steps=4, mode="lerp", label=2)),
                               rtol=0, atol=ATOL)
    with torch.inference_mode():  # n = 3 draws the bucket of 4, the padding row of class 0
        want = inference.sample_prior(served["model"], 4, 5, y=torch.tensor([1, 2, 0, 0]))[:3].numpy()
    np.testing.assert_allclose(c.sample(3, 5, labels=[1, 2, 0]), want, rtol=0, atol=ATOL)
    health = c.healthz()
    assert health["conditional"] is True and health["num_classes"] == C


@pytest.mark.parametrize("body,match", [
    ({}, "a label \\(0..2\\) is required"),
    ({"label": 3}, "labels must be in \\[0, 2\\]"),
    ({"labels": [0, 1]}, "labels must be a scalar or \\[n=1\\] list"),
], ids=["missing", "out_of_range", "wrong_count"])
def test_server_refuses_bad_labels_with_400(served, body, match):
    req = urllib.request.Request(served["url"] + "/reconstruct", data=json.dumps(
        {"images": np.zeros((1, 32, 32, 1)).tolist(), **body}).encode(), headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(req, timeout=10)
    assert err.value.code == 400 and re.search(match, json.loads(err.value.read())["error"])
    with pytest.raises(ServingError, match="required"):
        ServingClient(served["url"]).reconstruct(np.zeros((1, 32, 32, 1), np.float32))


def test_mixed_label_requests_from_threads_coalesce(served):
    model = served["model"]
    rng = np.random.default_rng(0)
    requests = [[(rng.uniform(size=(int(rng.integers(1, 4)), 32, 32, 1)).astype(np.float32), int(rng.integers(C)))
                 for _ in range(2)] for _ in range(16)]
    with torch.inference_mode():
        want = {id(x): model.decode(model.encode(torch.from_numpy(x), y=torch.full((len(x),), k)).mu,
                                    y=torch.full((len(x),), k)).numpy() for reqs in requests for x, k in reqs}
    before = ServingClient(served["url"]).healthz()
    errors = []

    def worker(reqs):
        try:
            for x, k in reqs:
                np.testing.assert_allclose(ServingClient(served["url"]).reconstruct(x, labels=k), want[id(x)],
                                           rtol=0, atol=1e-6)
        except Exception as e:  # noqa: BLE001 - collected and asserted below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(r,)) for r in requests]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    after = ServingClient(served["url"]).healthz()
    assert not errors
    served_now = after["requests_served"] - before["requests_served"]
    assert served_now == 32 and after["batches_dispatched"] - before["batches_dispatched"] < 32


# ------------------------------------------------- generate --label, end to end


TRAIN = ["--dataset", "vae-lines-synthetic", "--transform-type", "noaug", "--image-size", "28", "--model", "VanillaVAE",
         "--hidden-dims", "8", "16", "--n_features", "4", "--epochs", "1", "--batch-size", "128", "--seed", "0",
         "--conditional", "--cpu"]


def test_generate_label_end_to_end(tmp_path):
    """A conditional run on vae-lines-synthetic (labels 1 and 2, so 3
    classes), then generate with --label, the per-class sweep, every mode,
    the label guards, and the checkpoint served with labels."""
    train_cli(TRAIN + ["--models-dir", str(tmp_path / "m"), "--run-name", "c", "--run-id", "1"])
    ckpt = str(tmp_path / "m" / "vae-lines-synthetic" / "c__1" / "checkpoint_latest.pt")
    base = ["--checkpoint", ckpt, "--cpu", "--out", str(tmp_path / "g.png")]
    one = generate.cli(base + ["--mode", "sample", "-n", "4", "--label", "2"])
    sweep = generate.cli(base + ["--mode", "sample", "-n", "4"])
    model = generate._load_model_and_state(ckpt, device="cpu")[0]
    assert model.num_classes == C
    for images, labels in ((one, [2, 2, 2, 2]), (sweep, [0, 1, 2, 0])):
        want = inference.sample_prior(model, 4, 0, y=torch.tensor(labels)).numpy()
        np.testing.assert_array_equal(images, want)
    for argv, shape in ((["--mode", "reconstruct", "-n", "3"], (6, 28, 28, 1)),
                        (["--mode", "interpolate", "--steps", "3", "--label", "1"], (3, 28, 28, 1)),
                        (["--mode", "traverse", "--steps", "2"], (8, 28, 28, 1))):
        images = generate.cli(base + argv)
        assert images.shape == shape and np.isfinite(images).all()
    with pytest.raises(SystemExit, match=r"--label must be in \[0, 2\]"):
        generate.cli(base + ["--label", "3"])
    service = server_mod.InferenceService(ckpt, device="cpu")
    try:
        x = np.zeros((2, 28, 28, 1), np.float32)
        assert service.num_classes == C and service.reconstruct(x, np.array([1, 2], np.int32)).shape == (2, 28, 28, 1)
    finally:
        service.close()


# ------------------------------------------------ a class-conditional prior


def test_two_class_conditional_prior_served_with_labels(tmp_path):
    """A FoldedVQVAE with a two-class transformer prior attached: /sample and
    /continue take labels and equal the direct sampler for their seed; the
    label guards answer 400."""
    vq = build_model("FoldedVQVAE", in_channels=1, latent_dim=4, input_dim=32, hidden_dims=(8, 16), fold=2,
                     codebook_size=16, device="cpu")
    prior = build_prior("transformer", num_codes=16, grid=8, features=16, layers=1, heads=2, num_classes=2, seed=1)
    path = str(tmp_path / "prior.pt")
    save_checkpoint(path, {"params": prior.state_dict()}, config={
        "kind": "vq-code-prior", "arch": "transformer", "num_codes": 16, "grid": 8, "features": 16, "layers": 1,
        "heads": 2, "num_classes": 2})
    service = server_mod.InferenceService.from_parts(vq, 32, 1)
    service.attach_prior(path)
    httpd, url = _start(service)
    try:
        c = ServingClient(url)
        assert c.healthz()["prior"]["num_classes"] == 2
        with torch.inference_mode():
            want = vq.decode_indices(sample_codes_autoregressive(service.prior, 3, 4, 8, y=[1, 0, 1, 0]))[:3].numpy()
        for wire in ("npy", "json"):
            np.testing.assert_allclose(ServingClient(url, wire=wire).sample(3, 3, labels=[1, 0, 1]), want,
                                       rtol=0, atol=1e-6)
        x = np.random.default_rng(0).uniform(size=(1, 32, 32, 1)).astype(np.float32)
        with torch.inference_mode():
            mask = np.zeros((8, 8), bool)
            mask[:, :3] = True
            want = vq.decode_indices(sample_codes_autoregressive(
                service.prior, 2, 1, 8, y=[1], known=vq.encode_indices(torch.from_numpy(x)), known_mask=mask)).numpy()
        for wire in ("npy", "json"):
            got = ServingClient(url, wire=wire).continue_(x, keep_cols=3, seed=2, labels=1)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        with pytest.raises(ServingError, match="is required") as err:
            c.sample(2, 0)
        assert err.value.status == 400
        with pytest.raises(ServingError, match=r"labels must be in \[0, 1\]"):
            c.sample(2, 0, labels=2)
    finally:
        _stop(httpd)

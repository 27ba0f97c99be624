"""Serving in the PyTorch port: the micro-batcher (the cases of
``tests/test_serving.py``), the npy wire, and the HTTP server on port 0
against the JAX package's ``InferenceService.from_parts`` on the same
weights, over both wires; the client; the status codes (400, 404, 413,
500); the served model's dtype for a bf16 checkpoint; the option not
ported yet and the combinations refused.

Small widths (input 32, hidden (8, 16, 16), latent 4, FoldedVAE fold 4),
f32 on the CPU. Tolerances: served reconstructions, encodings and
interpolation paths within 1e-5 absolute of the JAX service's (the JSON
wire round-trips floats through their shortest repr, exact for f32);
the same model served against itself bitwise.
"""

import http.client
import io
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from midi_vae_tpu.serving.batcher import MicroBatcher as JaxMicroBatcher
from midi_vae_tpu.serving.server import InferenceService as JaxInferenceService
from midi_vae_tpu.serving.wire import npy_loads as jax_npy_loads
from midi_vae_tpu_torch.cli.generate import _load_model_and_state
from midi_vae_tpu_torch.io.checkpoint import save_checkpoint
from midi_vae_tpu_torch.models.registry import build_model
from midi_vae_tpu_torch.ops.cuda_lib import BUILD_DIR_ENV
from midi_vae_tpu_torch.serving import server as server_mod
from midi_vae_tpu_torch.serving.batcher import MicroBatcher, _bucket
from midi_vae_tpu_torch.serving.client import ServingClient, ServingError
from midi_vae_tpu_torch.serving.wire import NPY_CONTENT_TYPE, npy_dumps, npy_loads
from midi_vae_tpu_torch.train.state import create_train_state, state_dict
from test_torch_inference import MODEL_KW, _pair

ATOL = 1e-5

# ---------------------------------------------------------------- batcher


@pytest.mark.parametrize("n,bucket", [(1, 1), (3, 4), (64, 64), (65, 128), (300, 512)])
def test_bucket_rounds_up(n, bucket):
    assert _bucket(n) == bucket


def test_result_roundtrip_and_error_propagation():
    batcher = MicroBatcher(lambda x: x * 2.0, max_wait_ms=1.0)
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    np.testing.assert_array_equal(batcher(x), x * 2)
    batcher.close()

    def boom(x):
        raise ValueError("boom")

    batcher = MicroBatcher(boom, max_wait_ms=1.0)
    with pytest.raises(ValueError, match="boom"):
        batcher(np.zeros((1, 2), np.float32))
    assert batcher._thread.is_alive()  # the dispatcher survives
    batcher.close()


def test_concurrent_requests_coalesce():
    calls = []

    def fn(x):
        calls.append(len(x))
        time.sleep(0.01)
        return x + 1.0

    batcher = MicroBatcher(fn, max_batch=64, max_wait_ms=50.0)
    futs = [batcher.submit(np.full((2, 3), float(i), np.float32)) for i in range(8)]
    for i, f in enumerate(futs):
        np.testing.assert_array_equal(f.result(timeout=5), np.full((2, 3), float(i) + 1.0))
    assert batcher.batches_dispatched < 8 and batcher.requests_served == 8
    assert all(c in (1, 2, 4, 8, 16, 32, 64) for c in calls)  # padded to bucket sizes
    batcher.close()


@pytest.mark.parametrize("case", ["mismatch_after_first", "fixed_item_shape", "empty", "closed"])
def test_bad_submit_is_refused_at_its_own_call(case):
    """A malformed request is refused at its own submit(); a request in
    flight beside it is served, and the dispatcher survives."""
    item_shape = (4, 4, 1) if case == "fixed_item_shape" else None
    batcher = MicroBatcher(lambda x: x, max_batch=64, max_wait_ms=30.0, item_shape=item_shape)
    if case == "closed":
        batcher.close()
        with pytest.raises(RuntimeError, match="closed"):
            batcher.submit(np.zeros((1, 2)))
        return
    good = batcher.submit(np.zeros((1, 4, 4, 1), np.float32)) if case == "mismatch_after_first" else None
    bad = np.zeros((0, 4, 4, 1), np.float32) if case == "empty" else np.zeros((1, 8, 8, 1), np.float32)
    with pytest.raises(ValueError, match="non-empty" if case == "empty" else "item shape"):
        batcher.submit(bad)
    if good is not None:
        assert good.result(timeout=5).shape == (1, 4, 4, 1)
    assert batcher._thread.is_alive()
    assert batcher(np.ones((3, 4, 4, 1), np.float32)).shape == (3, 4, 4, 1)
    batcher.close()


@pytest.mark.parametrize("sizes", [(5, 5, 5, 5), (20,)], ids=["coalescing", "oversized_submit"])
def test_max_batch_is_a_hard_cap_as_in_jax(sizes):
    """fn never sees more than max_batch rows, coalesced or chunked; an
    oversized submit counts one device batch per chunk. The JAX batcher
    given the same requests makes the same calls."""

    def drive(cls):
        calls = []

        def fn(x):
            calls.append(len(x))
            time.sleep(0.005)
            return x * 2

        batcher = cls(fn, max_batch=8, max_wait_ms=30.0)
        xs = [np.arange(n * 2, dtype=np.float32).reshape(n, 2) + i for i, n in enumerate(sizes)]
        futs = [batcher.submit(x) for x in xs]
        for x, f in zip(xs, futs):
            np.testing.assert_array_equal(f.result(timeout=5), x * 2)
        counters = (batcher.batches_dispatched, batcher.requests_served)
        batcher.close()
        return calls, counters

    calls, counters = drive(MicroBatcher)
    assert all(c <= 8 for c in calls), calls
    assert counters[0] == len(calls) and counters[1] == len(sizes)
    if sizes == (20,):
        assert calls == [8, 8, 4]
        assert drive(JaxMicroBatcher) == (calls, counters)


def test_close_never_strands_a_carried_request():
    def slow_double(x):
        time.sleep(0.2)
        return x * 2

    batcher = MicroBatcher(slow_double, max_batch=4, max_wait_ms=500)
    f_a = batcher.submit(np.ones((4, 2), np.float32))  # tick 1 dispatches
    time.sleep(0.05)
    f_b = batcher.submit(np.ones((3, 2), np.float32))  # tick 2 head
    f_c = batcher.submit(np.ones((4, 2), np.float32))  # overflows: carried
    time.sleep(0.25)  # tick 2 is dispatching f_b with f_c parked
    batcher.close()
    np.testing.assert_array_equal(f_a.result(timeout=5), np.full((4, 2), 2, np.float32))
    np.testing.assert_array_equal(f_b.result(timeout=5), np.full((3, 2), 2, np.float32))
    with pytest.raises(RuntimeError, match="closed"):
        f_c.result(timeout=5)


# ------------------------------------------------------------------- wire


def test_npy_declared_size_must_match_payload():
    body = npy_dumps(np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError, match="declares"):
        npy_loads(body[:-8])
    with pytest.raises(ValueError, match="declares"):
        npy_loads(body + b"\x00" * 8)
    with pytest.raises(ValueError, match="malformed npy"):
        npy_loads(b"\x93NUMPY\x01\x00garbage-after-magic")
    np.testing.assert_array_equal(npy_loads(body), np.zeros((4, 4), np.float32))


def test_npy_fuzz_never_escapes_value_error_and_agrees_with_jax():
    """Any byte string parses or raises ValueError, as the JAX wire does on
    the same bytes."""
    rng = np.random.default_rng(1234)
    valid = npy_dumps(rng.uniform(size=(8, 8)).astype(np.float32))
    bodies = [b"", b"\x93NUMPY", valid[: len(valid) // 2], valid]
    for _ in range(200):
        n = int(rng.integers(0, 256))
        bodies.append(rng.bytes(n))
        bodies.append(b"\x93NUMPY" + rng.bytes(n))
        mutated = bytearray(valid)
        for pos in rng.integers(0, len(valid), size=4):
            mutated[int(pos)] = int(rng.integers(0, 256))
        bodies.append(bytes(mutated))
    parsed = 0
    for body in bodies:
        try:
            out = npy_loads(body)
        except ValueError:
            with pytest.raises(ValueError):
                jax_npy_loads(body)
            continue
        np.testing.assert_array_equal(out, jax_npy_loads(body))
        parsed += 1
    assert 0 < parsed < len(bodies)


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
    """The port's server over the FoldedVAE of test_torch_inference, and the
    JAX package's service over the same weights."""
    jmodel, v, model = _pair("FoldedVAE")
    httpd, url = _start(server_mod.InferenceService.from_parts(model, 32, 1))
    jax_service = JaxInferenceService.from_parts(jmodel, v["params"], v["batch_stats"], 32, 1)
    yield {"url": url, "model": model, "service": httpd.service, "jax": jax_service}
    _stop(httpd)
    jax_service.close()


def _x(n, seed):
    return np.random.default_rng(seed).uniform(0, 1, (n, 32, 32, 1)).astype(np.float32)


@pytest.mark.parametrize("wire", ["npy", "json"])
def test_reconstruct_and_encode_match_jax(served, wire):
    c = ServingClient(served["url"], wire=wire)
    x = _x(3, 11)
    np.testing.assert_allclose(c.reconstruct(x), np.asarray(served["jax"].reconstruct(x)), rtol=0, atol=ATOL)
    mu, log_var = c.encode(x)
    want = np.asarray(served["jax"].encode(x))
    np.testing.assert_allclose(np.concatenate([mu, log_var], axis=1), want, rtol=0, atol=ATOL)
    assert c.reconstruct(x[0]).shape == (1, 32, 32, 1)  # one [H, W, C] image


@pytest.mark.parametrize("slerp", [False, True], ids=["lerp", "slerp"])
@pytest.mark.parametrize("wire", ["npy", "json"])
def test_interpolate_matches_jax(served, wire, slerp):
    x = _x(2, 12)
    got = ServingClient(served["url"], wire=wire).interpolate(x[0], x[1], steps=5, slerp=slerp)
    want = served["jax"].interpolate(x[0], x[1], steps=5, mode="slerp" if slerp else "lerp")
    assert got.shape == (5, 32, 32, 1)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)


def test_sample_both_wires_and_healthz(served):
    s_npy = ServingClient(served["url"]).sample(3, seed=1)
    s_json = ServingClient(served["url"], wire="json").sample(3, seed=1)
    assert s_npy.shape == (3, 32, 32, 1) and ((s_npy >= 0) & (s_npy <= 1)).all()
    np.testing.assert_array_equal(s_npy, s_json)
    np.testing.assert_array_equal(s_npy, served["service"].sample(3, seed=1))
    health = ServingClient(served["url"]).healthz()
    with urllib.request.urlopen(served["url"] + "/healthz", timeout=10) as resp:
        assert json.loads(resp.read()) == {**health, "requests_served": health["requests_served"]}
    jax_keys = {"status", "model", "image_size", "latent_dim", "conditional", "num_classes", "prior",
                "batches_dispatched", "requests_served", "encode_batches_dispatched", "encode_requests_served"}
    assert jax_keys <= set(health) and health["status"] == "ok" and health["latent_dim"] == 4
    assert health["device"] == "cpu" and health["model"] == "FoldedVAE"


def test_reconstruct_is_the_deterministic_posterior_mean(served):
    x = _x(2, 4)
    c = ServingClient(served["url"])
    r1, r2 = c.reconstruct(x), c.reconstruct(x)
    np.testing.assert_array_equal(r1, r2)
    model = served["model"]
    with torch.inference_mode():
        want = model.decode(model.encode(torch.from_numpy(x), train=False).mu, train=False)
    np.testing.assert_allclose(r1, want.numpy(), rtol=0, atol=1e-6)


def _raw_post(url, body: bytes, headers: dict):
    req = urllib.request.Request(url, data=body, headers=headers)
    with pytest.raises(urllib.error.HTTPError) as exc_info:
        urllib.request.urlopen(req, timeout=30)
    err = exc_info.value
    assert err.headers.get("Content-Type") == "application/json"  # errors are JSON on both wires
    return err.code, json.loads(err.read())["error"]


def _huge_header_body():
    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(buf, {"descr": "<f4", "fortran_order": False, "shape": (200000, 128, 128, 1)})
    return buf.getvalue() + b"\x00" * 16  # 12.5 GB declared, 16 bytes carried


JSON_H = {"Content-Type": "application/json"}
NPY_H = {"Content-Type": NPY_CONTENT_TYPE}
BAD_REQUESTS = {
    "missing_field": ("/reconstruct", b'{"wrong": 1}', JSON_H, 400, "images"),
    "malformed_json": ("/reconstruct", b"{not json", JSON_H, 400, "Expecting"),
    "json_not_an_object": ("/sample", b"[1, 2]", JSON_H, 400, "must be an object"),
    "oversized_sample": ("/sample", json.dumps({"n": 10**6}).encode(), JSON_H, 400, "n must be"),
    "oversized_reconstruct": ("/reconstruct", json.dumps({"images": np.zeros((1025, 1, 1, 1)).tolist()}).encode(),
                              JSON_H, 400, "at most"),
    "oversized_reconstruct_npy": ("/reconstruct", npy_dumps(np.zeros((1025, 4, 4, 1), np.float32)), NPY_H, 400,
                                  "at most"),
    "wrong_item_shape": ("/encode", npy_dumps(np.zeros((2, 8, 8, 1), np.float32)), NPY_H, 400, "item shape"),
    "interpolate_steps": ("/interpolate", json.dumps({"a": np.zeros((32, 32, 1)).tolist(),
                                                      "b": np.zeros((32, 32, 1)).tolist(),
                                                      "steps": 100000}).encode(), JSON_H, 400, "steps must be"),
    "interpolate_shape": ("/interpolate", json.dumps({"a": np.zeros((8, 8, 1)).tolist(),
                                                      "b": np.zeros((8, 8, 1)).tolist()}).encode(),
                          JSON_H, 400, "must have shape"),
    "interpolate_npy_rank": ("/interpolate", npy_dumps(np.zeros((3, 32, 32, 1), np.float32)), NPY_H, 400,
                             "[2,H,W,C]"),
    "binary_sample_body": ("/sample", npy_dumps(np.zeros((1,), np.float32)), NPY_H, 400, "JSON parameters"),
    "truncated_npy": ("/reconstruct", npy_dumps(np.zeros((1, 32, 32, 1), np.float32))[:-64], NPY_H, 400, "declares"),
    "garbage_npy": ("/reconstruct", b"not an npy file at all", NPY_H, 400, "malformed npy"),
    "huge_header_npy": ("/reconstruct", _huge_header_body(), NPY_H, 400, "declares"),
    "label_on_unconditional": ("/reconstruct", json.dumps({"images": np.zeros((1, 32, 32, 1)).tolist(),
                                                           "label": 1}).encode(), JSON_H, 400, "unconditional"),
    "temperature_without_prior": ("/sample", json.dumps({"n": 2, "temperature": 0.5}).encode(), JSON_H, 400,
                                  "no code prior attached"),
    "top_p_without_prior": ("/sample", json.dumps({"n": 2, "top_p": 0.9}).encode(), JSON_H, 400,
                            "no code prior attached"),
    "continue_not_ported": ("/continue", json.dumps({"images": [], "keep_cols": 1}).encode(), JSON_H, 400,
                            "needs a code prior"),
    "unknown_path": ("/nope", b"{}", JSON_H, 404, "unknown path"),
}


@pytest.mark.parametrize("case", list(BAD_REQUESTS))
def test_bad_requests_are_answered_with_json_errors(served, case):
    path, body, headers, code, message = BAD_REQUESTS[case]
    got_code, got_message = _raw_post(served["url"] + path, body, headers)
    assert got_code == code and message in got_message, (got_code, got_message)


def test_oversized_body_is_413_before_it_is_read(served):
    host, port = served["url"].removeprefix("http://").split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=10)
    try:
        conn.putrequest("POST", "/reconstruct")
        conn.putheader("Content-Type", NPY_CONTENT_TYPE)
        conn.putheader("Content-Length", str(300 * (1 << 20)))
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 413 and "exceeds" in json.loads(resp.read())["error"]
    finally:
        conn.close()


def test_server_side_failure_is_500(served, monkeypatch):
    def failing(*args, **kwargs):
        raise RuntimeError("device lost")

    monkeypatch.setattr(served["service"], "sample", failing)
    with pytest.raises(ServingError) as exc_info:
        ServingClient(served["url"]).sample(2)
    assert exc_info.value.status == 500 and "device lost" in exc_info.value.message


def test_client_raises_typed_errors(served):
    with pytest.raises(ServingError) as exc_info:
        ServingClient(served["url"]).sample(10**6)
    assert exc_info.value.status == 400 and "n must be" in exc_info.value.message
    with pytest.raises(ValueError, match="wire"):
        ServingClient(served["url"], wire="xml")


def test_concurrent_clients_coalesce_and_each_gets_its_rows():
    """16 client threads × 4 requests of 1-3 images each, a short thread
    switch interval: every answer is its own request's reconstruction,
    and requests shared device batches."""
    _, _, model = _pair("FoldedVAE")
    httpd, url = _start(server_mod.InferenceService.from_parts(model, 32, 1, max_wait_ms=20.0))
    rng = np.random.default_rng(0)
    requests = [[_x(int(rng.integers(1, 4)), 100 + 4 * t + i) for i in range(4)] for t in range(16)]
    with torch.inference_mode():
        want = {id(x): model.decode(model.encode(torch.from_numpy(x), train=False).mu, train=False).numpy()
                for reqs in requests for x in reqs}
    errors, done = [], []

    def worker(reqs):
        c = ServingClient(url)
        try:
            for x in reqs:
                np.testing.assert_allclose(c.reconstruct(x), want[id(x)], rtol=0, atol=1e-6)
            done.append(1)
        except Exception as e:  # noqa: BLE001 - collected and asserted below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(reqs,)) for reqs in requests]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        health = ServingClient(url).healthz()
        _stop(httpd)
    assert not errors and len(done) == 16
    assert health["requests_served"] == 64 and health["batches_dispatched"] < 64
    assert server_mod.HTTPServer.request_queue_size >= 16  # no connect of the burst is dropped


# ------------------------------------------------------------- checkpoint


def _write_checkpoint(path, *, dtype, ema_shift=None):
    model = build_model("FoldedVAE", dtype=dtype, device="cpu", seed=3, **MODEL_KW)
    state = create_train_state(model, _optimizer(model), ema=ema_shift is not None)
    if ema_shift is not None:
        for t in state.ema_params.values():
            t.add_(ema_shift)
    config = {"arch": "FoldedVAE", "dataset_name": "midi-synthetic", "n_features": 4, "hidden_dims": [8, 16, 16],
              "fold": 4, "dtype": "bfloat16" if dtype == torch.bfloat16 else "float32", "image_size": 32}
    save_checkpoint(path, state_dict(state), config=config, encoder_config={"input_size": 32, "n_feature": 4})
    return model


def _optimizer(model):
    from midi_vae_tpu_torch.models.vae import param_group_label
    from midi_vae_tpu_torch.train.optim import build_optimizer

    return build_optimizer(model, param_group_label)


def test_bf16_checkpoint_is_served_in_f32(tmp_path):
    """JAX builds the served model without the config's dtype, so a bf16
    run is served in f32; so does the port."""
    path = str(tmp_path / "bf16.pt")
    trained = _write_checkpoint(path, dtype=torch.bfloat16)
    service = server_mod.InferenceService(path, device="cpu")
    try:
        model = service.model
        assert model.dtype == torch.float32 and all(p.dtype == torch.float32 for p in model.parameters())
        assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(), trained.state_dict().values()))
        x = _x(2, 5)
        out = service.reconstruct(x)
        assert out.dtype == np.float32
        with torch.inference_mode():
            f32 = model.decode(model.encode(torch.from_numpy(x), train=False).mu, train=False).numpy()
            bf16 = trained.decode(trained.encode(torch.from_numpy(x), train=False).mu, train=False).float().numpy()
        np.testing.assert_array_equal(out, f32)
        assert np.abs(out - bf16).max() > 1e-4  # the bf16 compute would differ
    finally:
        service.close()


def test_loader_prefers_ema_weights(tmp_path):
    path = str(tmp_path / "ema.pt")
    trained = _write_checkpoint(path, dtype=torch.float32, ema_shift=0.5)
    ema, *_ = _load_model_and_state(path, device="cpu")
    raw, cfg, size, channels, dataset = _load_model_and_state(path, use_ema=False, device="cpu")
    assert (size, channels, dataset) == (32, 1, "midi-synthetic") and cfg["arch"] == "FoldedVAE"
    for (name, p), q, r in zip(trained.named_parameters(), ema.parameters(), raw.parameters()):
        assert torch.equal(r, p) and torch.equal(q, p + 0.5), name


# ------------------------------------------------------- not ported yet


@pytest.mark.parametrize(
    "call,error,match",
    [
        (lambda p: server_mod.serve(artifact="dir", prior="prior.pt", device="cpu"), ValueError,
         "carry their prior from export time"),
        (lambda p: server_mod.serve(p, prior="prior.pt", device="cpu"), ValueError, "needs a VQ-VAE checkpoint"),
        (lambda p: server_mod.cli(["--artifact", "dir", "--prior", "x", "--cpu"]), ValueError,
         "carry their prior from export time"),
        (lambda p: server_mod.cli(["--checkpoint", p, "--prior", "x", "--cpu"]), ValueError, "needs a VQ-VAE"),
        (lambda p: server_mod.cli(["--checkpoint", p, "--compilation-cache", os.path.join(os.path.dirname(p), "c"),
                                   "--prior", "x", "--cpu"]), ValueError, "needs a VQ-VAE"),
        (lambda p: server_mod.InferenceService(p, prior_path="x", device="cpu"), ValueError, "needs a VQ-VAE"),
    ],
    ids=["serve_artifact", "serve_prior", "cli_artifact", "cli_prior", "cli_compilation_cache", "service_prior"],
)
def test_unported_serving_options_raise_with_their_roadmap_item(tmp_path, monkeypatch, request, call, error, match):
    """--compilation-cache, --artifact and --prior are ported, and refuse
    what the JAX server refuses: --prior beside --artifact (the artifact's
    prior is baked at export; ``tests/test_torch_aot_export.py`` serves
    artifacts), and --prior on this Gaussian checkpoint, also after
    --compilation-cache has pointed the build directories into its DIR."""
    for env in (BUILD_DIR_ENV, "TRITON_CACHE_DIR", "TORCHINDUCTOR_CACHE_DIR"):
        monkeypatch.delenv(env, raising=False)
    path = str(tmp_path / "c.pt")
    _write_checkpoint(path, dtype=torch.float32)
    with pytest.raises(error, match=match):
        call(path)
    if request.node.callspec.id == "cli_compilation_cache":
        assert os.environ["TRITON_CACHE_DIR"] == str(tmp_path / "c" / "triton")


def test_serve_starts_on_port_0_and_refuses_without_a_gpu(tmp_path):
    path = str(tmp_path / "c.pt")
    _write_checkpoint(path, dtype=torch.float32)
    httpd = server_mod.serve(path, port=0, device="cpu")
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        assert ServingClient(url).healthz()["model"] == "FoldedVAE"
    finally:
        _stop(httpd)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server_mod.serve(path, port=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server_mod.cli(["--checkpoint", path, "--skip-backend-check"])
    assert jax.default_backend() == "cpu"


def test_cli_probes_the_gpu_before_it_binds(tmp_path, monkeypatch, capsys):
    """Without --cpu or --skip-backend-check the server runs the backend
    probe first and exits 1, as the JAX server does, when it fails."""
    from midi_vae_tpu_torch.core import backend_check

    path = str(tmp_path / "c.pt")
    _write_checkpoint(path, dtype=torch.float32)
    calls = []
    monkeypatch.setattr(backend_check, "backend_alive", lambda *a, **k: calls.append(1) or False)
    with pytest.raises(SystemExit) as info:
        server_mod.cli(["--checkpoint", path])
    assert info.value.code == 1 and calls == [1]
    assert "FATAL: CUDA backend unreachable" in capsys.readouterr().err
    with pytest.raises(ValueError, match="needs a VQ-VAE"):  # --cpu skips the probe
        server_mod.cli(["--checkpoint", path, "--cpu", "--prior", "x"])
    assert calls == [1]

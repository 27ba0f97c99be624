"""HTTP inference server over a trained checkpoint (counterpart of
``midi_vae_tpu/serving/server.py``).

A stdlib ``ThreadingHTTPServer`` around :class:`InferenceService`:

- ``POST /reconstruct``: body ``{"images": [[...]]}`` (nested lists,
  [N, H, W, C] or [H, W, C]) → ``{"reconstructions": [...]}``, the
  posterior-mean decode (no draw);
- ``POST /encode``: the same input → ``{"mu": [...], "log_var": [...]}``;
- ``POST /sample``: ``{"n": 4, "seed": 0}`` → ``{"samples": [...]}``;
- ``POST /interpolate``: ``{"a": [...], "b": [...], "steps": 8,
  "slerp": false}`` ([H, W, C] endpoints) → ``{"path": [...]}``;
- ``GET /healthz``: liveness, the model and the batchers' counters.

Run: ``python -m midi_vae_tpu_torch.serving.server --checkpoint CKPT --port 8000``
(on the GPU; ``--cpu`` on the CPU).

/reconstruct and /encode go through a :class:`MicroBatcher` each
(concurrent requests coalesce into one forward on the device);
/sample and /interpolate run on the handler's thread (already batched by
``n`` and ``steps``). Every thread shares one model and calls it with
``train=False`` as an argument: nothing switches the module's mode. A
dispatch copies its padded batch to the device once and its result back
once; the copy back is the request's synchronisation with the device.

**Binary wire format**: /reconstruct, /encode and /interpolate also take a
raw ``.npy`` body (``Content-Type: application/x-npy`` or
``application/octet-stream``; /interpolate one [2, H, W, C] array with
``steps`` and ``slerp`` on the query string), and every endpoint answers
``.npy`` when the request is binary or sends ``Accept:
application/x-npy``. The npy /encode answer is one [N, 2·latent_dim]
array, ``mu ‖ log_var``. Errors are always JSON: 400 for the client's
faults, 413 for an oversized body, 500 for the server's own.

Not ported yet: ``--artifact`` (``torch.export`` artifacts, ROADMAP item
15), ``--prior`` and ``/continue`` (two-stage VQ sampling, item 13),
``--compilation-cache`` and labels of conditional models (item 17).
"""

from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlsplit

import numpy as np
import torch

from midi_vae_tpu_torch.core.device import DeviceLike
from midi_vae_tpu_torch.serving.batcher import MicroBatcher, _bucket
from midi_vae_tpu_torch.serving.wire import BINARY_CONTENT_TYPES, NPY_CONTENT_TYPE, npy_dumps, npy_loads


def _not_ported(what: str, item: int) -> str:
    return f"{what} is not ported to the PyTorch package yet (ROADMAP Queue 1 item {item})"


class InferenceService:
    """The model's serving entry points and their batchers, built from a
    checkpoint on ``device`` (the GPU unless the caller asks for the CPU)
    or from an in-memory model (:meth:`from_parts`)."""

    MAX_SAMPLES = 1024  # bounds the [n, H, W, C] result of one /sample
    MAX_INTERPOLATE_STEPS = 64  # bounds the [steps, H, W, C] result of one /interpolate

    def __init__(
        self, checkpoint_path: str, *, max_batch: int = 64, max_wait_ms: float = 2.0,
        device: DeviceLike = "cuda", prior_path: Optional[str] = None,
    ):
        if prior_path is not None:
            raise NotImplementedError(_not_ported("--prior (two-stage VQ sampling)", 13))
        from midi_vae_tpu_torch.cli.generate import _load_model_and_state

        model, _, image_size, channels, _ = _load_model_and_state(checkpoint_path, device=device)
        self._init_from_parts(model, image_size, channels, max_batch=max_batch, max_wait_ms=max_wait_ms)

    @classmethod
    def from_parts(
        cls, model, image_size: int, channels: int = 1, *, max_batch: int = 64, max_wait_ms: float = 2.0,
    ) -> "InferenceService":
        """A service over an in-memory model (no checkpoint file), on the
        model's device."""
        self = cls.__new__(cls)
        self._init_from_parts(model, image_size, channels, max_batch=max_batch, max_wait_ms=max_wait_ms)
        return self

    def _init_from_parts(self, model, image_size, channels, *, max_batch=64, max_wait_ms=2.0):
        self.model = model
        self.device = next(model.parameters()).device
        self.model_name = type(model).__name__
        self.image_size, self.channels = image_size, channels
        self.latent_dim = int(model.latent_dim)
        item_shape = (image_size, image_size, channels)
        self.reconstruct = MicroBatcher(
            self._reconstruct_rows, max_batch=max_batch, max_wait_ms=max_wait_ms, item_shape=item_shape
        )
        self.encode = MicroBatcher(self._encode_rows, max_batch=max_batch, max_wait_ms=max_wait_ms, item_shape=item_shape)

    def _to_device(self, rows: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(rows, np.float32)).to(self.device)

    def _reconstruct_rows(self, rows: np.ndarray) -> np.ndarray:
        """Posterior-mean decode of one padded batch (the batcher's ``fn``):
        encode → mu → decode, no draw, so a request reconstructs the same
        way every time."""
        with torch.inference_mode():
            x = self._to_device(rows)
            out = self.model.decode(self.model.encode(x, train=False).mu, train=False)
            return out.float().cpu().numpy()

    def _encode_rows(self, rows: np.ndarray) -> np.ndarray:
        """[B, 2·latent_dim] ``mu ‖ log_var`` of one padded batch."""
        with torch.inference_mode():
            enc = self.model.encode(self._to_device(rows), train=False)
            return torch.cat([enc.mu, enc.log_var], dim=-1).float().cpu().numpy()

    def sample(self, n: int, seed: int = 0) -> np.ndarray:
        """``n`` prior samples [n, H, W, C]: ``bucket(n)`` rows drawn from
        ``seed`` and decoded, the first ``n`` returned (so ``sample(3, s)``
        is the first 3 rows of ``sample(4, s)``, and the decode meets few
        batch shapes)."""
        from midi_vae_tpu_torch.evaluation.inference import sample_prior

        if not (1 <= n <= self.MAX_SAMPLES):
            raise ValueError(f"n must be in [1, {self.MAX_SAMPLES}], got {n}")
        return sample_prior(self.model, _bucket(n), seed).float().cpu().numpy()[:n]

    def interpolate(self, a: np.ndarray, b: np.ndarray, steps: int, mode: str) -> np.ndarray:
        """The latent path [steps, H, W, C] between two [H, W, C] images."""
        from midi_vae_tpu_torch.evaluation.inference import interpolate

        # this path runs outside the micro-batcher: bound the result here
        if not (2 <= steps <= self.MAX_INTERPOLATE_STEPS):
            raise ValueError(f"steps must be in [2, {self.MAX_INTERPOLATE_STEPS}], got {steps}")
        expect = (self.image_size, self.image_size, self.channels)
        for name, arr in (("a", a), ("b", b)):
            if tuple(arr.shape) != expect:
                raise ValueError(f"'{name}' must have shape {expect}, got {tuple(arr.shape)}")
        ends = self._to_device(np.stack([a, b]))
        return interpolate(self.model, ends[:1], ends[1:], steps=steps, mode=mode)[:, 0].float().cpu().numpy()

    def close(self):
        self.reconstruct.close()
        self.encode.close()


def make_handler(service: InferenceService):
    class Handler(BaseHTTPRequestHandler):
        # caps: one request must not allocate an unbounded device batch or
        # buffer an unbounded body
        MAX_REQUEST_ITEMS = 1024
        MAX_BODY_BYTES = 256 * (1 << 20)

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, payload: dict):
            self._send(code, json.dumps(payload).encode(), "application/json")

        def _npy(self, code: int, arr: np.ndarray):
            self._send(code, npy_dumps(np.asarray(arr, np.float32)), NPY_CONTENT_TYPE)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {
                    "status": "ok",
                    "model": service.model_name,
                    "device": str(service.device),
                    "image_size": service.image_size,
                    "latent_dim": service.latent_dim,
                    "conditional": False,
                    "num_classes": 0,
                    "prior": None,
                    "batches_dispatched": service.reconstruct.batches_dispatched,
                    "requests_served": service.reconstruct.requests_served,
                    "encode_batches_dispatched": service.encode.batches_dispatched,
                    "encode_requests_served": service.encode.requests_served,
                })
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            try:
                split = urlsplit(self.path)
                route, query = split.path, parse_qs(split.query)
                length = int(self.headers.get("Content-Length", "0"))
                if length > self.MAX_BODY_BYTES:
                    self._json(413, {"error": f"body exceeds {self.MAX_BODY_BYTES} bytes"})
                    return
                raw = self.rfile.read(length)
                ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip().lower()
                binary_req = ctype in BINARY_CONTENT_TYPES
                # binary in → binary out; JSON clients opt in with Accept
                wants_npy = binary_req or NPY_CONTENT_TYPE in (self.headers.get("Accept") or "")
                payload = {} if binary_req else json.loads(raw or b"{}")
                if not isinstance(payload, dict):
                    raise ValueError("a JSON body must be an object")

                # fields of features not ported yet: labels of conditional
                # models, and the sampling knobs of a code prior
                if {"label", "labels"} & (set(query) | set(payload)):
                    raise ValueError("this checkpoint is unconditional; drop the label field")
                if float(payload.get("temperature", 1.0)) != 1.0 or payload.get("top_p") is not None:
                    raise ValueError("temperature and top_p apply to prior-backed (two-stage) sampling: "
                                     + _not_ported("--prior", 13))

                if route == "/sample":
                    if binary_req:
                        raise ValueError("/sample takes JSON parameters ({'n', 'seed'}), not a tensor body")
                    out = service.sample(int(payload.get("n", 1)), int(payload.get("seed", 0)))
                    self._npy(200, out) if wants_npy else self._json(200, {"samples": out.tolist()})
                elif route == "/interpolate":
                    if binary_req:
                        # one npy [2, H, W, C] array carries both endpoints;
                        # steps and slerp ride the query string
                        ends = np.asarray(npy_loads(raw), np.float32)
                        if ends.ndim != 4 or len(ends) != 2:
                            raise ValueError(f"binary /interpolate expects one [2,H,W,C] array, got {ends.shape}")
                        a, b = ends[0], ends[1]
                        steps = int(query.get("steps", ["8"])[0])
                        mode = "slerp" if query.get("slerp", ["0"])[0].lower() in ("1", "true", "yes") else "lerp"
                    else:
                        a = np.asarray(payload["a"], np.float32)
                        b = np.asarray(payload["b"], np.float32)
                        steps = int(payload.get("steps", 8))
                        mode = "slerp" if payload.get("slerp") else "lerp"
                    out = service.interpolate(a, b, steps=steps, mode=mode)
                    self._npy(200, out) if wants_npy else self._json(200, {"path": out.tolist()})
                elif route == "/continue":
                    raise ValueError(_not_ported("/continue (two-stage VQ continuation)", 13))
                elif route in ("/reconstruct", "/encode"):
                    x = np.asarray(npy_loads(raw) if binary_req else payload["images"], np.float32)
                    if x.ndim == 3:
                        x = x[None]
                    if len(x) > self.MAX_REQUEST_ITEMS:
                        raise ValueError(f"at most {self.MAX_REQUEST_ITEMS} images per request, got {len(x)}")
                    out = getattr(service, route[1:])(x)
                    if wants_npy:
                        self._npy(200, out)  # /encode: [N, 2·latent_dim], mu ‖ log_var
                    elif route == "/reconstruct":
                        self._json(200, {"reconstructions": out.tolist()})
                    else:
                        d = service.latent_dim
                        self._json(200, {"mu": out[:, :d].tolist(), "log_var": out[:, d:].tolist()})
                else:
                    self._json(404, {"error": "unknown path"})
            # EOFError: truncated npy bodies
            except (ValueError, KeyError, TypeError, EOFError) as e:
                self._json(400, {"error": str(e)})  # malformed input is the client's fault
            except Exception as e:  # noqa: BLE001 - report, don't crash the server
                # device and batcher failures are the server's: 5xx, so monitors
                # see a failing server, not a bad client
                self._json(500, {"error": str(e)})

    return Handler


class HTTPServer(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` with a listen backlog for concurrent clients:
    socketserver's default of 5 pending connections drops the connects of a
    burst of clients, which the kernel then retries after a second."""

    request_queue_size = 128


def make_server(service: InferenceService, host: str = "127.0.0.1", port: int = 0) -> HTTPServer:
    """An HTTP server for ``service``, serving in a background thread; it
    carries the service as ``.service``."""
    httpd = HTTPServer((host, port), make_handler(service))
    httpd.service = service  # type: ignore[attr-defined]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def serve(
    checkpoint: Optional[str] = None,
    port: int = 8000,
    host: str = "127.0.0.1",
    *,
    device: DeviceLike = "cuda",
    artifact: Optional[str] = None,
    prior: Optional[str] = None,
) -> HTTPServer:
    """Start serving ``checkpoint`` on ``device`` in a background thread and
    return the server (``port=0`` picks a free port: ``server_address[1]``).
    Stop it with ``shutdown()``, ``server_close()`` and ``service.close()``."""
    if artifact is not None:
        raise NotImplementedError(_not_ported("serving an exported artifact (torch.export)", 15))
    if prior is not None:
        raise NotImplementedError(_not_ported("--prior (two-stage VQ sampling)", 13))
    if checkpoint is None:
        raise ValueError("pass checkpoint=")
    httpd = make_server(InferenceService(checkpoint, device=device), host, port)
    print(f"serving {checkpoint} on http://{host}:{httpd.server_address[1]} ({httpd.service.device})")
    return httpd


def cli(argv: Optional[list] = None):
    parser = argparse.ArgumentParser(description="Serve a trained VAE checkpoint over HTTP")
    source = parser.add_mutually_exclusive_group(required=True)
    source.add_argument("--checkpoint", help="Training checkpoint (.pt of this package)")
    source.add_argument("--artifact", metavar="DIR", help="Exported artifact (not ported yet, ROADMAP item 15)")
    parser.add_argument("--prior", metavar="PATH", default=None,
                        help="Trained code prior for a VQ checkpoint (not ported yet, ROADMAP item 13)")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--compilation-cache", type=str, default=None, metavar="DIR",
                        help="Persistent compilation cache (not ported yet, ROADMAP item 17)")
    parser.add_argument("--cpu", action="store_true", help="Serve on the CPU instead of the GPU")
    parser.add_argument("--skip-backend-check", action="store_true",
                        help="Accepted for parity; the GPU check is the device's own and always runs")
    args = parser.parse_args(argv)
    if args.artifact is not None:
        raise NotImplementedError(_not_ported("--artifact (torch.export artifacts)", 15))
    if args.prior is not None:
        raise NotImplementedError(_not_ported("--prior (two-stage VQ sampling)", 13))
    if args.compilation_cache:
        raise NotImplementedError(_not_ported("--compilation-cache", 17))
    httpd = serve(args.checkpoint, args.port, args.host, device="cpu" if args.cpu else "cuda")
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        httpd.shutdown()
        httpd.server_close()
        httpd.service.close()


if __name__ == "__main__":
    cli()

"""HTTP inference server over a trained checkpoint (counterpart of
``midi_vae_tpu/serving/server.py``).

A stdlib ``ThreadingHTTPServer`` around :class:`InferenceService`:

- ``POST /reconstruct``: body ``{"images": [[...]]}`` (nested lists,
  [N, H, W, C] or [H, W, C]) → ``{"reconstructions": [...]}``, the
  posterior-mean decode (no draw);
- ``POST /encode``: the same input → ``{"mu": [...], "log_var": [...]}``;
- ``POST /sample``: ``{"n": 4, "seed": 0}`` → ``{"samples": [...]}``; with
  a code prior attached (``--prior``, VQ checkpoints) also
  ``"temperature"`` and ``"top_p"``, drawn as ``generate --prior`` draws;
- ``POST /interpolate``: ``{"a": [...], "b": [...], "steps": 8,
  "slerp": false}`` ([H, W, C] endpoints) → ``{"path": [...]}``;
- ``POST /continue`` (with ``--prior``): ``{"images": [...], "keep_cols":
  8, "seed": 0, "temperature": 1.0, "top_p": null}`` → ``{"continuations":
  [...]}``: each roll's first ``keep_cols`` code-grid time columns kept,
  the rest written by the prior (``generate --mode continue``);
- ``GET /healthz``: liveness, the model, ``conditional`` and
  ``num_classes``, the attached prior, the artifact (``--artifact``) and
  the batchers' counters.

Run: ``python -m midi_vae_tpu_torch.serving.server --checkpoint CKPT [--prior PRIOR] --port 8000``
or ``--artifact DIR`` (on the GPU; ``--cpu`` on the CPU).

**Exported artifacts** (``--artifact DIR``, ``interop/aot_export.py``):
the ``torch.export`` programs back every endpoint, with no model code or
checkpoint: /reconstruct and /encode through the batchers, /sample as the
exported ``decode`` of z drawn here as the checkpoint server draws it (or,
with a prior baked in at export, the loader's two-stage sampler, whose
``top_p`` is fixed at export), /interpolate from the exported ``encode`` and
``decode``. /continue needs a checkpoint-backed prior and is refused, as
in JAX; so is ``--prior`` beside ``--artifact``.

For a VQ checkpoint /encode's ``mu`` is the flattened pre-quantization
latent [N, s·s·D] (``log_var`` zero), /reconstruct and /interpolate decode
through the quantizer, and /sample without a prior draws codes from the
EMA usage marginal.

/reconstruct and /encode go through a :class:`MicroBatcher` each
(concurrent requests coalesce into one forward on the device);
/sample and /interpolate run on the handler's thread (already batched by
``n`` and ``steps``). Every thread shares one model and calls it with
``train=False`` as an argument: nothing switches the module's mode. A
dispatch copies its padded batch to the device once and its result back
once; the copy back is the request's synchronisation with the device.

**Conditional checkpoints** (``--conditional`` runs) need labels on every
endpoint: JSON ``"label"`` (a scalar for every row) or ``"labels"`` (one
per row), or ``?label=K`` / ``?labels=0,3,1`` on the query string of a
binary request. The batchers carry the labels with the rows, so requests
for different classes share one device batch. A class-conditional code
prior takes the same fields on /sample and /continue. A label on an
unconditional deployment, a missing one on a conditional deployment and
one out of range are the client's faults (400).

**Binary wire format**: /reconstruct, /encode, /interpolate and /continue
also take a raw ``.npy`` body (``Content-Type: application/x-npy`` or
``application/octet-stream``; /interpolate one [2, H, W, C] array with
``steps`` and ``slerp`` on the query string, /continue the rolls with
``keep_cols``, ``seed``, ``temperature`` and ``top_p`` there), and every endpoint answers
``.npy`` when the request is binary or sends ``Accept:
application/x-npy``. The npy /encode answer is one [N, 2·latent_dim]
array, ``mu ‖ log_var``. Errors are always JSON: 400 for the client's
faults, 413 for an oversized body, 500 for the server's own.

The CLI probes the GPU in a subprocess before it binds
(``core/backend_check.py``) unless ``--cpu`` or ``--skip-backend-check``,
and exits 1 when the probe fails; ``--compilation-cache DIR`` points the
kernel and compiler caches into DIR (``core/compile_cache.py``).
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlsplit

import numpy as np
import torch

from midi_vae_tpu_torch.core.device import DeviceLike
from midi_vae_tpu_torch.models.vae import label_kwarg
from midi_vae_tpu_torch.serving.batcher import MicroBatcher, _bucket
from midi_vae_tpu_torch.serving.wire import BINARY_CONTENT_TYPES, NPY_CONTENT_TYPE, npy_dumps, npy_loads


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
        from midi_vae_tpu_torch.cli.generate import _load_model_and_state

        model, _, image_size, channels, _ = _load_model_and_state(checkpoint_path, device=device)
        self._init_from_parts(model, image_size, channels, max_batch=max_batch, max_wait_ms=max_wait_ms)
        if prior_path is not None:
            self.attach_prior(prior_path)

    @classmethod
    def from_parts(
        cls, model, image_size: int, channels: int = 1, *, max_batch: int = 64, max_wait_ms: float = 2.0,
    ) -> "InferenceService":
        """A service over an in-memory model (no checkpoint file), on the
        model's device."""
        self = cls.__new__(cls)
        self._init_from_parts(model, image_size, channels, max_batch=max_batch, max_wait_ms=max_wait_ms)
        return self

    @classmethod
    def from_artifact(
        cls, artifact_dir: str, *, max_batch: int = 64, max_wait_ms: float = 2.0, device: DeviceLike = "cuda",
    ) -> "InferenceService":
        """A service over an exported artifact directory on ``device``: the
        programs of ``interop/aot_export.py`` back every endpoint but
        /continue; no model code or checkpoint is read."""
        from midi_vae_tpu_torch.interop.aot_export import AOTServingBundle

        bundle = AOTServingBundle(artifact_dir, device=device)
        m = bundle.manifest
        self = cls.__new__(cls)
        self.model, self._bundle, self.device = None, bundle, bundle.device
        self.model_name = f"{m.get('model', 'unknown')} (AOT artifact)"
        self.artifact_info = {"dir": artifact_dir, "platforms": m["platforms"], "torch_version": m["torch_version"],
                              "programs": sorted(m["programs"])}
        self.image_size, self.channels = int(m["image_size"]), int(m["channels"])
        self.latent_dim = int(m["latent_dim"])
        self.latent_kind = m.get("latent_kind", "gaussian")
        self.prior, self.prior_info = None, m.get("prior")
        self.num_classes = bundle.num_classes
        self.conditional = bundle.conditional
        item_shape = (self.image_size, self.image_size, self.channels)
        kw = dict(max_batch=max_batch, max_wait_ms=max_wait_ms, item_shape=item_shape, labeled=self.conditional)
        self.reconstruct = MicroBatcher(self._artifact_rows(bundle.reconstruct), **kw)
        self.encode = MicroBatcher(self._artifact_rows(bundle.encode), **kw)
        return self

    @staticmethod
    def _artifact_rows(program):
        """A batcher ``fn`` over an exported program: rows (and labels) in, numpy out."""

        def fn(rows: np.ndarray, labels: Optional[np.ndarray] = None) -> np.ndarray:
            args = (rows,) if labels is None else (rows, labels)
            return program(*args).float().cpu().numpy()

        return fn

    def _init_from_parts(self, model, image_size, channels, *, max_batch=64, max_wait_ms=2.0):
        self.model, self._bundle, self.artifact_info = model, None, None
        self.device = next(model.parameters()).device
        self.model_name = type(model).__name__
        self.image_size, self.channels = image_size, channels
        # the width of the vectors on the encode/decode wire: a VQ model's is the flattened [s·s·D] grid
        self.latent_dim = int(getattr(model, "flat_latent_dim", model.latent_dim))
        self.latent_kind = getattr(model, "latent_kind", "gaussian")
        self.prior, self.prior_info = None, None
        self.num_classes = int(getattr(model, "num_classes", 0) or 0)
        self.conditional = self.num_classes > 0
        item_shape = (image_size, image_size, channels)
        kw = dict(max_batch=max_batch, max_wait_ms=max_wait_ms, item_shape=item_shape, labeled=self.conditional)
        self.reconstruct = MicroBatcher(self._reconstruct_rows, **kw)
        self.encode = MicroBatcher(self._encode_rows, **kw)

    def _to_device(self, rows: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(rows, np.float32)).to(self.device)

    def _labels_on_device(self, labels: Optional[np.ndarray]) -> dict:
        """``label_kwarg`` of a batch's labels, copied to the device."""
        return label_kwarg(self.model, None if labels is None else torch.from_numpy(np.asarray(labels, np.int64)).to(self.device))

    def _reconstruct_rows(self, rows: np.ndarray, labels: Optional[np.ndarray] = None) -> np.ndarray:
        """Posterior-mean decode of one padded batch (the batcher's ``fn``):
        encode → mu → decode, no draw, so a request reconstructs the same
        way every time."""
        with torch.inference_mode():
            x, yk = self._to_device(rows), self._labels_on_device(labels)
            out = self.model.decode(self.model.encode(x, train=False, **yk).mu, train=False, **yk)
            return out.float().cpu().numpy()

    def _encode_rows(self, rows: np.ndarray, labels: Optional[np.ndarray] = None) -> np.ndarray:
        """[B, 2·latent_dim] ``mu ‖ log_var`` of one padded batch."""
        with torch.inference_mode():
            enc = self.model.encode(self._to_device(rows), train=False, **self._labels_on_device(labels))
            return torch.cat([enc.mu, enc.log_var], dim=-1).float().cpu().numpy()

    def attach_prior(self, prior_path: str) -> None:
        """Load a trained code prior (``cli/train_prior.py``) for this VQ
        checkpoint on the model's device: /sample then draws codes
        ancestrally, and /continue opens. The geometry is checked here, so
        a mismatched prior fails at start-up."""
        from midi_vae_tpu_torch.cli.train_prior import load_prior

        if self.latent_kind != "vq":
            raise ValueError(
                f"--prior needs a VQ-VAE checkpoint; this is a {self.model_name} "
                "(Gaussian latent — its prior is already N(0, I))"
            )
        prior, pcfg = load_prior(prior_path, device=self.device)
        if int(pcfg["num_codes"]) != int(self.model.codebook_size) or int(pcfg["grid"]) != self.model.last_conv_size:
            raise ValueError(
                f"prior geometry (K={pcfg['num_codes']}, grid={pcfg['grid']}) does not "
                f"match the checkpoint (K={self.model.codebook_size}, grid={self.model.last_conv_size})"
            )
        self.prior = prior
        self.prior_info = {"arch": str(pcfg.get("arch") or "pixelcnn"), "num_classes": int(pcfg.get("num_classes") or 0),
                           "test_nll": pcfg.get("test_nll"), "path": prior_path}

    def validate_labels(self, labels, n: int, num_classes: Optional[int] = None) -> Optional[np.ndarray]:
        """A request's label field as int32 [n] (a scalar covers every row),
        or ``None`` for an unconditional deployment. ``num_classes``
        replaces the model's class count: /sample and /continue condition
        a class-conditional prior over an unconditional VQ model."""
        classes = self.num_classes if num_classes is None else num_classes
        if classes <= 0:
            if labels is not None:
                raise ValueError("this checkpoint is unconditional; drop the label field")
            return None
        if labels is None:
            raise ValueError(
                f"conditional checkpoint: a label (0..{classes - 1}) is required "
                "('label' scalar or 'labels' list / ?label= query)"
            )
        arr = np.asarray(labels, np.int32)
        if arr.ndim == 0:
            arr = np.full((n,), int(arr), np.int32)
        if arr.shape != (n,):
            raise ValueError(f"labels must be a scalar or [n={n}] list, got shape {arr.shape}")
        if (arr < 0).any() or (arr >= classes).any():
            raise ValueError(f"labels must be in [0, {classes - 1}]")
        return arr

    def _prior_labels(self, label, n: int, b: int) -> Optional[np.ndarray]:
        """The prior's labels for ``n`` rows padded with class 0 to ``b``."""
        y = self.validate_labels(label, n, num_classes=self.prior_info["num_classes"])
        return None if y is None else np.concatenate([y, np.zeros(b - n, np.int32)])

    @staticmethod
    def _check_sampling(temperature: float, top_p: Optional[float]) -> None:
        if not (0.0 < temperature <= 100.0):
            raise ValueError(f"temperature must be in (0, 100], got {temperature}")
        if top_p is not None and not (0.0 < top_p <= 1.0):
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")

    def sample(self, n: int, seed: int = 0, label=None, temperature: float = 1.0,
               top_p: Optional[float] = None) -> np.ndarray:
        """``n`` prior samples [n, H, W, C]: ``bucket(n)`` rows drawn from
        ``seed`` and decoded, the first ``n`` returned (so ``sample(3, s)``
        is the first 3 rows of ``sample(4, s)``, and the decode meets few
        batch shapes). With a code prior attached the rows are ancestral
        code draws (``temperature``, ``top_p``) decoded by the VQ model, as
        ``generate --prior`` draws them for the same seed. ``label``: a
        class or one per row, for a conditional model or prior."""
        from midi_vae_tpu_torch.evaluation.inference import sample_prior
        from midi_vae_tpu_torch.models.prior import sample_codes_autoregressive

        if not (1 <= n <= self.MAX_SAMPLES):
            raise ValueError(f"n must be in [1, {self.MAX_SAMPLES}], got {n}")
        self._check_sampling(temperature, top_p)
        if self._bundle is not None:
            return self._sample_from_artifact(n, seed, label, temperature, top_p)
        if self.prior is None:
            if temperature != 1.0 or top_p is not None:
                raise ValueError("temperature and top_p apply to prior-backed (two-stage) sampling; this "
                                 "deployment has no code prior attached (--prior)")
            y = self.validate_labels(label, n)
            yk = {} if y is None else {"y": torch.from_numpy(np.concatenate([y, np.zeros(_bucket(n) - n, np.int32)]))}
            return sample_prior(self.model, _bucket(n), seed, **yk).float().cpu().numpy()[:n]
        idx = sample_codes_autoregressive(self.prior, seed, _bucket(n), self.model.last_conv_size,
                                          temperature=temperature, top_p=top_p,
                                          y=self._prior_labels(label, n, _bucket(n)))
        with torch.inference_mode():
            return self.model.decode_indices(idx).float().cpu().numpy()[:n]

    def _sample_from_artifact(self, n: int, seed: int, label, temperature: float, top_p: Optional[float]) -> np.ndarray:
        """/sample over an exported artifact (JAX ``serving/server.py:318-344``):
        the baked two-stage sampler when the artifact carries a prior, else
        z drawn as :func:`sample_prior` draws it, through the exported decode."""
        from midi_vae_tpu_torch.evaluation.inference import normal_draw

        b = _bucket(n)
        two_stage = hasattr(self._bundle, "sample")
        if temperature != 1.0 and not two_stage:
            raise ValueError("temperature applies to prior-backed (two-stage) sampling; this "
                             "deployment has no code prior attached")
        if top_p is not None:
            raise ValueError("top_p needs a checkpoint-backed code prior (--prior); the artifact's "
                             "sampler bakes its sampling rule at export time")
        if two_stage:
            y = self._prior_labels(label, n, b)
            out = self._bundle.sample(seed, temperature, y if y is not None else np.zeros(b, np.int32))
        elif self.latent_kind == "vq":
            raise ValueError("/sample is unavailable for this VQ-VAE artifact; re-export with --prior to "
                             "bake in the two-stage sampler, or serve the checkpoint (--checkpoint [--prior])")
        else:
            y = self.validate_labels(label, n)
            z = normal_draw((b, self.latent_dim), seed, self.device)
            args = (z,) if y is None else (z, np.concatenate([y, np.zeros(b - n, np.int32)]))
            out = self._bundle.decode(*args)
        return out.float().cpu().numpy()[:n]

    def continue_rolls(self, x: np.ndarray, keep_cols: int, seed: int = 0, label=None, temperature: float = 1.0,
                       top_p: Optional[float] = None) -> np.ndarray:
        """Two-stage continuation of [N, H, W, C] rolls: encode to code grids,
        keep the first ``keep_cols`` time columns, let the prior write the
        rest, decode (``generate --mode continue``). The batch is padded to
        ``bucket(N)`` rows, as /sample's."""
        from midi_vae_tpu_torch.models.prior import sample_codes_autoregressive

        if self.prior is None:
            raise ValueError("/continue needs a code prior attached (--prior, with --checkpoint); exported "
                             "artifacts bake a fixed sampler and cannot encode-and-continue")
        s = self.model.last_conv_size
        if not (0 < keep_cols < s):
            raise ValueError(f"keep_cols must be in [1, {s - 1}] (code grid is {s}x{s}), got {keep_cols}")
        self._check_sampling(temperature, top_p)
        item = (self.image_size, self.image_size, self.channels)
        if x.ndim != 4 or tuple(x.shape[1:]) != item:
            raise ValueError(f"images must be [N, {item[0]}, {item[1]}, {item[2]}], got {x.shape}")
        n = len(x)
        if n < 1:
            raise ValueError("need at least one image to continue, got an empty batch")
        b = _bucket(n)
        y = self._prior_labels(label, n, b)
        if b > n:
            x = np.concatenate([x, np.zeros((b - n, *item), np.float32)])
        mask = np.zeros((s, s), bool)
        mask[:, :keep_cols] = True  # grid axis j is time (rolls are [pitch, time])
        with torch.inference_mode():
            codes = self.model.encode_indices(self._to_device(x))
        idx = sample_codes_autoregressive(self.prior, seed, b, s, temperature=temperature, top_p=top_p,
                                          y=y, known=codes, known_mask=mask)
        with torch.inference_mode():
            return self.model.decode_indices(idx).float().cpu().numpy()[:n]

    def interpolate(self, a: np.ndarray, b: np.ndarray, steps: int, mode: str, label=None) -> np.ndarray:
        """The latent path [steps, H, W, C] between two [H, W, C] images
        (under one ``label`` for a conditional model)."""
        from midi_vae_tpu_torch.evaluation.inference import interpolate

        # this path runs outside the micro-batcher: bound the result here
        if not (2 <= steps <= self.MAX_INTERPOLATE_STEPS):
            raise ValueError(f"steps must be in [2, {self.MAX_INTERPOLATE_STEPS}], got {steps}")
        expect = (self.image_size, self.image_size, self.channels)
        for name, arr in (("a", a), ("b", b)):
            if tuple(arr.shape) != expect:
                raise ValueError(f"'{name}' must have shape {expect}, got {tuple(arr.shape)}")
        y = self.validate_labels(label, 1)
        if self._bundle is not None:
            return self._interpolate_from_artifact(a, b, steps, mode, y)
        yk = self._labels_on_device(y)
        ends = self._to_device(np.stack([a, b]))
        return interpolate(self.model, ends[:1], ends[1:], steps=steps, mode=mode, **yk)[:, 0].float().cpu().numpy()

    def _interpolate_from_artifact(self, a, b, steps: int, mode: str, y) -> np.ndarray:
        """/interpolate from the exported encode and decode: the posterior
        means of both ends (one batch of 2), the path between them
        (``evaluation/inference.py`` ``latent_path``), one decode of every step."""
        from midi_vae_tpu_torch.evaluation.inference import latent_path

        def labels(k):
            return () if y is None else (np.full((k,), int(y[0]), np.int32),)

        mu = self._bundle.encode(np.stack([a, b]).astype(np.float32), *labels(2))[:, : self.latent_dim].float()
        zs = latent_path(mu[:1], mu[1:], steps, mode)
        return self._bundle.decode(zs.reshape(steps, -1), *labels(steps)).float().cpu().numpy()

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
                    "conditional": service.conditional,
                    "num_classes": service.num_classes,
                    "prior": service.prior_info,
                    "artifact": service.artifact_info,
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

                def req_labels():
                    """JSON 'labels' (one per row) or 'label' (a scalar), else
                    ?labels=csv or ?label= on the query string (the binary wire's only channel)."""
                    if not binary_req and "labels" in payload:
                        return payload["labels"]
                    if not binary_req and "label" in payload:
                        return payload["label"]
                    if "labels" in query:
                        return [int(v) for v in query["labels"][0].split(",")]
                    if "label" in query:
                        return int(query["label"][0])
                    return None

                if route == "/sample":
                    if binary_req:
                        raise ValueError("/sample takes JSON parameters ({'n', 'seed'}), not a tensor body")
                    top_p = payload.get("top_p")
                    out = service.sample(int(payload.get("n", 1)), int(payload.get("seed", 0)), label=req_labels(),
                                         temperature=float(payload.get("temperature", 1.0)),
                                         top_p=float(top_p) if top_p is not None else None)
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
                    out = service.interpolate(a, b, steps=steps, mode=mode, label=req_labels())
                    self._npy(200, out) if wants_npy else self._json(200, {"path": out.tolist()})
                elif route == "/continue":
                    # the rolls in the body; the scalars on the JSON body, or on the query string of a binary one
                    if binary_req:
                        x = np.asarray(npy_loads(raw), np.float32)
                        params = {k: v[0] for k, v in query.items() if k not in ("label", "labels")}
                    else:
                        x = np.asarray(payload["images"], np.float32)
                        params = payload
                    if "keep_cols" not in params:
                        raise ValueError("'keep_cols' is required for /continue "
                                         "(number of leading code TIME columns to keep)")
                    if x.ndim == 3:
                        x = x[None]
                    if len(x) > self.MAX_REQUEST_ITEMS:
                        raise ValueError(f"at most {self.MAX_REQUEST_ITEMS} images per request, got {len(x)}")
                    top_p = params.get("top_p")
                    out = service.continue_rolls(
                        x, int(params["keep_cols"]), seed=int(params.get("seed", 0)), label=req_labels(),
                        temperature=float(params.get("temperature", 1.0)),
                        top_p=float(top_p) if top_p is not None else None,
                    )
                    self._npy(200, out) if wants_npy else self._json(200, {"continuations": out.tolist()})
                elif route in ("/reconstruct", "/encode"):
                    x = np.asarray(npy_loads(raw) if binary_req else payload["images"], np.float32)
                    if x.ndim == 3:
                        x = x[None]
                    if len(x) > self.MAX_REQUEST_ITEMS:
                        raise ValueError(f"at most {self.MAX_REQUEST_ITEMS} images per request, got {len(x)}")
                    out = getattr(service, route[1:])(x, service.validate_labels(req_labels(), len(x)))
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
    """Start serving ``checkpoint`` or an exported ``artifact`` directory on
    ``device`` in a background thread and return the server (``port=0``
    picks a free port: ``server_address[1]``); ``prior`` attaches a code
    prior to a VQ checkpoint (an artifact carries its own from export).
    Stop it with ``shutdown()``, ``server_close()`` and ``service.close()``."""
    if (checkpoint is None) == (artifact is None):
        raise ValueError("pass exactly one of checkpoint= or artifact=")
    if artifact is not None:
        if prior is not None:
            raise ValueError("artifacts carry their prior from export time (aot_export --prior); "
                             "--prior applies to --checkpoint serving")
        service = InferenceService.from_artifact(artifact, device=device)
    else:
        service = InferenceService(checkpoint, device=device, prior_path=prior)
    httpd = make_server(service, host, port)
    print(f"serving {checkpoint or artifact} on http://{host}:{httpd.server_address[1]} ({httpd.service.device})")
    return httpd


def cli(argv: Optional[list] = None):
    parser = argparse.ArgumentParser(description="Serve a trained VAE checkpoint over HTTP")
    source = parser.add_mutually_exclusive_group(required=True)
    source.add_argument("--checkpoint", help="Training checkpoint (this package's .pt or .orbax directory, "
                                             "or a JAX package .msgpack)")
    source.add_argument("--artifact", metavar="DIR",
                        help="Exported artifact directory (interop/aot_export.py): serve its torch.export "
                             "programs, no model code or checkpoint needed")
    parser.add_argument("--prior", metavar="PATH", default=None,
                        help="Trained code prior (cli/train_prior.py) for a VQ checkpoint: /sample draws "
                             "codes ancestrally instead of from the EMA code marginal, and /continue opens")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--compilation-cache", type=str, default=None, metavar="DIR",
                        help="Persistent compilation-cache directory: the kernels' builds and Triton's and "
                             "inductor's caches live there, so a restart builds nothing")
    parser.add_argument("--cpu", action="store_true", help="Serve on the CPU instead of the GPU (also skips the probe)")
    parser.add_argument("--skip-backend-check", action="store_true",
                        help="Skip the startup GPU liveness probe")
    args = parser.parse_args(argv)
    if not (args.skip_backend_check or args.cpu):
        from midi_vae_tpu_torch.core.backend_check import backend_alive

        # a wedged device would otherwise hang the server at its first CUDA
        # call, with no error and no listening socket
        if not backend_alive():
            print("FATAL: CUDA backend unreachable (device probe never completed); not starting", file=sys.stderr)
            raise SystemExit(1)
    if args.compilation_cache:
        from midi_vae_tpu_torch.core.compile_cache import enable_compilation_cache

        print(f"persistent compilation cache: {enable_compilation_cache(args.compilation_cache)}")
    httpd = serve(args.checkpoint, args.port, args.host, device="cpu" if args.cpu else "cuda",
                  artifact=args.artifact, prior=args.prior)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        httpd.shutdown()
        httpd.server_close()
        httpd.service.close()


if __name__ == "__main__":
    cli()

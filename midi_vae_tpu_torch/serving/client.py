"""Python client for the inference server (counterpart of
``midi_vae_tpu/serving/client.py``).

stdlib ``urllib`` and numpy only. Tensor-carrying calls use the binary
npy wire by default (``Content-Type`` / ``Accept: application/x-npy``);
``wire="json"`` selects the human-readable one. Server errors raise
:class:`ServingError` with the HTTP status and the server's JSON error
message (errors are JSON on both wires).

    from midi_vae_tpu_torch.serving.client import ServingClient
    c = ServingClient("http://127.0.0.1:8000")
    recon = c.reconstruct(x)            # [N,H,W,C] float32 → [N,H,W,C]
    mu, log_var = c.encode(x)           # → ([N,D], [N,D])
    rolls = c.sample(n=16, seed=0)      # → [16,H,W,C]
    path = c.interpolate(a, b, steps=9) # → [9,H,W,C]

Labels of conditional models and ``/continue`` are not ported yet
(ROADMAP items 17 and 13).
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Optional, Tuple

import numpy as np

from midi_vae_tpu_torch.serving.wire import NPY_CONTENT_TYPE, npy_dumps, npy_loads


class ServingError(RuntimeError):
    """An HTTP error from the server, with its JSON error message."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.message = message


class ServingClient:
    def __init__(self, base_url: str, *, wire: str = "npy", timeout: float = 120.0):
        if wire not in ("npy", "json"):
            raise ValueError(f"wire must be 'npy' or 'json', got {wire!r}")
        self.base_url = base_url.rstrip("/")
        self.wire = wire
        self.timeout = timeout

    # -- transport ---------------------------------------------------------
    def _request(self, path: str, data: Optional[bytes], headers: dict):
        req = urllib.request.Request(self.base_url + path, data=data, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                body = resp.read()
                ctype = resp.headers.get("Content-Type", "")
        except urllib.error.HTTPError as e:
            try:
                message = json.loads(e.read()).get("error", "")
            except (ValueError, AttributeError):  # an unparseable error body
                message = e.reason
            raise ServingError(e.code, message) from None
        if ctype == NPY_CONTENT_TYPE:
            return npy_loads(body)
        return json.loads(body)

    def _post_tensor(self, path: str, x: np.ndarray):
        """POST a tensor body on the configured wire."""
        x = np.asarray(x, np.float32)
        if self.wire == "npy":
            return self._request(path, npy_dumps(x), {"Content-Type": NPY_CONTENT_TYPE})
        return self._request(path, json.dumps({"images": x.tolist()}).encode(), {"Content-Type": "application/json"})

    def _post_params(self, path: str, params: dict):
        """POST JSON parameters; the response rides the configured wire."""
        headers = {"Content-Type": "application/json"}
        if self.wire == "npy":
            headers["Accept"] = NPY_CONTENT_TYPE
        return self._request(path, json.dumps(params).encode(), headers)

    # -- API ----------------------------------------------------------------
    def healthz(self) -> dict:
        return self._request("/healthz", None, {})

    def reconstruct(self, x: np.ndarray) -> np.ndarray:
        """[N,H,W,C] (or [H,W,C]) → posterior-mean reconstructions [N,H,W,C]."""
        out = self._post_tensor("/reconstruct", x)
        return out if isinstance(out, np.ndarray) else np.asarray(out["reconstructions"], np.float32)

    def encode(self, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """[N,H,W,C] → (mu [N,D], log_var [N,D])."""
        out = self._post_tensor("/encode", x)
        if isinstance(out, np.ndarray):  # npy wire: [N, 2D], mu ‖ log_var halves
            d = out.shape[-1] // 2
            return out[:, :d], out[:, d:]
        return np.asarray(out["mu"], np.float32), np.asarray(out["log_var"], np.float32)

    def sample(self, n: int, seed: int = 0) -> np.ndarray:
        """``n`` prior samples [n,H,W,C] drawn from ``seed``."""
        out = self._post_params("/sample", {"n": int(n), "seed": int(seed)})
        return out if isinstance(out, np.ndarray) else np.asarray(out["samples"], np.float32)

    def interpolate(self, a: np.ndarray, b: np.ndarray, *, steps: int = 8, slerp: bool = False) -> np.ndarray:
        """[H,W,C] endpoints → the [steps,H,W,C] latent-space path."""
        if self.wire == "npy":
            # one [2,H,W,C] npy body carries both endpoints; the scalar
            # parameters ride the query string
            ends = np.stack([np.asarray(a, np.float32), np.asarray(b, np.float32)])
            path = f"/interpolate?steps={int(steps)}&slerp={int(bool(slerp))}"
            return self._request(path, npy_dumps(ends), {"Content-Type": NPY_CONTENT_TYPE})
        params = {
            "a": np.asarray(a, np.float32).tolist(),
            "b": np.asarray(b, np.float32).tolist(),
            "steps": int(steps),
            "slerp": bool(slerp),
        }
        out = self._post_params("/interpolate", params)
        return out if isinstance(out, np.ndarray) else np.asarray(out["path"], np.float32)

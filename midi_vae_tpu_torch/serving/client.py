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
    cont = c.continue_(x, keep_cols=8)  # VQ + --prior: → [N,H,W,C]

Every call takes ``labels=`` for a conditional checkpoint or a
class-conditional prior: a scalar class for every row, or one per row.
They ride the JSON body (``label``/``labels``), or the query string on the
npy wire.
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


def _label_query(labels) -> str:
    """``labels`` as a query-string item for the npy wire ('' when None)."""
    if labels is None:
        return ""
    arr = np.asarray(labels, np.int32)
    if arr.ndim == 0:
        return f"label={int(arr)}"
    return "labels=" + ",".join(str(int(v)) for v in arr)


def _label_fields(labels) -> dict:
    """``labels`` as JSON body fields ({} when None)."""
    if labels is None:
        return {}
    arr = np.asarray(labels, np.int32)
    if arr.ndim == 0:
        return {"label": int(arr)}
    return {"labels": [int(v) for v in arr]}


def _with_query(path: str, query: str) -> str:
    return path if not query else path + ("&" if "?" in path else "?") + query


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

    def _post_tensor(self, path: str, x: np.ndarray, labels=None):
        """POST a tensor body on the configured wire, with its labels."""
        x = np.asarray(x, np.float32)
        if self.wire == "npy":
            return self._request(_with_query(path, _label_query(labels)), npy_dumps(x),
                                 {"Content-Type": NPY_CONTENT_TYPE})
        body = {"images": x.tolist(), **_label_fields(labels)}
        return self._request(path, json.dumps(body).encode(), {"Content-Type": "application/json"})

    def _post_params(self, path: str, params: dict):
        """POST JSON parameters; the response rides the configured wire."""
        headers = {"Content-Type": "application/json"}
        if self.wire == "npy":
            headers["Accept"] = NPY_CONTENT_TYPE
        return self._request(path, json.dumps(params).encode(), headers)

    # -- API ----------------------------------------------------------------
    def healthz(self) -> dict:
        return self._request("/healthz", None, {})

    def reconstruct(self, x: np.ndarray, labels=None) -> np.ndarray:
        """[N,H,W,C] (or [H,W,C]) → posterior-mean reconstructions [N,H,W,C]."""
        out = self._post_tensor("/reconstruct", x, labels)
        return out if isinstance(out, np.ndarray) else np.asarray(out["reconstructions"], np.float32)

    def encode(self, x: np.ndarray, labels=None) -> Tuple[np.ndarray, np.ndarray]:
        """[N,H,W,C] → (mu [N,D], log_var [N,D])."""
        out = self._post_tensor("/encode", x, labels)
        if isinstance(out, np.ndarray):  # npy wire: [N, 2D], mu ‖ log_var halves
            d = out.shape[-1] // 2
            return out[:, :d], out[:, d:]
        return np.asarray(out["mu"], np.float32), np.asarray(out["log_var"], np.float32)

    def sample(self, n: int, seed: int = 0, labels=None, *, temperature: float = 1.0,
               top_p: Optional[float] = None) -> np.ndarray:
        """``n`` prior samples [n,H,W,C] drawn from ``seed``; ``temperature``
        and ``top_p`` apply to a server with a code prior attached."""
        params = {"n": int(n), "seed": int(seed), **_label_fields(labels)}
        if temperature != 1.0:
            params["temperature"] = float(temperature)
        if top_p is not None:
            params["top_p"] = float(top_p)
        out = self._post_params("/sample", params)
        return out if isinstance(out, np.ndarray) else np.asarray(out["samples"], np.float32)

    def continue_rolls(self, x: np.ndarray, keep_cols: int, *, seed: int = 0, temperature: float = 1.0,
                       top_p: Optional[float] = None, labels=None) -> np.ndarray:
        """[N,H,W,C] (or [H,W,C]) rolls → continuations of the same shape: the
        server keeps each roll's first ``keep_cols`` code-grid time columns
        and its code prior writes the rest."""
        x = np.asarray(x, np.float32)
        if x.ndim == 3:
            x = x[None]
        params = {"keep_cols": int(keep_cols), "seed": int(seed), "temperature": float(temperature)}
        if top_p is not None:
            params["top_p"] = float(top_p)
        if self.wire == "npy":
            query = "&".join(f"{k}={v}" for k, v in params.items())
            return self._request(_with_query(f"/continue?{query}", _label_query(labels)), npy_dumps(x),
                                 {"Content-Type": NPY_CONTENT_TYPE})
        out = self._post_params("/continue", {"images": x.tolist(), **params, **_label_fields(labels)})
        return out if isinstance(out, np.ndarray) else np.asarray(out["continuations"], np.float32)

    continue_ = continue_rolls

    def interpolate(self, a: np.ndarray, b: np.ndarray, *, steps: int = 8, slerp: bool = False,
                    labels=None) -> np.ndarray:
        """[H,W,C] endpoints → the [steps,H,W,C] latent-space path."""
        if self.wire == "npy":
            # one [2,H,W,C] npy body carries both endpoints; the scalar
            # parameters ride the query string
            ends = np.stack([np.asarray(a, np.float32), np.asarray(b, np.float32)])
            path = _with_query(f"/interpolate?steps={int(steps)}&slerp={int(bool(slerp))}", _label_query(labels))
            return self._request(path, npy_dumps(ends), {"Content-Type": NPY_CONTENT_TYPE})
        params = {
            "a": np.asarray(a, np.float32).tolist(),
            "b": np.asarray(b, np.float32).tolist(),
            "steps": int(steps),
            "slerp": bool(slerp),
            **_label_fields(labels),
        }
        out = self._post_params("/interpolate", params)
        return out if isinstance(out, np.ndarray) else np.asarray(out["path"], np.float32)

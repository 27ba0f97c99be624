"""Metric logging (counterpart of ``midi_vae_tpu/io/logging.py``).

The same metric namespaces (``training/stepwise/*``,
``training/epochwise/*``, ``eval/{test,val,train}/*``) go to a
``metrics.jsonl`` file in the run directory and, when asked for, to
wandb (which must then be importable). ``PhaseTimer`` splits a step
loop's host time into named phases. :func:`write_png` writes image grids
(reconstructions, generated samples) without an imaging library.
"""

from __future__ import annotations

import json
import os
import secrets
import string
import struct
import time
import zlib
from typing import Any, Dict, Optional

import numpy as np


def generate_id(length: int = 8) -> str:
    """Random base-36 run id."""
    alphabet = string.ascii_lowercase + string.digits
    return "".join(secrets.choice(alphabet) for _ in range(length))


class PhaseTimer:
    """Wall-clock phase durations within a step loop: :meth:`mark` at each
    phase boundary; :meth:`durations` sums the seconds between consecutive
    marks under the earlier mark's name."""

    def __init__(self):
        self._marks = []

    def mark(self, name: str) -> None:
        self._marks.append((name, time.perf_counter()))

    def durations(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for (name, t0), (_, t1) in zip(self._marks, self._marks[1:]):
            out[name] = out.get(name, 0.0) + (t1 - t0)
        return out

    def reset(self) -> None:
        self._marks.clear()


# config keys never uploaded to wandb: run identity and output plumbing
EXCLUDED_WANDB_CONFIG_KEYS = frozenset(
    {"log_wandb", "wandb_entity", "wandb_project", "run_name", "run_id", "model_output_dir"}
)


class MetricLogger:
    """JSONL file (``output_dir/metrics.jsonl``) + optional wandb."""

    def __init__(
        self,
        output_dir: Optional[str] = None,
        *,
        use_wandb: bool = False,
        wandb_entity: Optional[str] = None,
        wandb_project: str = "midi_vae_tpu",
        run_name: Optional[str] = None,
        run_id: Optional[str] = None,
        config: Optional[Dict[str, Any]] = None,
        tags=(),
    ):
        self.output_dir = output_dir
        self._jsonl = None
        self._wandb = None
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            self._jsonl = open(os.path.join(output_dir, "metrics.jsonl"), "a", buffering=1)
        if use_wandb:
            self._init_wandb(wandb_entity, wandb_project, run_name, run_id, config, tags)

    def _init_wandb(self, entity, project, run_name, run_id, config, tags):
        try:
            import wandb
        except ImportError as e:
            raise RuntimeError("--log-wandb needs the wandb package, which is not installed") from e
        id_file = os.path.join(self.output_dir, "wandb_runid.txt") if self.output_dir else None
        resume_id = None
        if id_file and os.path.isfile(id_file):
            with open(id_file) as f:
                resume_id = f.read().strip()  # resume the run across a preemption
        uploaded = {k: v for k, v in (config or {}).items() if k not in EXCLUDED_WANDB_CONFIG_KEYS}
        kwargs = dict(entity=entity, project=project, name=run_name, config=uploaded, tags=list(tags))
        if resume_id:
            self._wandb = wandb.init(id=resume_id, resume="must", **kwargs)
        else:
            self._wandb = wandb.init(id=run_id, **kwargs)
            if id_file:
                with open(id_file, "w") as f:
                    f.write(self._wandb.id)

    @property
    def wandb_run(self):
        return self._wandb

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        if self._jsonl:
            self._jsonl.write(json.dumps({"step": step, **metrics}, default=float) + "\n")
        if self._wandb:
            self._wandb.log(metrics, step=step)

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None
        if self._wandb:
            self._wandb.finish()
            self._wandb = None


def format_duration(seconds: float) -> str:
    if seconds > 172800:
        return f"{seconds / 86400:11.2f} days"
    if seconds > 5400:
        return f"{seconds / 3600:11.2f} hours"
    if seconds > 120:
        return f"{seconds / 60:11.2f} minutes"
    return f"{seconds:11.2f} seconds"


def print_epoch_summary(kind: str, epoch: int, n_epoch: int, stats: Dict[str, Any], duration: float) -> None:
    """Epoch roll-up in the reference's console format."""
    print(f"\n{kind} epoch {epoch}/{n_epoch} summary:")
    for label, key in [("Total Steps", "total_step"), ("Steps", "steps"), ("Samples", "samples")]:
        if key in stats:
            print(f"  {label} {'.' * (19 - len(label))}{stats[key]:8d}")
    print(f"  Duration ...........{format_duration(duration)}")
    if "throughput" in stats:
        print(f"  Throughput .........{stats['throughput']:11.2f} samples/sec")
    if "loss" in stats:
        print(f"  Loss ...............{stats['loss']:14.5f}")
    if "cross-entropy" in stats:
        print(f"  Cross-entropy ......{stats['cross-entropy']:14.5f}")


def write_png(path: str, image: np.ndarray) -> None:
    """An 8-bit grayscale ([H, W] or [H, W, 1]) or RGB ([H, W, 3]) PNG, with zlib."""
    if image.ndim == 3 and image.shape[-1] == 1:
        image = image[..., 0]
    h, w = image.shape[:2]
    color = 0 if image.ndim == 2 else 2
    raw = b"".join(b"\x00" + np.ascontiguousarray(image[r]).tobytes() for r in range(h))

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(
            b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b"")
        )

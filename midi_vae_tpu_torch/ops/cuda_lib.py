"""Build and load the port's CUDA C++ kernels (``midi_vae_tpu_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library of
its own, with a plain C interface, at first use, and opened with
``ctypes``. The library lands in a directory named by a hash of its
source and the flags, so a library built from another version of the
source, or with other flags, is never loaded. The build directory is ``$MIDI_VAE_TORCH_KERNEL_DIR`` when set,
else ``~/.cache/midi_vae_tpu_torch/kernels``; the package never writes
into its own tree. A missing ``nvcc`` or a failed build raises: there is no
other path to a kernel.

Importing this module builds nothing; :func:`build` starts one ``nvcc``
per source, all at once, and :func:`library` builds on demand.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR_ENV = "MIDI_VAE_TORCH_KERNEL_DIR"
_CUDA_HOME_DEFAULT = "/usr/local/cuda"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass(frozen=True)
class Built:
    """One built library: its path, the seconds ``nvcc`` took (None when an
    earlier build was found), and the compiler's ``-Xptxas -v`` report."""

    path: Path
    seconds: Optional[float]
    ptxas: str


def build_dir() -> Path:
    env = os.environ.get(BUILD_DIR_ENV)
    return Path(env) if env else Path.home() / ".cache" / "midi_vae_tpu_torch" / "kernels"


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``, then ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), _CUDA_HOME_DEFAULT):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): the CUDA C++ kernels cannot be built")
    return found


def sources() -> Dict[str, Path]:
    """Kernel library name → its ``.cu`` source."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def build_key(source: Path) -> str:
    """Hash of the flags and the source."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(source.read_bytes())
    return h.hexdigest()[:16]


def _target(name: str) -> Path:
    return build_dir() / build_key(sources()[name]) / f"lib{name}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Built]:
    """Build the named libraries (all by default) that are not built yet,
    one ``nvcc`` process per source, all started together."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    missing = [n for n in names if n not in srcs]
    if missing:
        raise KeyError(f"no CUDA source for {missing} in {CSRC}")
    done: Dict[str, Built] = {}
    to_build = []
    for name in names:
        target = _target(name)
        if target.is_file():
            done[name] = Built(target, None, target.with_suffix(".log").read_text())
        else:
            to_build.append((name, target))
    compiler = nvcc() if to_build else None
    running = {}
    for name, target in to_build:
        target.parent.mkdir(parents=True, exist_ok=True)
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(srcs[name])]
        running[name] = (target, tmp, time.perf_counter(),
                         subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (target, tmp, t0, proc) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        target.with_suffix(".log").write_text(log)
        os.replace(tmp, target)  # atomic: a concurrent loader sees the old state or the whole library
        done[name] = Built(target, seconds, log)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return done


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    return ctypes.CDLL(str(build([name])[name].path))

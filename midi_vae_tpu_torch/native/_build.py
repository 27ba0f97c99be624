"""Build and load the port's host C++ libraries (``native/*.cc``).

Each source is compiled by ``g++`` (``-O3 -std=c++17 -shared -fPIC
-pthread``, the JAX package's flags) into a shared library of its own at
first use and opened with ``ctypes``. The library lands in the directory
the CUDA kernels build into (``ops/cuda_lib.py`` :func:`build_dir`),
under ``host/<hash of source and flags>/``, never in the package tree.
It is written under a temporary name and renamed into place, so
concurrent ranks and test workers never open a half-written library.

A missing compiler or a failed build raises: no caller falls back to a
Python loader or parser without saying so.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

from midi_vae_tpu_torch.ops.cuda_lib import Built, build_dir

SRC = Path(__file__).resolve().parent
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


def sources() -> Dict[str, Path]:
    """Host library name → its ``.cc`` source."""
    return {p.stem: p for p in sorted(SRC.glob("*.cc"))}


def _target(name: str) -> Path:
    source = sources()[name]
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(source.read_bytes())
    return build_dir() / "host" / h.hexdigest()[:16] / f"lib{name}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Built]:
    """Build the named libraries (all by default) that are not built yet,
    one ``g++`` per source, all started together."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    missing = [n for n in names if n not in srcs]
    if missing:
        raise KeyError(f"no host C++ source for {missing} in {SRC}")
    done: Dict[str, Built] = {}
    running = {}
    for name in names:
        target = _target(name)
        if target.is_file():
            done[name] = Built(target, None, "")
            continue
        compiler = shutil.which("g++")
        if compiler is None:
            raise RuntimeError(f"g++ not found on PATH: the host library {name} cannot be built")
        target.parent.mkdir(parents=True, exist_ok=True)
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [compiler, *CXX_FLAGS, str(srcs[name]), "-o", str(tmp)]
        running[name] = (target, tmp, time.perf_counter(),
                         subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (target, tmp, t0, proc) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}: g++ exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, target)
        done[name] = Built(target, time.perf_counter() - t0, log)
        print(f"built host library {name} with g++ in {done[name].seconds:.1f} s -> {target}")
    if failed:
        raise RuntimeError("host C++ build failed:\n" + "\n".join(failed))
    return done


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``native/<name>.cc``, built first if needed."""
    return ctypes.CDLL(str(build([name])[name].path))

"""What a wheel of this project ships for the PyTorch port, on the CPU:

- every C++ and CUDA source under ``midi_vae_tpu_torch/`` is matched by a
  ``[tool.setuptools.package-data]`` glob (read with ``tomllib``, no build),
  since the port builds its host libraries and kernels from the installed
  sources at first use;
- every console command ``midi-vae-X`` of the JAX package has a
  ``midi-vae-torch-X`` whose target is the ``main`` of the port's module of
  the same name, which runs that module's ``cli`` and returns an exit status
  (``cli`` returns its results to Python callers; a console script would
  turn them into status 1);
- a wheel built from a copy of the project (``pip wheel
  --no-build-isolation --no-deps --no-index``, in ``tmp_path`` so nothing
  lands in the checkout), installed with ``--target``, builds the zstd
  library from its installed source in a fresh process that sees no other
  copy of the package, and decodes a frame.
"""

import importlib
import os
import shutil
import subprocess
import sys
import tomllib
import zipfile
from pathlib import Path

import pytest
import zstandard

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

_REPO = Path(__file__).resolve().parents[1]
_PYPROJECT = tomllib.loads((_REPO / "pyproject.toml").read_text())
_JAX_PREFIX, _PORT_PREFIX = "midi-vae-", "midi-vae-torch-"
_SOURCES = sorted(p for ext in ("*.cc", "*.cu") for p in (_REPO / "midi_vae_tpu_torch").rglob(ext))


def _shipped(path: Path) -> bool:
    """Whether a package-data glob (relative to its package's directory, as
    setuptools globs it) matches ``path``."""
    for package, patterns in _PYPROJECT["tool"]["setuptools"]["package-data"].items():
        pkg_dir = _REPO.joinpath(*package.split("."))
        if any(path in set(pkg_dir.glob(p)) for p in patterns):
            return True
    return False


@pytest.mark.parametrize("source", _SOURCES, ids=lambda p: str(p.relative_to(_REPO)))
def test_every_port_source_is_package_data(source):
    assert _shipped(source), f"{source.relative_to(_REPO)} is not in [tool.setuptools.package-data]"


def test_the_port_has_host_and_cuda_sources():
    names = {p.relative_to(_REPO).as_posix() for p in _SOURCES}
    assert {"midi_vae_tpu_torch/csrc/reparam_kl.cu", "midi_vae_tpu_torch/native/zstd.cc",
            "midi_vae_tpu_torch/native/png.cc"} <= names


_SCRIPTS = _PYPROJECT["project"]["scripts"]
_JAX_SCRIPTS = sorted(k for k in _SCRIPTS if not k.startswith(_PORT_PREFIX))


@pytest.mark.parametrize("name", _JAX_SCRIPTS)
def test_every_jax_console_script_has_a_port_twin(name, monkeypatch):
    twin = _PORT_PREFIX + name[len(_JAX_PREFIX):]
    assert twin in _SCRIPTS, f"no {twin} beside {name}"
    jax_module = _SCRIPTS[name].split(":")[0]
    module_name, func = _SCRIPTS[twin].split(":")
    assert module_name == jax_module.replace("midi_vae_tpu.", "midi_vae_tpu_torch.", 1) and func == "main"
    module = importlib.import_module(module_name)
    seen = []
    monkeypatch.setattr(module, "cli", lambda argv=None: seen.append(argv) or {"results": 1})
    assert getattr(module, func)(["--flag"]) == 0 and seen == [["--flag"]]


def test_the_train_command_exits_1_without_results(monkeypatch):
    module = importlib.import_module("midi_vae_tpu_torch.cli.train")
    monkeypatch.setattr(module, "cli", lambda argv=None: None)
    assert module.main([]) == 1


def test_an_installed_wheel_builds_zstd_from_its_own_source(tmp_path):
    project = tmp_path / "project"
    project.mkdir()
    shutil.copy2(_REPO / "pyproject.toml", project)
    for package in ("midi_vae_tpu", "midi_vae_tpu_torch"):
        shutil.copytree(_REPO / package, project / package, ignore=shutil.ignore_patterns("__pycache__", "*.so"))
    pip = [sys.executable, "-m", "pip"]
    subprocess.run(pip + ["wheel", "--no-build-isolation", "--no-deps", "--no-index", "-q", "-w",
                          str(tmp_path / "dist"), str(project)], check=True, capture_output=True, timeout=600)
    (wheel,) = (tmp_path / "dist").glob("*.whl")
    names = set(zipfile.ZipFile(wheel).namelist())
    for source in _SOURCES:
        assert source.relative_to(_REPO).as_posix() in names
    site = tmp_path / "site"
    subprocess.run(pip + ["install", "--no-deps", "--no-index", "-q", "--target", str(site), str(wheel)], check=True,
                   capture_output=True, timeout=600)

    payload = os.urandom(1000) + b"midi" * 5000
    (tmp_path / "frame.zst").write_bytes(zstandard.ZstdCompressor(level=3).compress(payload))
    code = ("import sys; from pathlib import Path; import midi_vae_tpu_torch; "
            "from midi_vae_tpu_torch.native import _build, zstd; "
            "assert Path(midi_vae_tpu_torch.__file__).is_relative_to(sys.argv[1]), midi_vae_tpu_torch.__file__; "
            "built = _build.build(['zstd'])['zstd']; assert built.seconds is not None; "
            "Path(sys.argv[3]).write_bytes(zstd.decompress(Path(sys.argv[2]).read_bytes()))")
    work = tmp_path / "work"
    work.mkdir()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(site), MIDI_VAE_TORCH_KERNEL_DIR=str(tmp_path / "kernels"))
    out = subprocess.run([sys.executable, "-c", code, str(site), str(tmp_path / "frame.zst"), str(tmp_path / "out")],
                         cwd=work, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    assert "built host library zstd with g++" in out.stdout
    assert (tmp_path / "out").read_bytes() == payload
    assert list((tmp_path / "kernels" / "host").rglob("libzstd.so"))

"""Import guard: the PyTorch port and its chip script stand alone. They
import torch, never JAX, flax, optax or anything of the JAX package (not
even its JAX-free modules: the port keeps its own copies), and not PyYAML
or msgpack, which the GPU machine does not have."""

import ast
import pathlib
import subprocess
import sys

import pytest

_REPO = pathlib.Path(__file__).resolve().parents[1]
_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "midi_vae_tpu", "yaml", "msgpack")


def _port_sources():
    return sorted((_REPO / "midi_vae_tpu_torch").rglob("*.py")) + [_REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(_REPO)))
def test_port_imports_nothing_of_jax(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in _FORBIDDEN, f"{path}: imports {name}"


# the inference side (generate, evaluate, serving and what they run)
_INFERENCE_MODULES = (
    "cli/evaluate.py", "cli/generate.py", "evaluation/disentanglement.py", "evaluation/inference.py",
    "evaluation/iwae.py", "midi/calibrate.py", "midi/derasterize.py", "midi/stats.py", "serving/__init__.py",
    "serving/batcher.py", "serving/client.py", "serving/server.py", "serving/wire.py",
)


def test_inference_modules_are_among_the_guarded_sources():
    guarded = {p.relative_to(_REPO / "midi_vae_tpu_torch").as_posix() for p in _port_sources()[:-1]}
    assert set(_INFERENCE_MODULES) <= guarded


def test_every_port_module_imports_with_jax_and_the_jax_package_blocked():
    """Imports made at run time escape the source scan above: import every
    module of the port in a fresh interpreter in which ``jax``, ``flax``,
    ``midi_vae_tpu`` and the rest cannot be imported."""
    code = (
        "import sys, importlib, pkgutil\n"
        f"for name in {_FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        "import midi_vae_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(midi_vae_tpu_torch.__path__, 'midi_vae_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 50

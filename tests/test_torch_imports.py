"""Import guard: the PyTorch port and its chip script stand alone. They
import torch, never JAX, flax, optax or anything of the JAX package (not
even its JAX-free modules: the port keeps its own copies), and not PyYAML
or msgpack, which the GPU machine does not have."""

import ast
import pathlib

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

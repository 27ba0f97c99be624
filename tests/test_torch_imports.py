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


# the two-stage VQ path (the VQ-VAE, its objective, the code priors and their trainer)
_TWO_STAGE_MODULES = ("cli/train_prior.py", "losses/vq.py", "models/prior.py", "models/vq.py")


# the training variants (the β-TC objective, MLPVAE, the optax-rule optimizers and schedules)
_VARIANT_MODULES = ("losses/tcvae.py", "models/mlp.py", "train/optim.py", "train/schedules.py")


# the model variants' interop and the exported serving artifact
_ARTIFACT_MODULES = ("interop/aot_export.py", "interop/torch_reference.py")


# the data and utility modules (the native runtime's bindings, checkpoints, cache, probe)
_DATA_UTILITY_MODULES = (
    "core/backend_check.py", "core/compile_cache.py", "io/dcp_io.py", "io/flax_msgpack.py", "native/__init__.py",
    "native/_build.py", "native/midiparse.py", "native/rrd.py",
)


def test_data_utility_modules_are_among_the_guarded_sources():
    guarded = {p.relative_to(_REPO / "midi_vae_tpu_torch").as_posix() for p in _port_sources()[:-1]}
    assert set(_DATA_UTILITY_MODULES) <= guarded


def test_inference_modules_are_among_the_guarded_sources():
    guarded = {p.relative_to(_REPO / "midi_vae_tpu_torch").as_posix() for p in _port_sources()[:-1]}
    assert set(_INFERENCE_MODULES) <= guarded


def test_two_stage_modules_are_among_the_guarded_sources():
    guarded = {p.relative_to(_REPO / "midi_vae_tpu_torch").as_posix() for p in _port_sources()[:-1]}
    assert set(_TWO_STAGE_MODULES) <= guarded


def test_variant_modules_are_among_the_guarded_sources():
    guarded = {p.relative_to(_REPO / "midi_vae_tpu_torch").as_posix() for p in _port_sources()[:-1]}
    assert set(_VARIANT_MODULES) <= guarded


def test_artifact_modules_are_among_the_guarded_sources():
    guarded = {p.relative_to(_REPO / "midi_vae_tpu_torch").as_posix() for p in _port_sources()[:-1]}
    assert set(_ARTIFACT_MODULES) <= guarded


def test_artifact_loader_imports_nothing_of_the_models():
    """The artifact loader needs torch alone: importing it pulls in no
    module of ``midi_vae_tpu_torch.models`` (its exporter imports them at
    call time), with JAX and the JAX package blocked."""
    code = (
        "import sys\n"
        f"for name in {_FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        "import midi_vae_tpu_torch.interop.aot_export as m\n"
        "assert hasattr(m, 'AOTServingBundle')\n"
        "print(' '.join(sorted(n for n in sys.modules if n.startswith('midi_vae_tpu_torch.'))))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = out.stdout.split()
    assert "midi_vae_tpu_torch.interop.aot_export" in loaded
    assert not [n for n in loaded if n.startswith("midi_vae_tpu_torch.models")], loaded


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
        "print(' '.join(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    imported = out.stdout.split()
    assert len(imported) >= 50
    assert {"midi_vae_tpu_torch." + m[:-3].replace("/", ".") for m in _VARIANT_MODULES + _ARTIFACT_MODULES} <= set(
        imported)

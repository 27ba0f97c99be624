"""Import guard: the PyTorch port and its chip script stand alone. They
import torch, never JAX, flax, optax or anything of the JAX package (not
even its JAX-free modules: the port keeps its own copies), and not PyYAML,
msgpack, Orbax, tensorstore, zstandard or zarr, which the GPU machine does
not have (the port reads JAX Orbax checkpoints with its own decoders)."""

import ast
import pathlib
import subprocess
import sys

import pytest

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

_REPO = pathlib.Path(__file__).resolve().parents[1]
_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "midi_vae_tpu", "yaml", "msgpack", "orbax", "tensorstore", "zstandard",
              "zarr")


def _port_sources():
    # chip_smoke.py loads the trajectory replay (tests/fixtures/) on the card, where there is no JAX
    return sorted((_REPO / "midi_vae_tpu_torch").rglob("*.py")) + [
        _REPO / "chip_smoke.py", _REPO / "tests" / "fixtures" / "trajectory_replay.py"]


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
_TWO_STAGE_MODULES = ("cli/train_prior.py", "losses/vq.py", "models/moe_prior.py", "models/prior.py", "models/vq.py")


# the training variants (the β-TC objective, MLPVAE, the optax-rule optimizers and schedules)
_VARIANT_MODULES = ("losses/tcvae.py", "models/mlp.py", "train/optim.py", "train/schedules.py")


# the model variants' interop and the exported serving artifact
_ARTIFACT_MODULES = ("interop/aot_export.py", "interop/torch_reference.py")


# the data and utility modules (the native runtime's bindings, checkpoints, cache, probe)
_DATA_UTILITY_MODULES = (
    "core/backend_check.py", "core/compile_cache.py", "io/dcp_io.py", "io/flax_msgpack.py", "native/__init__.py",
    "native/_build.py", "native/midiparse.py", "native/rrd.py",
)


# the reader of JAX Orbax checkpoints (zstd, OCDBT, zarr v2)
_ORBAX_READER_MODULES = ("io/ocdbt.py", "io/orbax_read.py", "io/zarr2.py", "native/zstd.py")


# the public surface added last: the package's metadata and the PNG decoder
_PUBLIC_API_MODULES = ("__meta__.py", "native/png.py")


def test_public_api_modules_are_among_the_guarded_sources():
    guarded = {p.relative_to(_REPO / "midi_vae_tpu_torch").as_posix() for p in _port_sources()[:-2]}
    assert set(_PUBLIC_API_MODULES) <= guarded


@pytest.mark.parametrize("path", sorted((_REPO / "examples").glob("torch_*.py")), ids=lambda p: p.name)
def test_port_examples_import_nothing_of_jax(path):
    test_port_imports_nothing_of_jax(path)


def test_orbax_reader_modules_are_among_the_guarded_sources():
    guarded = {p.relative_to(_REPO / "midi_vae_tpu_torch").as_posix() for p in _port_sources()[:-2]}
    assert set(_ORBAX_READER_MODULES) <= guarded


def test_data_utility_modules_are_among_the_guarded_sources():
    guarded = {p.relative_to(_REPO / "midi_vae_tpu_torch").as_posix() for p in _port_sources()[:-2]}
    assert set(_DATA_UTILITY_MODULES) <= guarded


def test_inference_modules_are_among_the_guarded_sources():
    guarded = {p.relative_to(_REPO / "midi_vae_tpu_torch").as_posix() for p in _port_sources()[:-2]}
    assert set(_INFERENCE_MODULES) <= guarded


def test_two_stage_modules_are_among_the_guarded_sources():
    guarded = {p.relative_to(_REPO / "midi_vae_tpu_torch").as_posix() for p in _port_sources()[:-2]}
    assert set(_TWO_STAGE_MODULES) <= guarded


def test_variant_modules_are_among_the_guarded_sources():
    guarded = {p.relative_to(_REPO / "midi_vae_tpu_torch").as_posix() for p in _port_sources()[:-2]}
    assert set(_VARIANT_MODULES) <= guarded


def test_artifact_modules_are_among_the_guarded_sources():
    guarded = {p.relative_to(_REPO / "midi_vae_tpu_torch").as_posix() for p in _port_sources()[:-2]}
    assert set(_ARTIFACT_MODULES) <= guarded


def test_artifact_loader_imports_nothing_of_the_models():
    """The artifact loader needs torch and the fused BatchNorm's operators
    alone: importing it pulls in no
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
    modules = _VARIANT_MODULES + _ARTIFACT_MODULES + _ORBAX_READER_MODULES
    assert {"midi_vae_tpu_torch." + m[:-3].replace("/", ".") for m in modules} <= set(imported)


# the port's own stand-ins for libraries the GPU machine lacks (PyYAML, flax's msgpack) and the readers
# held against the JAX package's copies (the npy wire, the SMF parsers)
_STANDIN_MODULES = ("io/yaml_read.py", "io/flax_msgpack.py", "serving/wire.py", "midi/smf.py", "native/midiparse.py")


def test_standin_modules_are_among_the_guarded_sources():
    guarded = {p.relative_to(_REPO / "midi_vae_tpu_torch").as_posix() for p in _port_sources()[:-2]}
    assert set(_STANDIN_MODULES) <= guarded


def test_configs_and_checkpoints_read_with_pyyaml_msgpack_and_flax_blocked():
    """What the GPU machine does without PyYAML, msgpack or flax: every
    ``configs/*.yaml`` through ``from_yaml``, every YAML form fixture equal
    to its ``.json``, and the JAX ``.msgpack`` fixture decoded."""
    code = (
        "import glob, json, math, sys\n"
        f"for name in {_FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        "from midi_vae_tpu_torch.train.config import from_yaml, read_yaml\n"
        "from midi_vae_tpu_torch.io import flax_msgpack\n"
        "configs = [from_yaml(p) for p in sorted(glob.glob('configs/*.yaml'))]\n"
        "block = from_yaml('tests/fixtures/folded_block.yaml')\n"
        "assert len(configs) >= 10 and block == from_yaml('configs/folded.yaml')\n"
        "forms = sorted(glob.glob('tests/fixtures/yaml_forms/*.yaml'))\n"
        "same = lambda a, b: (json.dumps(a, sort_keys=False) == json.dumps(b, sort_keys=False))\n"
        "assert forms and all(same(read_yaml(p), json.load(open(p[:-5] + '.json'))) for p in forms)\n"
        "tree = flax_msgpack.load('tests/fixtures/jax_folded_lines28.msgpack')\n"
        "print(len(configs), len(forms), sorted(tree)[:2])\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def _top_level_imports(path):
    """(module, name) of each import at the top level of ``path``; name is
    None for ``import module``."""
    for node in ast.parse(path.read_text(), str(path)).body:
        if isinstance(node, ast.Import):
            yield from ((a.name, None) for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield from ((node.module, a.name) for a in node.names)


def test_every_port_test_module_runs_on_one_torch_thread():
    """Every port test module imports the autouse ``one_torch_thread`` from
    ``tests/torch_threads.py``, the one place that defines it, and that
    helper imports nothing but torch and pytest. ``test_torch_parity.py``
    predates the port: it belongs to the JAX package's tests."""
    tests = _REPO / "tests"
    helper = tests / "torch_threads.py"
    assert {module.split(".")[0] for module, _ in _top_level_imports(helper)} <= {"pytest", "torch"}
    defining = [p.name for p in sorted(tests.rglob("*.py")) for node in ast.walk(ast.parse(p.read_text(), str(p)))
                if isinstance(node, ast.FunctionDef) and node.name == "one_torch_thread"]
    assert defining == ["torch_threads.py"]
    modules = [p for p in sorted(tests.glob("test_torch_*.py")) if p.name != "test_torch_parity.py"]
    assert len(modules) > 40
    lacking = [p.name for p in modules if ("torch_threads", "one_torch_thread") not in set(_top_level_imports(p))]
    assert not lacking, f"port test modules without one_torch_thread: {lacking}"

"""The public names the PyTorch port took over from the JAX package, each
held against its JAX counterpart on the same inputs, on the CPU:

- ``models/registry.py`` ``register_model``: the JAX test's registration
  (``tests/test_models.py``), and a VanillaVAE subclass registered in both
  packages whose parameters carry across with ``interop/from_jax.py`` name
  for name and shape for shape (and give the JAX forward), then trained
  through ``cli.train --model <name>``;
- ``midi/rasterize.py`` ``rasterize_batch``: bitwise, on seeded padded note
  arrays with empty rows, overlapping notes and pitches off the roll;
- ``midi/rasterize.py`` ``augment_pianoroll``: bitwise given JAX's own
  draws (read from its key as its code splits it);
- ``data/sources.py`` ``write_image_folder``: the JAX package's file names
  and class folders, the decoded pixels bitwise (the PNG bytes differ: the
  port writes them with its own encoder, the JAX package with Pillow), and
  read back by the port's loader with Pillow blocked;
- the package re-exports and ``__version__``, and that importing
  ``midi_vae_tpu_torch.native`` or ``.midi`` builds nothing.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import midi_vae_tpu
import midi_vae_tpu.interop as jax_interop
import midi_vae_tpu.midi as jax_midi
import midi_vae_tpu.native as jax_native
import midi_vae_tpu_torch
import midi_vae_tpu_torch.data.fetch as fetch
import midi_vae_tpu_torch.interop as interop
import midi_vae_tpu_torch.midi as midi
import midi_vae_tpu_torch.native as native
from midi_vae_tpu.data.sources import load_image_folder as jax_load_image_folder
from midi_vae_tpu.data.sources import write_image_folder as jax_write_image_folder
from midi_vae_tpu.midi import rasterize as jax_rasterize
from midi_vae_tpu.models import registry as jax_registry
from midi_vae_tpu.models.vae import VanillaVAE as JaxVanillaVAE
from midi_vae_tpu_torch.cli import train as train_cli
from midi_vae_tpu_torch.data.sources import load_image_folder, write_image_folder
from midi_vae_tpu_torch.interop.from_jax import load_flax_variables
from midi_vae_tpu_torch.midi import rasterize
from midi_vae_tpu_torch.models import registry
from midi_vae_tpu_torch.models.mlp import MLPVAE
from midi_vae_tpu_torch.models.vae import VanillaVAE
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------ register_model


class JaxNarrowVAE(JaxVanillaVAE):
    """A JAX VanillaVAE subclass with widths of its own."""

    hidden_dims: tuple = (8, 16)


class NarrowVAE(VanillaVAE):
    """The port's twin of :class:`JaxNarrowVAE`."""

    def __init__(self, hidden_dims=(8, 16), **kwargs):
        super().__init__(hidden_dims=hidden_dims, **kwargs)


@pytest.fixture
def registered():
    """``NarrowVAE`` under "NarrowVAE" in both registries, removed afterwards."""
    jax_registry.register_model("NarrowVAE", JaxNarrowVAE)
    registry.register_model("NarrowVAE", NarrowVAE)
    yield "NarrowVAE"
    jax_registry.MODEL_REGISTRY.pop("narrowvae", None)
    registry.MODEL_REGISTRY.pop("narrowvae", None)


def test_register_model_extension_hook():
    """The JAX test's case: MLPVAE under a new name builds through the same
    factory, with MLPVAE's keyword set."""
    registry.register_model("MyVAE", MLPVAE)
    try:
        m = registry.build_model("myvae", in_channels=1, latent_dim=4, input_dim=16, hidden_dims=(32,), device="cpu")
        assert isinstance(m, MLPVAE)
        with pytest.raises(ValueError, match="MLPVAE has no norm layers"):
            registry.build_model("MyVAE", in_channels=1, latent_dim=4, input_dim=16, norm="group", device="cpu")
    finally:
        registry.MODEL_REGISTRY.pop("myvae", None)


def _flax_leaves(tree) -> int:
    return len(jax.tree_util.tree_leaves(tree))


def test_registered_subclass_carries_across_from_jax(registered):
    kw = dict(in_channels=1, latent_dim=4, input_dim=32, fused_reparam=True)
    jmodel = jax_registry.build_model(registered, **kw)
    variables = jax.jit(lambda k: jmodel.init({"params": k, "reparam": k}, jnp.zeros((2, 32, 32, 1))))(
        jax.random.PRNGKey(0))
    model = registry.build_model(registered.lower(), device="cpu", **kw)
    assert type(model) is NarrowVAE and model.hidden_dims == (8, 16) and model.fused_reparam
    load_flax_variables(model, variables["params"], variables["batch_stats"])  # raises on a name or shape it lacks
    assert len(model.state_dict()) == _flax_leaves(variables["params"]) + _flax_leaves(variables["batch_stats"])
    x = np.random.default_rng(0).uniform(0, 1, (2, 32, 32, 1)).astype(np.float32)
    forward = jax.jit(lambda v, xb: jmodel.apply(v, xb, method=lambda m, b: m.decode(m.encode(b, train=False).mu,
                                                                                       train=False)))
    want = forward(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model.eval().decode(model.encode(torch.from_numpy(x)).mu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_cli_model_flag_reaches_a_registered_architecture(registered, tmp_path, monkeypatch):
    monkeypatch.setitem(fetch.SYNTHETIC_SIZES, "vae-lines-synthetic", 256)
    r = train_cli.cli(["--dataset", "vae-lines-synthetic", "--transform-type", "noaug", "--image-size", "28",
                       "--model", registered, "--hidden-dims", "8", "16", "--n_features", "4", "--epochs", "1",
                       "--batch-size", "64", "--models-dir", str(tmp_path), "--cpu"])
    assert type(r["state"].model) is NarrowVAE and np.isfinite(r["train"]["loss"])


# ------------------------------------------------------ rasterize, augment


def _notes(rng, b, n, pitches):
    onset = rng.uniform(-6, 40, (b, n)).astype(np.float32)
    dur = rng.uniform(0.2, 9, (b, n)).astype(np.float32)
    pitch = rng.integers(-2, pitches + 3, (b, n)).astype(np.int32)  # a few off the roll
    pitch[:, :4] = 5  # overlapping notes on one pitch
    onset[:, :4] = [1.0, 2.5, 3.0, 2.0]
    vel = rng.uniform(0, 1, (b, n)).astype(np.float32)
    valid = rng.uniform(size=(b, n)) > 0.2
    valid[1] = False  # an empty row
    return onset, dur, pitch, vel, valid


def test_rasterize_batch_matches_jax_bitwise():
    notes = _notes(np.random.default_rng(5), 6, 20, 16)
    want = np.asarray(jax_rasterize.rasterize_batch(*map(jnp.asarray, notes), pitches=16, steps=32))
    got = rasterize.rasterize_batch(*map(torch.from_numpy, notes), pitches=16, steps=32)
    assert got.shape == want.shape == (6, 16, 32, 1) and got.dtype == torch.float32
    assert got.numpy().tobytes() == want.tobytes()
    assert not got[1].any() and got[0, 5].any()
    one = rasterize.rasterize_notes(*(torch.from_numpy(a[0]) for a in notes), pitches=16, steps=32)
    assert torch.equal(one, got[0, :, :, 0])


@pytest.mark.parametrize("seed", [0, 9, 123])
def test_augment_pianoroll_matches_jax_given_its_draws(seed):
    key = jax.random.PRNGKey(seed)
    roll = jax.random.uniform(jax.random.PRNGKey(seed + 1), (20, 24, 1))
    want = np.asarray(jax_rasterize.augment_pianoroll(key, roll, max_pitch_shift=6, max_time_shift=16,
                                                      velocity_scale=(0.7, 1.2)))
    k_pitch, k_time, k_vel = jax.random.split(key, 3)  # as midi/rasterize.py splits it
    dp = int(jax.random.randint(k_pitch, (), -6, 7))
    dt = int(jax.random.randint(k_time, (), -16, 17))
    scale = float(jax.random.uniform(k_vel, (), minval=0.7, maxval=1.2))
    got = rasterize.augment_pianoroll(torch.from_numpy(np.array(roll)), pitch_shift=dp, time_shift=dt, scale=scale)
    assert got.shape == want.shape and got.numpy().tobytes() == want.tobytes()


def test_augment_pianoroll_draws_from_a_generator():
    roll = torch.ones((16, 40, 1))
    outs = [rasterize.augment_pianoroll(roll, generator=torch.Generator().manual_seed(s), max_pitch_shift=3,
                                        max_time_shift=5) for s in range(64)]
    assert all(o.shape == roll.shape and float(o.min()) >= 0 and float(o.max()) <= 1 for o in outs)
    assert len({int((o[:, 20, 0] == 0).sum()) for o in outs}) > 1  # the pitch shift varies
    again = rasterize.augment_pianoroll(roll, generator=torch.Generator().manual_seed(3), max_pitch_shift=3,
                                        max_time_shift=5)
    assert torch.equal(again, outs[3])


# -------------------------------------------------------- write_image_folder


def _tree(path):
    return sorted(os.path.relpath(os.path.join(d, f), path) for d, _, files in os.walk(path) for f in files)


@pytest.mark.parametrize("channels", [1, 3])
def test_write_image_folder_matches_jax(tmp_path, monkeypatch, channels):
    rng = np.random.default_rng(channels)
    images = rng.integers(0, 256, (11, 9, 7, channels), dtype=np.uint8)
    labels = rng.integers(0, 3, 11)
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_write_image_folder(images, labels, jax_dir)
    write_image_folder(images, labels, port_dir)
    assert _tree(port_dir) == _tree(jax_dir) and len(_tree(port_dir)) == 11
    for rel in _tree(jax_dir):
        with Image.open(os.path.join(jax_dir, rel)) as a, Image.open(os.path.join(port_dir, rel)) as b:
            assert a.mode == b.mode and np.asarray(a).tobytes() == np.asarray(b).tobytes(), rel
    want = jax_load_image_folder(jax_dir)
    monkeypatch.setitem(sys.modules, "PIL", None)
    got = load_image_folder(port_dir)
    assert np.array_equal(got.images, want.images) and np.array_equal(got.labels, want.labels)
    assert got.class_names == list(want.class_names)


def test_write_image_folder_refuses_other_dtypes(tmp_path):
    with pytest.raises(ValueError, match="uint8"):
        write_image_folder(np.zeros((1, 4, 4, 1), np.float32), np.zeros(1, np.int64), str(tmp_path))


# --------------------------------------------------- re-exports and version


def test_version_is_the_jax_packages():
    assert midi_vae_tpu_torch.__version__ == midi_vae_tpu.__version__


@pytest.mark.parametrize("package,jax_package,name,module", [
    (midi, jax_midi, "NoteArrays", "midi_vae_tpu_torch.midi.smf"),
    (midi, jax_midi, "read_smf", "midi_vae_tpu_torch.midi.smf"),
    (midi, jax_midi, "write_smf", "midi_vae_tpu_torch.midi.smf"),
    (interop, jax_interop, "import_reference_state_dict", "midi_vae_tpu_torch.interop.torch_reference"),
    (native, jax_native, "NativeDataset", "midi_vae_tpu_torch.native.rrd"),
    (native, jax_native, "NativeLoader", "midi_vae_tpu_torch.native.rrd"),
    (native, jax_native, "write_rrd", "midi_vae_tpu_torch.data.sources"),
], ids=lambda v: v if isinstance(v, str) else None)
def test_package_re_exports_the_objects_of_its_submodules(package, jax_package, name, module):
    assert hasattr(jax_package, name)
    assert getattr(package, name) is getattr(sys.modules[module], name)


def test_importing_native_and_midi_builds_nothing(tmp_path):
    build = tmp_path / "kernels"
    code = ("import midi_vae_tpu_torch.native, midi_vae_tpu_torch.midi, midi_vae_tpu_torch.interop; "
            "from midi_vae_tpu_torch.native import _build; print('cached', _build.library.cache_info().currsize)")
    env = {**os.environ, "PYTHONPATH": _REPO, "MIDI_VAE_TORCH_KERNEL_DIR": str(build)}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "built" not in out.stdout and out.stdout.strip().endswith("cached 0")
    assert not build.exists()


# ------------------------------------------------------------- surface guard

# JAX public names the port keeps under another module: JAX "module.name" →
# port "module.name", each with the reason
RELOCATED = {
    "native.rrd.write_rrd": ("data.sources.write_rrd", "the RRD format is numpy; the port's streams read it there"),
    "native.rrd.read_rrd": ("data.sources.read_rrd", "beside write_rrd and the RRD streams"),
    "interop.torch_export.export_reference_state_dict": (
        "interop.torch_reference.export_reference_state_dict", "both directions of the reference state_dict"),
    "interop.torch_export.main": ("interop.torch_reference.main", "the export CLI of that module"),
    "interop.torch_import.import_reference_state_dict": (
        "interop.torch_reference.import_reference_state_dict", "both directions of the reference state_dict"),
    "interop.torch_import.flatten_permutation": ("interop.torch_reference.flatten_permutation",
                                                 "the flatten order both directions use"),
    "io.orbax_io.save_checkpoint_orbax": ("io.dcp_io.save_checkpoint_dcp",
                                          "--checkpoint-backend orbax writes torch.distributed.checkpoint files"),
    "io.orbax_io.OrbaxAsyncWriter": ("io.dcp_io.DCPAsyncWriter", "the async writer of those files"),
    "io.orbax_io.load_checkpoint_orbax": ("io.dcp_io.load_checkpoint_dcp",
                                          "reads DCP directories, and JAX Orbax ones through io/orbax_read.py"),
    "io.orbax_io.is_orbax_checkpoint": ("io.dcp_io.is_orbax_checkpoint", "beside the loader"),
}

# JAX public names with no meaning in torch (ROADMAP Queue 1, item 18), each with the reason
JAX_ONLY = {
    "core.rng.root_key": "a JAX PRNG key; the port seeds torch generators from the same integer seeds",
    "core.rng.epoch_key": "a JAX PRNG key of an epoch; the port derives integer epoch seeds",
    "data.pipeline.put_sharded": "places a host batch on a jax.sharding; the port's loaders copy to the rank's device",
    "parallel.mesh.batch_sharding": "a jax.sharding.NamedSharding; torch.distributed ranks hold their own rows",
    "parallel.mesh.data_axes": "names of jax.sharding mesh axes; the port's Mesh keeps one process group per axis",
    "parallel.mesh.replicated": "a replicated jax.sharding; torch tensors are replicated by each rank holding them",
    "parallel.mesh.shard_batch": "jax.device_put onto a sharding; the port's mesh.local_rows cuts a rank's rows",
    "parallel.collectives.psum_mean": "a lax collective under shard_map; the port's in-place psum_mean_ replaces it",
    "models.vae.init_stats": "flax's batch_stats collection at init; torch modules own their running buffers",
    "train.state.accumulate_grads": "the port builds accumulation into make_train_step(grad_accum=)",
    "cli.train_prior.make_chunk_step": "a lax.scan of prior steps; the port's --scan-steps sets its host-read interval",
    "models.prior.make_prior_train_step": "a jitted flax step; cli/train_prior.py steps the port's module",
    "native._build.load_library": "JAX falls back to Python when a build fails; the port's build raises instead",
    "native.rrd.native_available": "the port raises when the host library cannot be built, so none asks",
    "native.midiparse.native_midiparse_available": "the port raises when the library cannot be built, so none asks",
}


def _jax_public_names():
    """``(module, name)`` of every public function and class the JAX
    package's Python modules define (names they import are skipped)."""
    import importlib
    import importlib.util
    import inspect
    import pkgutil

    out = []
    for info in pkgutil.walk_packages(midi_vae_tpu.__path__, "midi_vae_tpu."):
        if not importlib.util.find_spec(info.name).origin.endswith(".py"):
            continue  # a host library the JAX package built beside its sources
        module = importlib.import_module(info.name)
        for name, obj in vars(module).items():
            if not name.startswith("_") and (inspect.isfunction(obj) or inspect.isclass(obj)) \
                    and obj.__module__ == info.name:
                out.append((info.name[len("midi_vae_tpu."):], name))
    return out


def _port_object(path: str):
    import importlib

    module, _, name = path.rpartition(".")
    try:
        return getattr(importlib.import_module("midi_vae_tpu_torch." + module), name, None)
    except ModuleNotFoundError:
        return None


def test_every_public_name_of_the_jax_package_has_a_counterpart_in_the_port():
    names = _jax_public_names()
    assert len(names) > 150
    unmatched = []
    for module, name in names:
        key = f"{module}.{name}"
        if _port_object(key) is not None:
            assert key not in RELOCATED and key not in JAX_ONLY, f"{key} is in the port: drop it from the tables"
        elif key in RELOCATED:
            assert _port_object(RELOCATED[key][0]) is not None, f"{key} moved to {RELOCATED[key][0]}, which is missing"
        elif key not in JAX_ONLY:
            unmatched.append(key)
    assert not unmatched, f"JAX public names the port lacks: {unmatched}"
    listed = {f"{m}.{n}" for m, n in names}
    assert set(RELOCATED) <= listed and set(JAX_ONLY) <= listed, "a table names something the JAX package lacks"
    assert all(reason for _, reason in RELOCATED.values()) and all(JAX_ONLY.values())

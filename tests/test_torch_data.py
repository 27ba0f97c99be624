"""Data side of the PyTorch port vs the JAX package, on the CPU: seeds and
epoch permutations, splits, the synthetic MIDI corpus (16 files) through
the factory, parser and rasterizer, the RRD cache in both directions,
corpus statistics, the transform stacks, the piano-roll augmentation and
both loaders' epoch order and eval masks.

Tolerances: everything bitwise except the augmentation (1e-6, with the
shifts and scales injected on both sides) and ``rasterize_notes`` (exact
too: both take the max of the same f32 velocities).
"""

import dataclasses
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import midi_vae_tpu.data.fetch as jax_fetch
import midi_vae_tpu_torch.data.fetch as fetch
from midi_vae_tpu.core import rng as jax_rng
from midi_vae_tpu.data import pipeline as jax_pipeline
from midi_vae_tpu.data import splits as jax_splits
from midi_vae_tpu.data import stats as jax_stats
from midi_vae_tpu.data import transforms as jax_transforms
from midi_vae_tpu.data.sources import ArrayDataset as JaxArrayDataset
from midi_vae_tpu.data.sources import load_midi_folder as jax_load_midi_folder
from midi_vae_tpu.data.synthetic import generate_line_images as jax_generate_line_images
from midi_vae_tpu.midi import rasterize as jax_rasterize
from midi_vae_tpu.midi.smf import read_smf as jax_read_smf
from midi_vae_tpu.native.rrd import read_rrd as jax_read_rrd
from midi_vae_tpu.native.rrd import write_rrd as jax_write_rrd
from midi_vae_tpu_torch.core import rng
from midi_vae_tpu_torch.data import pipeline, splits, stats, transforms
from midi_vae_tpu_torch.data.sources import ArrayDataset, load_midi_folder, read_rrd, write_rrd
from midi_vae_tpu_torch.data.synthetic import generate_line_images
from midi_vae_tpu_torch.midi import rasterize
from midi_vae_tpu_torch.midi.factory import generate_midi_dataset
from midi_vae_tpu_torch.midi.parse import parse_midi
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N_FILES = 16


@pytest.fixture(scope="module")
def midi_corpora(tmp_path_factory):
    """The 16-file midi-synthetic corpus through each package's fetch, each
    with its own temp root (``SYNTHETIC_SIZES`` cut in both packages)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_fetch.SYNTHETIC_SIZES, "midi-synthetic", N_FILES)
        mp.setitem(fetch.SYNTHETIC_SIZES, "midi-synthetic", N_FILES)
        import tempfile

        for name, fn in (("jax", jax_fetch._synthetic_dataset), ("torch", fetch._synthetic_dataset)):
            mp.setattr(tempfile, "tempdir", str(tmp_path_factory.mktemp(name)))
            kw = {} if name == "jax" else {"device": "cpu"}
            out[name] = fn("midi-synthetic", **kw)
        out["torch_dir"] = fetch.synthetic_midi_dir("midi-synthetic")
    return out


@pytest.mark.parametrize("seed,epoch,process", [(0, 1, 0), (7, 3, 0), (2**33 + 5, 12, 1)])
def test_host_rng_permutations_match_jax(seed, epoch, process):
    assert rng.host_epoch_seed(seed, epoch, process) == jax_rng.host_epoch_seed(seed, epoch, process)
    np.testing.assert_array_equal(
        rng.host_rng(seed, epoch, process).permutation(1000), jax_rng.host_rng(seed, epoch, process).permutation(1000)
    )


def test_epoch_seeds_are_resume_stable_and_distinct():
    seeds = {rng.epoch_seed(s, e) for s in range(4) for e in range(1, 50)}
    assert len(seeds) == 4 * 49 and all(0 <= v < 2**31 for v in seeds)
    assert rng.epoch_seed(3, 7) == rng.epoch_seed(3, 7)
    with pytest.raises(ValueError):
        rng.epoch_seed(0, 0)


@pytest.mark.parametrize("n,seed", [(10, 0), (1024, 3)])
def test_train_test_split_matches_jax(n, seed):
    for a, b in zip(splits.random_train_test_split(n, 0.8, seed), jax_splits.random_train_test_split(n, 0.8, seed)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("labels", [None, np.arange(100) % 3])
def test_kfold_split_matches_jax(labels):
    got = splits.create_train_val_split(100, labels=labels, split_rate=0.2, split_id=6)
    want = jax_splits.create_train_val_split(100, labels=labels, split_rate=0.2, split_id=6)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_line_images_match_jax():
    for a, b in zip(generate_line_images(64, seed=4), jax_generate_line_images(64, seed=4)):
        np.testing.assert_array_equal(a, b)


def test_synthetic_midi_corpus_matches_jax(midi_corpora):
    got, want = midi_corpora["torch"], midi_corpora["jax"]
    assert got.images.dtype == np.uint8 and got.images.shape == want.images.shape and len(got) > N_FILES
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert "midi_vae_tpu_torch_synth_16files_0" in midi_corpora["torch_dir"]


def test_notes_to_windows_and_parse_match_jax(tmp_path):
    generate_midi_dataset(4, str(tmp_path), seed=11, max_notes=200)
    files = sorted(tmp_path.rglob("*.mid"))
    assert len(files) == 4
    for f in files:
        notes, jnotes = parse_midi(str(f)), jax_read_smf(str(f))
        for field in ("onset", "duration", "pitch", "velocity"):
            np.testing.assert_array_equal(getattr(notes, field), getattr(jnotes, field))
        for kw in (dict(), dict(steps=64, seconds_per_step=0.03), dict(min_notes_per_window=0)):
            np.testing.assert_array_equal(rasterize.notes_to_windows(notes, **kw), jax_rasterize.notes_to_windows(jnotes, **kw))


def test_load_midi_folder_and_rrd_cache_interchange(tmp_path):
    """Both packages read each other's rasterized-corpus cache."""
    generate_midi_dataset(6, str(tmp_path / "a"), seed=2)
    generate_midi_dataset(6, str(tmp_path / "b"), seed=2)
    got = load_midi_folder(str(tmp_path / "a"))  # writes the cache in the port
    want = jax_load_midi_folder(str(tmp_path / "b"))  # and in the JAX package
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.class_names == want.class_names
    for port_dir, jax_dir in (("a", "b"), ("b", "a")):
        cached = load_midi_folder(str(tmp_path / port_dir))
        jcached = jax_load_midi_folder(str(tmp_path / jax_dir))
        np.testing.assert_array_equal(cached.images, np.asarray(jcached.images))
        np.testing.assert_array_equal(cached.labels, jcached.labels)


def test_rrd_roundtrip_both_ways(tmp_path):
    images = np.random.default_rng(0).integers(0, 256, (5, 4, 3, 2), dtype=np.uint8)
    labels = np.arange(5, dtype=np.int64) * 7
    write_rrd(images, labels, str(tmp_path / "p.rrd"))
    jax_write_rrd(images, labels, str(tmp_path / "j.rrd"))
    assert (tmp_path / "p.rrd").read_bytes() == (tmp_path / "j.rrd").read_bytes()
    for a, b in zip(read_rrd(str(tmp_path / "j.rrd")), jax_read_rrd(str(tmp_path / "p.rrd"), mmap=False)):
        np.testing.assert_array_equal(a, b)
    (tmp_path / "short.rrd").write_bytes((tmp_path / "p.rrd").read_bytes()[:-8])
    with pytest.raises(ValueError, match="corrupt"):
        read_rrd(str(tmp_path / "short.rrd"))


def test_base_rate_matches_jax(midi_corpora):
    ds, jds = midi_corpora["torch"], midi_corpora["jax"]
    assert stats.estimate_base_rate(ds) == jax_stats.estimate_base_rate(jds)
    assert stats.estimate_base_rate(ds, max_samples=5, seed=3) == jax_stats.estimate_base_rate(jds, max_samples=5, seed=3)
    for what in ("bias", "pos_weight"):
        assert stats.resolve_auto("auto", ds, what) == jax_stats.resolve_auto("auto", jds, what)
        assert stats.resolve_auto(0.25, ds, what) == 0.25 and stats.resolve_auto(None, ds, what) is None


@pytest.mark.parametrize("kind", ["pianoroll", "noaug", "digits", "midi"])
def test_eval_transform_matches_jax(kind):
    """Bitwise for the one-channel stacks; the midi stack's grayscale sums
    three products, which XLA may round in another order: 1e-6 there."""
    size = 12
    batch = np.random.default_rng(1).integers(0, 256, (3, size, size, 3 if kind == "midi" else 1), dtype=np.uint8)
    spec, jspec = transforms.get_transform(kind, size)[1], jax_transforms.get_transform(kind, size)[1]
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    got = transforms.apply_transform(spec, torch.from_numpy(batch))
    want = np.asarray(jax_transforms.apply_transform(jspec, jnp.asarray(batch)))
    if kind == "midi":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(got.numpy(), want)
    x = torch.from_numpy(want.copy())
    np.testing.assert_array_equal(
        transforms.denormalize(spec, x).numpy(), np.asarray(jax_transforms.denormalize(jspec, jnp.asarray(want)))
    )


def test_center_crop_and_random_crop_shapes():
    x = torch.arange(2 * 10 * 8, dtype=torch.uint8).reshape(2, 10, 8, 1)
    spec = transforms.TransformSpec(image_size=8, random_crop=True)
    out = transforms.apply_transform(spec, x, seed=3)
    assert out.shape == (2, 8, 8, 1)
    np.testing.assert_array_equal(
        transforms.apply_transform(dataclasses.replace(spec, random_crop=False), x).numpy(),
        np.asarray(jax_transforms.apply_transform(jax_transforms.TransformSpec(image_size=8), jnp.asarray(x.numpy()))),
    )
    # a random crop is a window of the image
    center = dataclasses.replace(spec, random_crop=False)
    for b in range(2):
        windows = [transforms.apply_transform(center, x[b : b + 1, i : i + 8])[0] for i in range(3)]
        assert any(torch.equal(out[b], w) for w in windows)


def test_augmentation_matches_jax_with_injected_draws():
    key = jax.random.PRNGKey(9)
    rolls = jax.random.uniform(jax.random.PRNGKey(1), (5, 20, 24, 1))
    want = np.asarray(
        jax_rasterize.augment_pianoroll_batch(key, rolls, max_pitch_shift=6, max_time_shift=16, velocity_scale=(0.7, 1.2))
    )
    # the JAX draws, read from its own per-sample keys (midi/rasterize.py:165-178)
    dps, dts, scales = [], [], []
    for k in jax.random.split(key, 5):
        k_pitch, k_time, k_vel = jax.random.split(k, 3)
        dps.append(int(jax.random.randint(k_pitch, (), -6, 7)))
        dts.append(int(jax.random.randint(k_time, (), -16, 17)))
        scales.append(float(jax.random.uniform(k_vel, (), minval=0.7, maxval=1.2)))
    got = rasterize.augment_pianoroll_batch(
        torch.from_numpy(np.asarray(rolls)), pitch_shift=torch.tensor(dps), time_shift=torch.tensor(dts),
        scale=torch.tensor(scales, dtype=torch.float32),
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_augmentation_draws_cover_their_ranges():
    rolls = torch.ones((512, 16, 40, 1))
    out = rasterize.augment_pianoroll_batch(rolls, generator=torch.Generator().manual_seed(0), max_pitch_shift=3, max_time_shift=5)
    assert out.shape == rolls.shape and float(out.min()) >= 0.0 and float(out.max()) <= 1.0
    zero_rows = (out[:, :, 10, 0] == 0).sum(1)  # rows vacated by the pitch shift
    assert set(zero_rows.tolist()) == {0, 1, 2, 3}
    scale = out.amax(dim=(1, 2, 3))
    assert 0.7 <= float(scale.min()) < 0.75 and 1.0 == float(scale.max())


def test_rasterize_notes_matches_jax():
    r = np.random.default_rng(5)
    n = 12
    onset = (r.uniform(-5, 40, n)).astype(np.float32)
    dur = r.uniform(0.2, 9, n).astype(np.float32)
    pitch = r.integers(0, 16, n).astype(np.int32)
    vel = r.uniform(0, 1, n).astype(np.float32)
    valid = r.uniform(size=n) > 0.2
    want = np.asarray(jax_rasterize.rasterize_notes(*map(jnp.asarray, (onset, dur, pitch, vel, valid)), pitches=16, steps=32))
    got = rasterize.rasterize_notes(*map(torch.from_numpy, (onset, dur, pitch, vel, valid)), pitches=16, steps=32)
    np.testing.assert_array_equal(got.numpy(), want)


def _datasets(n=37):
    r = np.random.default_rng(2)
    images = r.integers(0, 256, (n, 6, 6, 1), dtype=np.uint8)
    labels = r.integers(0, 4, n).astype(np.int64)
    spec = transforms.TransformSpec(image_size=6)
    jspec = jax_transforms.TransformSpec(image_size=6)
    return ArrayDataset(images, labels, transform=spec), JaxArrayDataset(images, labels, transform=jspec)


@pytest.mark.parametrize("placement", ["host", "device"])
@pytest.mark.parametrize("train", [True, False])
def test_loader_order_and_masks_match_jax(placement, train):
    ds, jds = _datasets()
    loader = pipeline.make_loader(ds, 8, train=train, seed=5, device="cpu", placement=placement)
    jloader = jax_pipeline.make_loader(jds, 8, train=train, seed=5, placement=placement)
    assert len(loader) == len(jloader) == (4 if train else 5) and loader.num_samples == jloader.num_samples
    for epoch in (1, 2):
        batches, jbatches = list(loader.epoch(epoch)), list(jloader.epoch(epoch))
        assert len(batches) == len(jbatches)
        for b, jb in zip(batches, jbatches):
            np.testing.assert_array_equal(b.x.numpy(), np.asarray(jb.x))
            np.testing.assert_array_equal(b.y.numpy(), np.asarray(jb.y))
            np.testing.assert_array_equal(b.mask.numpy(), np.asarray(jb.mask))
    if not train:
        assert batches[-1].mask.tolist() == [1.0] * 5 + [0.0] * 3


def test_host_and_resident_loaders_agree_with_augmentation():
    """Train batches of the pianoroll stack (random shifts and scales) are
    the same from both loaders: the draws are keyed by (seed, epoch, batch)."""
    ds, _ = _datasets(50)
    ds = ds.with_transform(transforms.get_transform("pianoroll", 6)[0])
    host = pipeline.make_loader(ds, 16, train=True, seed=1, device="cpu", placement="host")
    resident = pipeline.make_loader(ds, 16, train=True, seed=1, device="cpu", placement="device")
    a, b = list(host.epoch(3)), list(resident.epoch(3))
    assert len(a) == 3
    for x, y in zip(a, b):
        assert torch.equal(x.x, y.x) and torch.equal(x.y, y.y)
    assert not torch.equal(a[0].x, list(host.epoch(4))[0].x)


def test_auto_placement_respects_the_budget(monkeypatch):
    ds, _ = _datasets()
    assert isinstance(pipeline.make_loader(ds, 8, train=True, device="cpu", placement="auto"), pipeline.DeviceResidentLoader)
    monkeypatch.setenv("MIDI_VAE_DEVICE_DATA_BUDGET_MB", "0")
    assert isinstance(pipeline.make_loader(ds, 8, train=True, device="cpu", placement="auto"), pipeline.DeviceLoader)
    with pytest.raises(ValueError, match="placement"):
        pipeline.make_loader(ds, 8, train=True, device="cpu", placement="nowhere")
    with pytest.raises(ValueError, match="no batches"):
        pipeline.make_loader(ds, 64, train=True, device="cpu", placement="host")


def test_released_loader_refuses_to_iterate():
    ds, _ = _datasets()
    loader = pipeline.make_loader(ds, 8, train=False, device="cpu", placement="device")
    assert loader.corpus_nbytes > 0
    loader.release()
    with pytest.raises(RuntimeError, match="released"):
        next(loader.epoch(1))


def _write_mnist(root):
    """Tiny MNIST IDX files where ``download_mnist`` puts them."""
    raw = os.path.join(root, "MNIST", "raw")
    os.makedirs(raw, exist_ok=True)
    for prefix, n in (("train", 12), ("t10k", 5)):
        for kind, shape, magic in (("images-idx3", (n, 28, 28), 0x803), ("labels-idx1", (n,), 0x801)):
            header = struct.pack(">I", magic) + struct.pack(">" + "I" * len(shape), *shape)
            with open(os.path.join(raw, f"{prefix}-{kind}-ubyte"), "wb") as f:
                f.write(header + bytes(int(np.prod(shape))))


def test_fetch_partitions_match_jax(monkeypatch, tmp_path):
    spec = transforms.get_transform("noaug", 28)
    jspec = jax_transforms.get_transform("noaug", 28)
    got = fetch.fetch_dataset("vae-lines-synthetic", transform_train=spec[0], transform_eval=spec[1], device="cpu")
    want = jax_fetch.fetch_dataset("vae-lines-synthetic", transform_train=jspec[0], transform_eval=jspec[1])
    assert got[3] is want[3] is False
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)
    proto = fetch.fetch_dataset("vae-lines-synthetic", prototyping=True, protoval_split_rate="auto", device="cpu")
    jproto = jax_fetch.fetch_dataset("vae-lines-synthetic", prototyping=True, protoval_split_rate="auto")
    assert proto[3] and jproto[3]
    for a, b in zip(proto[:3], jproto[:3]):
        np.testing.assert_array_equal(a.labels, b.labels)
    monkeypatch.setenv("MIDI_VAE_DATA_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        fetch.fetch_dataset("mnist", device="cpu")
    # download=True fetches the missing files, then loads them (the fetch itself,
    # over a loopback server: tests/test_torch_downloads.py)
    fetched = []
    monkeypatch.setattr(fetch, "download_mnist", lambda root: fetched.append(root) or _write_mnist(root))
    train, val, test, distinct = fetch.fetch_dataset("mnist", download=True, device="cpu")
    assert fetched == [str(tmp_path)] and (len(train), len(test), distinct) == (12, 5, False)

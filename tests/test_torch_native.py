"""The port's host C++ runtime (``midi_vae_tpu_torch/native/``) against the
JAX package's, on the CPU: the threaded RRD loader's host batches, the
streaming device loader and its rank windows, the native SMF parser, and
the g++ build. Everything is compared bitwise.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import midi_vae_tpu.native.rrd as jax_rrd
from midi_vae_tpu.data.pipeline import NativeDeviceLoader as JaxNativeDeviceLoader
from midi_vae_tpu.data.sources import open_rrd_stream as jax_open_rrd_stream
from midi_vae_tpu.native.midiparse import parse_midi_native as jax_parse_midi_native
from midi_vae_tpu_torch.data.pipeline import DeviceResidentLoader, NativeDeviceLoader, _materialize, make_loader
from midi_vae_tpu_torch.data.sources import open_rrd_stream, write_rrd
from midi_vae_tpu_torch.midi.factory import generate_midi_dataset
from midi_vae_tpu_torch.midi.parse import parse_midi
from midi_vae_tpu_torch.midi.smf import read_smf
from midi_vae_tpu_torch.native import _build
from midi_vae_tpu_torch.native.midiparse import parse_midi_native
from midi_vae_tpu_torch.native.rrd import NativeDataset, NativeLoader
from midi_vae_tpu_torch.ops import cuda_lib
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N_ROWS = 75


@pytest.fixture(scope="module")
def rrd_path(tmp_path_factory):
    rng = np.random.default_rng(0)
    path = str(tmp_path_factory.mktemp("rrd") / "corpus.rrd")
    write_rrd(rng.integers(0, 256, (N_ROWS, 6, 5, 1), dtype=np.uint8), rng.integers(0, 9, N_ROWS), path)
    return path


@pytest.mark.parametrize("shuffle", [True, False], ids=["shuffle", "ordered"])
@pytest.mark.parametrize("drop_last", [True, False], ids=["drop_last", "keep_last"])
def test_native_loader_batches_match_jax_bitwise(rrd_path, shuffle, drop_last):
    subset = np.random.default_rng(1).permutation(N_ROWS)[:61]
    ours = NativeLoader(NativeDataset(rrd_path), 8, drop_last=drop_last, n_threads=3, indices=subset)
    theirs = jax_rrd.NativeLoader(jax_rrd.NativeDataset(rrd_path), 8, drop_last=drop_last, n_threads=3,
                                  indices=subset, reuse_buffers=False)
    assert ours.num_batches == theirs.num_batches == (7 if drop_last else 8)
    for epoch_seed in (5, 2**63 + 7):
        got, want = list(ours.epoch(epoch_seed, shuffle)), list(theirs.epoch(epoch_seed, shuffle))
        assert len(got) == len(want) == ours.num_batches
        for (x, y, v), (xj, yj, vj) in zip(got, want):
            assert v == vj and np.array_equal(x, xj) and np.array_equal(y, yj)
        rows = np.concatenate([y[:v] for _, y, v in got])
        assert len(rows) == (56 if drop_last else 61)
    if not shuffle:  # the split's own order, the tail zero-padded
        labels = jax_rrd.read_rrd(rrd_path)[1]
        assert np.array_equal(rows, labels[subset[: len(rows)]])
        x, y, v = got[-1]
        assert drop_last or (v == 5 and not x[5:].any() and not y[5:].any())


def test_native_loader_fills_caller_buffers_and_checks_rows(rrd_path):
    ds = NativeDataset(rrd_path)
    buf = (torch.zeros((8, 6, 5, 1), dtype=torch.uint8), torch.zeros(8, dtype=torch.int64))
    loader = NativeLoader(ds, 8, drop_last=False, indices=np.arange(10))
    batches = list(loader.epoch(0, shuffle=False, buffers=lambda: buf))
    assert [v for *_, v in batches] == [8, 2] and batches[-1][0] is buf[0]
    want = jax_rrd.read_rrd(rrd_path)[0]
    assert np.array_equal(buf[0][:2].numpy(), want[8:10])
    with pytest.raises(ValueError, match="C-contiguous"):  # the C side writes a whole batch there
        next(loader.epoch(0, buffers=lambda: (buf[0][:4], buf[1])))
    with pytest.raises(ValueError, match="C-contiguous"):
        next(loader.epoch(0, buffers=lambda: (buf[0].transpose(1, 2).contiguous().transpose(1, 2), buf[1])))
    with pytest.raises(IndexError):
        loader.set_indices(np.asarray([N_ROWS]))
    loader.set_indices(np.zeros(0, np.int64))
    assert list(loader.epoch(0)) == []  # an empty subset is empty, not "every row"
    with pytest.raises(FileNotFoundError):
        NativeDataset(rrd_path + ".missing")


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_native_device_loader_matches_jax(rrd_path, train):
    """One rank: the JAX package's epoch seed and shuffle, so its batches
    are the JAX loader's: the same uint8 rows (compared before the scaling
    to [0, 1], which XLA compiles as a multiply by 1/255 and torch computes
    as a division), labels and masks."""
    ours = open_rrd_stream(rrd_path).subset(np.arange(3, 70))
    theirs = jax_open_rrd_stream(rrd_path).subset(np.arange(3, 70))
    got = list(NativeDeviceLoader(ours, 16, train=train, seed=4, device="cpu").epoch(2))
    want = list(JaxNativeDeviceLoader(theirs, 16, train=train, seed=4).epoch(2))
    assert len(got) == len(want) == (4 if train else 5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.x.numpy(), np.asarray(b.x), rtol=2e-7, atol=0)
        np.testing.assert_array_equal(np.rint(a.x.numpy() * 255), np.rint(np.asarray(b.x) * 255))
        np.testing.assert_array_equal(a.y.numpy(), np.asarray(b.y))
        np.testing.assert_array_equal(a.mask.numpy(), np.asarray(b.mask))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_rank_windows_of_two_ranks_are_one_ranks_order(rrd_path, train):
    """Two ranks each stream their half of every global batch; side by side
    they are the rows of the in-memory loader at the global batch (the
    same ``host_rng`` order), the eval tail padded and masked by global
    position, and a rank with no rows in the last eval batch gets an
    all-padding batch."""
    ds = open_rrd_stream(rrd_path)
    B = 12
    whole = list(DeviceResidentLoader(_materialize(ds), B, train=train, seed=3, device="cpu").epoch(1))
    halves = [list(NativeDeviceLoader(ds, B, train=train, seed=3, device="cpu", rows=np.arange(r * 6, r * 6 + 6))
                   .epoch(1)) for r in range(2)]
    assert len(halves[0]) == len(halves[1]) == len(whole) == (6 if train else 7)
    for i, w in enumerate(whole):
        for field in ("x", "y", "mask"):
            joined = torch.cat([getattr(halves[0][i], field), getattr(halves[1][i], field)])
            assert torch.equal(joined, getattr(w, field)), (i, field)
    if not train:  # 75 = 6·12 + 3: rank 1 holds none of the last batch's rows
        assert halves[1][-1].mask.sum() == 0 and not halves[1][-1].x.any() and halves[0][-1].mask.sum() == 3


def test_make_loader_routes_streams(rrd_path, monkeypatch):
    ds = open_rrd_stream(rrd_path)
    assert isinstance(make_loader(ds, 8, train=True, device="cpu", placement="host"), NativeDeviceLoader)
    assert isinstance(make_loader(ds, 8, train=True, device="cpu", placement="device"), DeviceResidentLoader)
    assert isinstance(make_loader(ds, 8, train=True, device="cpu", placement="auto"), DeviceResidentLoader)
    monkeypatch.setenv("MIDI_VAE_DEVICE_DATA_BUDGET_MB", "0")
    assert isinstance(make_loader(ds, 8, train=True, device="cpu", placement="auto"), NativeDeviceLoader)


@pytest.fixture(scope="module")
def midi_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("midi")
    generate_midi_dataset(24, str(root), seed=5, max_notes=64)
    generate_midi_dataset(8, str(root / "structured"), seed=6, style="structured")
    return sorted(str(p) for p in root.rglob("*.mid"))


def test_native_parser_matches_jax_and_the_python_oracle(midi_files):
    assert len(midi_files) == 32
    for path in midi_files:
        ours = parse_midi_native(path)
        assert len(ours.pitch) > 0
        for other in (parse_midi(path), jax_parse_midi_native(path), read_smf(path), parse_midi(path, prefer_native=False)):
            for field in ("onset", "duration", "pitch", "velocity"):
                a, b = getattr(ours, field), getattr(other, field)
                assert a.dtype == b.dtype and np.array_equal(a, b), (path, field)


def test_native_parser_rejects_what_it_cannot_parse(tmp_path, midi_files):
    bad = tmp_path / "bad.mid"
    bad.write_bytes(b"MThd\x00\x00\x00\x06\x00\x00\x00\x01\x00\x60MTrk\x00\x00\x10\x00")
    with pytest.raises(ValueError, match="cannot parse"):
        parse_midi_native(str(bad))
    truncated = tmp_path / "cut.mid"
    truncated.write_bytes(open(midi_files[0], "rb").read()[:-7])
    with pytest.raises(ValueError):
        parse_midi(str(truncated))


def test_host_build_lands_in_the_build_dir_and_a_failure_raises(tmp_path, monkeypatch):
    """The libraries build under ``build_dir()/host/<hash>/`` (never in the
    package tree); a second build finds them; a failing compiler raises."""
    monkeypatch.setenv(cuda_lib.BUILD_DIR_ENV, str(tmp_path / "kernels"))
    built = _build.build()
    assert set(built) == {"rollloader", "midiparse", "zstd", "png"}
    for b in built.values():
        assert b.seconds is not None and b.path.is_file()
        assert tmp_path / "kernels" / "host" in b.path.parents
    assert all(b.seconds is None for b in _build.build().values())
    assert not list((cuda_lib.CSRC.parent / "native").glob("*.so"))

    fake = tmp_path / "bin"
    fake.mkdir()
    (fake / "g++").write_text("#!/bin/sh\necho 'error: nope' >&2\nexit 1\n")
    (fake / "g++").chmod(0o755)
    shutil.rmtree(tmp_path / "kernels")
    monkeypatch.setenv("PATH", f"{fake}{os.pathsep}{os.environ['PATH']}")
    with pytest.raises(RuntimeError, match="(?s)host C\\+\\+ build failed:.*g\\+\\+ exited 1.*nope"):
        _build.build(["midiparse"])
    with pytest.raises(RuntimeError, match="(?s)host C\\+\\+ build failed:.*zstd: g\\+\\+ exited 1"):
        _build.build(["zstd"])
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _build.build(["rollloader"])

"""``--allow-download-dataset`` in the PyTorch port, on the CPU.

A loopback ``http.server`` on 127.0.0.1 serves MNIST-format IDX files and
SVHN ``.mat`` files (``scipy.io.savemat``) written here; both packages'
URL constants point at it. The JAX package's and the port's
``fetch_dataset(..., download=True)`` leave byte-equal files (equal to
what was served) and bitwise-equal datasets; the first MNIST mirror
answering 404 falls through to the next; a file no mirror serves raises
``RuntimeError`` naming it and leaves no partial file; and the train CLI
runs an epoch with ``--allow-download-dataset``. Nothing leaves the host.
"""

import functools
import gzip
import http.server
import os
import struct
import threading

import numpy as np
import pytest
import scipy.io

import midi_vae_tpu.data.sources as jax_sources
import midi_vae_tpu_torch.data.sources as sources
from midi_vae_tpu.data.fetch import fetch_dataset as jax_fetch_dataset
from midi_vae_tpu_torch.cli.train import cli
from midi_vae_tpu_torch.data.fetch import fetch_dataset
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N_TRAIN, N_TEST = 256, 64


def _idx(array: np.ndarray) -> bytes:
    header = struct.pack(">I", 0x0800 | array.ndim) + struct.pack(">" + "I" * array.ndim, *array.shape)
    return gzip.compress(header + array.astype(np.uint8).tobytes(), mtime=0)


class _Quiet(http.server.SimpleHTTPRequestHandler):
    def log_message(self, *args):
        pass


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    """(base URL, served directory): ``mnist/`` and ``svhn/`` hold the files."""
    root = tmp_path_factory.mktemp("served")
    rng = np.random.default_rng(0)
    os.makedirs(root / "mnist")
    for prefix, n in (("train", N_TRAIN), ("t10k", N_TEST)):
        (root / "mnist" / f"{prefix}-images-idx3-ubyte.gz").write_bytes(_idx(rng.integers(0, 256, (n, 28, 28))))
        (root / "mnist" / f"{prefix}-labels-idx1-ubyte.gz").write_bytes(_idx(rng.integers(0, 10, n)))
    os.makedirs(root / "svhn")
    for split, n in (("train", 48), ("test", 16)):
        scipy.io.savemat(str(root / "svhn" / f"{split}_32x32.mat"),
                         {"X": rng.integers(0, 256, (32, 32, 3, n), dtype=np.uint8),
                          "y": rng.integers(1, 11, (n, 1)).astype(np.uint8)})
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), functools.partial(_Quiet, directory=str(root)))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}/", root
    httpd.shutdown()
    httpd.server_close()
    thread.join()


@pytest.fixture()
def urls(server, monkeypatch):
    """Both packages' URL constants on the loopback server; the first MNIST
    mirror is one the server does not have."""
    base, _ = server
    for module in (jax_sources, sources):
        monkeypatch.setattr(module, "_MNIST_URLS", [base + "missing/", base + "mnist/"])
        monkeypatch.setattr(module, "_SVHN_URL", base + "svhn/")
    return server


def _files(directory):
    return {os.path.relpath(os.path.join(d, f), directory): open(os.path.join(d, f), "rb").read()
            for d, _, names in os.walk(directory) for f in names}


@pytest.mark.parametrize("dataset", ["mnist", "svhn"])
def test_downloads_match_the_jax_package(tmp_path, urls, dataset):
    _, served = urls
    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    want = jax_fetch_dataset(dataset, root=str(jax_root), download=True)
    got = fetch_dataset(dataset, root=str(port_root), download=True, device="cpu")
    port_files, jax_files = _files(port_root), _files(jax_root)
    assert port_files == jax_files and len(port_files) == {"mnist": 4, "svhn": 2}[dataset]
    served_files = _files(served / dataset)
    assert {os.path.basename(k): v for k, v in port_files.items()} == served_files
    assert got[3] is want[3] is False
    for a, b in zip(got[:3], want[:3]):
        assert a.images.dtype == b.images.dtype and a.labels.dtype == b.labels.dtype
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)
    assert len(got[0]) == {"mnist": N_TRAIN, "svhn": 48}[dataset]


@pytest.mark.parametrize("dataset", ["mnist", "svhn"])
def test_a_file_no_mirror_serves_raises_naming_it(tmp_path, server, monkeypatch, dataset):
    base, _ = server
    monkeypatch.setattr(sources, "_MNIST_URLS", [base + "missing/", base + "also-missing/"])
    monkeypatch.setattr(sources, "_SVHN_URL", base + "missing/")
    name = {"mnist": "train-images-idx3-ubyte.gz", "svhn": "train_32x32.mat"}[dataset]
    with pytest.raises(RuntimeError, match=f"Could not download {name}.*404"):
        fetch_dataset(dataset, root=str(tmp_path), download=True, device="cpu")
    assert not [f for f in _files(tmp_path)]  # no partial file, no .tmp


def test_without_download_a_missing_dataset_stays_missing(tmp_path, urls):
    with pytest.raises(FileNotFoundError):
        fetch_dataset("mnist", root=str(tmp_path), device="cpu")
    assert not _files(tmp_path)


def test_a_train_epoch_with_allow_download_dataset(tmp_path, urls):
    data_dir = tmp_path / "data"
    results = cli(["--dataset", "mnist", "--data-dir", str(data_dir), "--allow-download-dataset",
                   "--transform-type", "noaug", "--image-size", "28", "--hidden-dims", "8", "16", "--n_features", "4",
                   "--epochs", "1", "--batch-size", "64", "--models-dir", str(tmp_path / "models"), "--cpu"])
    assert results["steps_per_epoch"] == N_TRAIN // 64 and np.isfinite(results["train"]["loss"])
    assert sorted(_files(data_dir)) == sorted(os.path.join("MNIST", "raw", f) for f in sources._MNIST_FILES)

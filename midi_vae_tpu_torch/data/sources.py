"""Dataset sources: in-memory arrays, PNG folders, MIDI folders, MNIST/SVHN
files (counterpart of ``midi_vae_tpu/data/sources.py``).

Every dataset is a contiguous uint8 NHWC numpy array on the host; the
loaders (``data/pipeline.py``) move it to the device as uint8 and
transform it there.

The rasterized MIDI corpus is cached next to its tree in the JAX
package's RRD layout (a 40-byte header of five little-endian uint64
words — magic, n, h, w, c — then the uint8 images, then int64 labels),
read and written here with numpy: a cache written by either package
loads in the other. An RRD file can also be streamed without loading it
(:class:`RRDStreamDataset`, the ``rrd:PATH`` dataset names): its splits
stay lazy row subsets, and the native threaded loader
(``native/rollloader.cc``) gathers each batch from the mapped file.
:func:`download_mnist` and :func:`download_svhn` fetch the MNIST and SVHN
files from the JAX package's (torchvision's) URLs for
``--allow-download-dataset``.
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import struct
from typing import List, Optional, Tuple

import numpy as np

from midi_vae_tpu_torch.data.transforms import TransformSpec

IMG_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp")
MIDI_EXTENSIONS = (".mid", ".midi")

_RRD_MAGIC = 0x5252443144564154
_RRD_HEADER_BYTES = 40


@dataclasses.dataclass
class ArrayDataset:
    """A dataset resident in host memory; ``transform`` is the stack the
    loader applies on the device."""

    images: np.ndarray  # uint8 [N, H, W, C]
    labels: np.ndarray  # int64 [N]
    name: str = ""
    transform: Optional[TransformSpec] = None
    class_names: Optional[List[str]] = None

    def __post_init__(self):
        if self.images.ndim != 4:
            raise ValueError(f"images must be NHWC, got {self.images.shape}")
        if len(self.images) != len(self.labels):
            raise ValueError(f"{len(self.images)} images vs {len(self.labels)} labels")

    def __len__(self) -> int:
        return len(self.images)

    def subset(self, indices: np.ndarray) -> "ArrayDataset":
        return dataclasses.replace(self, images=self.images[indices], labels=self.labels[indices])

    def with_transform(self, transform: TransformSpec) -> "ArrayDataset":
        return dataclasses.replace(self, transform=transform)


# ------------------------------------------------------------------ RRD cache


def write_rrd(images: np.ndarray, labels: np.ndarray, path: str) -> None:
    """Write an NHWC uint8 dataset in the RRD layout, atomically (temp file, rename)."""
    if images.ndim != 4 or images.dtype != np.uint8:
        raise ValueError(f"RRD holds uint8 NHWC images, got {images.dtype} {images.shape}")
    n, h, w, c = images.shape
    header = np.asarray([_RRD_MAGIC, n, h, w, c], dtype=np.uint64)
    with open(path + ".tmp", "wb") as f:
        f.write(header.tobytes())
        f.write(np.ascontiguousarray(images).tobytes())
        f.write(np.ascontiguousarray(labels.astype(np.int64)).tobytes())
    os.rename(path + ".tmp", path)


def read_rrd(path: str, mmap: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """(images uint8 [N, H, W, C], labels int64 [N]) of an RRD file; raises
    on a wrong magic or a file shorter than its header declares. ``mmap``
    maps the images read-only instead of reading them."""
    header = np.fromfile(path, dtype=np.uint64, count=5)
    if len(header) != 5 or header[0] != _RRD_MAGIC:
        raise ValueError(f"not an RRD file: {path}")
    n, h, w, c = (int(v) for v in header[1:])
    image_bytes = n * h * w * c
    need = _RRD_HEADER_BYTES + image_bytes + n * 8
    actual = os.path.getsize(path)
    if actual < need:
        raise ValueError(
            f"corrupt RRD file {path}: header declares {need} bytes, file has {actual} (delete the cache and rebuild)"
        )
    if mmap:
        images = np.memmap(path, dtype=np.uint8, mode="r", offset=_RRD_HEADER_BYTES, shape=(n, h, w, c))
    else:
        images = np.fromfile(path, dtype=np.uint8, count=image_bytes, offset=_RRD_HEADER_BYTES).reshape(n, h, w, c)
    labels = np.fromfile(path, dtype=np.int64, count=n, offset=_RRD_HEADER_BYTES + image_bytes)
    return images, labels


@dataclasses.dataclass
class RRDStreamDataset:
    """An out-of-core dataset: an RRD file streamed by the native threaded
    loader instead of resident arrays. ``indices`` is the split's row
    subset of the file, so splits stay lazy; ``data/pipeline.py``
    ``make_loader`` routes it to ``NativeDeviceLoader``."""

    path: str
    indices: np.ndarray  # int64 rows of the file
    name: str = ""
    transform: Optional[TransformSpec] = None
    is_rrd_stream = True

    def __len__(self) -> int:
        return len(self.indices)

    @property
    def labels(self) -> np.ndarray:
        """This split's labels (reads the label block only)."""
        return read_rrd(self.path, mmap=True)[1][self.indices]

    def subset(self, indices: np.ndarray) -> "RRDStreamDataset":
        return dataclasses.replace(self, indices=self.indices[indices])

    def with_transform(self, transform: TransformSpec) -> "RRDStreamDataset":
        return dataclasses.replace(self, transform=transform)


def open_rrd_stream(path: str) -> RRDStreamDataset:
    """An RRD file as a streaming dataset over all its rows (header checked)."""
    n = rrd_shape(path)[0]
    return RRDStreamDataset(path=path, indices=np.arange(n, dtype=np.int64), name=os.path.basename(path))


def rrd_shape(path: str) -> Tuple[int, int, int, int]:
    """(n, h, w, c) of an RRD file, from its checked header."""
    return read_rrd(path, mmap=True)[0].shape


# ---------------------------------------------------------------- ImageFolder


def _read_image(path: str) -> np.ndarray:
    """One image file as the uint8 array ``np.asarray(PIL.Image.open(path))``
    gives: PNGs through the port's own decoder (``native/png.py``), the
    other formats through Pillow, which raises naming itself when missing."""
    if path.lower().endswith(".png"):
        from midi_vae_tpu_torch.native.png import read_png

        return read_png(path)
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: decoding {os.path.splitext(path)[1]} images needs Pillow (PIL), which cannot "
                          "be imported; PNG folders load without it") from e
    with Image.open(path) as im:
        return np.asarray(im)


def load_image_folder(root: str) -> ArrayDataset:
    """A class-per-subdirectory image tree (ImageFolder semantics: classes =
    sorted subdirectories, files sorted within each), stacked into one
    uint8 array; a ``_cache.npz`` sidecar skips decoding next time. PNGs
    decode without Pillow; the other formats need it."""
    cache = os.path.join(root, "_cache.npz")
    if os.path.isfile(cache):
        data = np.load(cache, allow_pickle=False)
        return ArrayDataset(
            images=data["images"],
            labels=data["labels"].astype(np.int64),
            name=os.path.basename(root),
            class_names=[str(c) for c in data["class_names"]],
        )
    classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    if not classes:
        raise FileNotFoundError(f"No class subdirectories under {root}")
    images, labels = [], []
    for idx, cls in enumerate(classes):
        cdir = os.path.join(root, cls)
        for fname in sorted(os.listdir(cdir)):
            if not fname.lower().endswith(IMG_EXTENSIONS):
                continue
            arr = _read_image(os.path.join(cdir, fname))
            if arr.ndim == 2:
                arr = arr[:, :, None]
            images.append(arr.astype(np.uint8))
            labels.append(idx)
    if not images:
        raise FileNotFoundError(f"No images found under {root}")
    images_arr = np.stack(images)
    labels_arr = np.asarray(labels, dtype=np.int64)
    try:
        np.savez_compressed(cache, images=images_arr, labels=labels_arr, class_names=np.asarray(classes))
    except OSError:
        pass  # read-only dataset directory: no cache
    return ArrayDataset(images=images_arr, labels=labels_arr, name=os.path.basename(root), class_names=classes)


def write_image_folder(images: np.ndarray, labels: np.ndarray, path: str, label_suffix: str = "_lines") -> None:
    """Write uint8 NHWC arrays in the reference's PNG class-folder layout
    (``{path}/{label}{label_suffix}/image_{i}.png``, i from 1), as the JAX
    package's ``write_image_folder`` does, with the port's own PNG writer
    (``io/logging.py`` ``write_png``): no Pillow needed."""
    from midi_vae_tpu_torch.io.logging import write_png

    if images.dtype != np.uint8:
        raise ValueError(f"PNG folders hold uint8 images, got {images.dtype}")
    os.makedirs(path, exist_ok=True)
    for i, (img, label) in enumerate(zip(images, labels)):
        class_dir = os.path.join(path, f"{label}{label_suffix}")
        os.makedirs(class_dir, exist_ok=True)
        write_png(os.path.join(class_dir, f"image_{i + 1}.png"), img)


# --------------------------------------------------------------- MIDI folder


def load_midi_folder(
    root: str,
    *,
    pitches: int = 128,
    steps: int = 128,
    seconds_per_step: float = 0.05,
    use_cache: bool = True,
) -> ArrayDataset:
    """A tree of .mid files as rasterized piano-roll windows.

    Each file is parsed (``midi/parse.py``), rasterized to velocity rolls
    and cut into non-overlapping [pitches, steps] windows. Class
    subdirectories that hold .mid files act as labels; a flat tree gets
    label 0. The corpus is cached as ``_midi_cache_{P}x{T}@{s}.rrd`` next
    to the tree (the name carries every rasterization parameter).
    """
    from midi_vae_tpu_torch.midi.parse import parse_midi
    from midi_vae_tpu_torch.midi.rasterize import notes_to_windows

    spc_tag = f"{seconds_per_step:g}".replace(".", "p")
    cache = os.path.join(root, f"_midi_cache_{pitches}x{steps}@{spc_tag}.rrd")
    class_dirs = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    classified = bool(class_dirs) and any(
        f.lower().endswith(MIDI_EXTENSIONS) for d in class_dirs for f in os.listdir(os.path.join(root, d))
    )
    if use_cache and os.path.isfile(cache):
        images, labels = read_rrd(cache)
        return ArrayDataset(
            images=images, labels=labels, name=os.path.basename(root),
            class_names=class_dirs if classified else ["midi"],
        )
    sources: List[Tuple[str, int]] = []  # (file path, label)
    if classified:
        class_names = class_dirs
        for idx, cls in enumerate(class_dirs):
            cdir = os.path.join(root, cls)
            sources += [(os.path.join(cdir, f), idx) for f in sorted(os.listdir(cdir)) if f.lower().endswith(MIDI_EXTENSIONS)]
    else:
        class_names = ["midi"]
        sources = [(os.path.join(root, f), 0) for f in sorted(os.listdir(root)) if f.lower().endswith(MIDI_EXTENSIONS)]
    if not sources:
        raise FileNotFoundError(f"No .mid files found under {root}")

    all_windows, all_labels, skipped = [], [], []
    for fpath, label in sources:
        try:  # one corrupt file must not stop a corpus build
            windows = notes_to_windows(
                parse_midi(fpath), pitches=pitches, steps=steps, seconds_per_step=seconds_per_step
            )
        except ValueError as e:
            skipped.append(fpath)
            print(f"skipping unparseable MIDI file {fpath}: {e}")
            continue
        all_windows.append(windows)
        all_labels.append(np.full(len(windows), label, np.int64))
    if not all_windows:
        raise ValueError(f"none of the {len(sources)} .mid files under {root} could be parsed")
    if skipped:
        print(f"MIDI corpus {root}: skipped {len(skipped)}/{len(sources)} unparseable files")
    images_arr = np.concatenate(all_windows)
    labels_arr = np.concatenate(all_labels)
    if use_cache:
        try:
            write_rrd(images_arr, labels_arr, cache)
        except OSError:
            pass  # read-only dataset directory: no cache
    return ArrayDataset(images=images_arr, labels=labels_arr, name=os.path.basename(root), class_names=class_names)


# -------------------------------------------------------------- MNIST, SVHN


def _read_idx(path: str) -> np.ndarray:
    """An IDX-format file (optionally gzipped), the raw MNIST format."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def load_mnist(root: str, train: bool) -> ArrayDataset:
    """MNIST from its IDX files (``{train,t10k}-{images-idx3,labels-idx1}-ubyte[.gz]``)
    under ``root``, ``root/MNIST/raw`` or ``root/mnist``."""
    prefix = "train" if train else "t10k"
    candidates = [root, os.path.join(root, "MNIST", "raw"), os.path.join(root, "mnist")]
    for base in candidates:
        for ext in ("", ".gz"):
            img_path = os.path.join(base, f"{prefix}-images-idx3-ubyte{ext}")
            lbl_path = os.path.join(base, f"{prefix}-labels-idx1-ubyte{ext}")
            if os.path.isfile(img_path) and os.path.isfile(lbl_path):
                images = _read_idx(img_path)[:, :, :, None]
                labels = _read_idx(lbl_path).astype(np.int64)
                return ArrayDataset(images=images, labels=labels, name="mnist")
    raise FileNotFoundError(f"MNIST IDX files not found under {root} (searched {candidates})")


def load_svhn(root: str, split: str) -> ArrayDataset:
    """SVHN cropped digits from ``{split}_32x32.mat`` (read with scipy)."""
    import scipy.io

    path = os.path.join(root, f"{split}_32x32.mat")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"SVHN file not found: {path}")
    mat = scipy.io.loadmat(path)
    images = np.transpose(mat["X"], (3, 0, 1, 2)).astype(np.uint8)  # HWCN → NHWC
    labels = mat["y"].astype(np.int64).squeeze()
    labels[labels == 10] = 0  # SVHN's label 10 is digit 0
    return ArrayDataset(images=images, labels=labels, name="svhn")


_MNIST_URLS = [
    "https://ossci-datasets.s3.amazonaws.com/mnist/",
    "http://yann.lecun.com/exdb/mnist/",
]
_MNIST_FILES = [
    "train-images-idx3-ubyte.gz",
    "train-labels-idx1-ubyte.gz",
    "t10k-images-idx3-ubyte.gz",
    "t10k-labels-idx1-ubyte.gz",
]
_SVHN_URL = "http://ufldl.stanford.edu/housenumbers/"
_SVHN_FILES = ["train_32x32.mat", "test_32x32.mat"]


def _fetch(url: str, dest: str) -> None:
    """``url`` into ``dest`` through ``dest.tmp`` renamed into place, so an
    interrupted transfer never leaves a file a later run takes as whole."""
    import urllib.request

    tmp = dest + ".tmp"
    try:
        urllib.request.urlretrieve(url, tmp)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    os.rename(tmp, dest)


def download_mnist(root: str) -> None:
    """Fetch the MNIST IDX files missing from ``root/MNIST/raw``, each from
    the first of ``_MNIST_URLS`` that serves it; ``RuntimeError`` naming
    the file when none does."""
    raw = os.path.join(root, "MNIST", "raw")
    os.makedirs(raw, exist_ok=True)
    for fname in _MNIST_FILES:
        dest = os.path.join(raw, fname)
        if os.path.isfile(dest):
            continue
        last_err = None
        for base in _MNIST_URLS:
            try:
                _fetch(base + fname, dest)
                break
            except OSError as e:
                last_err = e
        else:
            raise RuntimeError(f"Could not download {fname}: {last_err}")


def download_svhn(root: str) -> None:
    """Fetch the SVHN cropped-digit ``.mat`` files missing from ``root``
    from ``_SVHN_URL``; ``RuntimeError`` naming the file when it fails."""
    os.makedirs(root, exist_ok=True)
    for fname in _SVHN_FILES:
        dest = os.path.join(root, fname)
        if os.path.isfile(dest):
            continue
        try:
            _fetch(_SVHN_URL + fname, dest)
        except OSError as e:
            raise RuntimeError(f"Could not download {fname} from {_SVHN_URL}: {e}") from e

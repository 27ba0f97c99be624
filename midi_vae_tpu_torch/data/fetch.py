"""Dataset fetching and partitions (counterpart of ``midi_vae_tpu/data/fetch.py``).

``fetch_dataset`` returns ``(train, val, test, distinct_val_test)``:

- folder datasets (``sageev*``, ``vae-lines*``, ``midi*``), the
  ``*-synthetic`` ones and ``rrd:PATH`` streams split 80/20 train/test
  with a seeded permutation (a stream's splits are lazy row subsets);
- MNIST and SVHN use their own train/test files, read from local disk
  only (the port downloads nothing);
- val is test unless prototyping, where val is a K-fold slice of train
  under the eval transform.

The synthetic MIDI corpora are written to a temporary directory named
for this package (``midi_vae_tpu_torch_synth_…``), so the two packages
never race on one staging tree; their files, and so their windows, are
the JAX package's for a seed.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Optional, Tuple

import numpy as np

from midi_vae_tpu_torch.core.device import DeviceLike
from midi_vae_tpu_torch.data.registry import TRAIN_TEST_RATIO
from midi_vae_tpu_torch.data.sources import (
    ArrayDataset,
    load_image_folder,
    load_midi_folder,
    load_mnist,
    load_svhn,
    open_rrd_stream,
)
from midi_vae_tpu_torch.data.splits import create_train_val_split, random_train_test_split
from midi_vae_tpu_torch.data.synthetic import generate_line_images
from midi_vae_tpu_torch.data.transforms import TransformSpec

# size of the generated synthetic datasets (train + test pool)
SYNTHETIC_SIZES = {
    "vae-lines-synthetic": 1024,
    "vae-lines-large-synthetic": 4096,
    "pianoroll-synthetic": 4096,
    "midi-synthetic": 512,  # .mid files, each yielding 1-2 windows
    "midi-synthetic-dense": 512,  # ~8.5 % roll fill instead of ~1.3 %
    "midi-structured": 512,  # tonal/metric/phrased pieces
}


def synthetic_midi_dir(dataset: str, seed: int = 0) -> str:
    """Where a synthetic MIDI corpus of ``dataset`` is (or will be) written."""
    n = SYNTHETIC_SIZES[dataset]
    if dataset.endswith("-structured"):
        tag = f"{n}files_{seed}_structured"
    elif dataset.endswith("-dense"):
        tag = f"{n}files_{seed}_n384"
    else:
        tag = f"{n}files_{seed}"
    return os.path.join(tempfile.gettempdir(), f"midi_vae_tpu_torch_synth_{tag}")


def _synthetic_dataset(dataset: str, seed: int = 0, device: DeviceLike = "cuda") -> ArrayDataset:
    n = SYNTHETIC_SIZES[dataset]
    if dataset == "vae-lines-synthetic":
        images, labels = generate_line_images(n, img_size=(28, 28), max_lines=2, line_width=2, seed=seed)
    elif dataset == "vae-lines-large-synthetic":
        images, labels = generate_line_images(
            n, img_size=(128, 128), max_lines=20, line_width=0, full_length=False, seed=seed
        )
    elif dataset in ("midi-synthetic", "midi-synthetic-dense", "midi-structured"):
        # factory → SMF files → parser → windows, the real folder path;
        # generated in a private directory, then renamed into place, so a
        # crashed or concurrent generator never leaves a half corpus
        from midi_vae_tpu_torch.midi.factory import generate_midi_dataset

        corpus = synthetic_midi_dir(dataset, seed)
        if not os.path.isdir(corpus):
            staging = tempfile.mkdtemp(prefix=f"midi_vae_tpu_torch_synth_{seed}_", dir=tempfile.gettempdir())
            generate_midi_dataset(
                n, staging, seed=seed,
                max_notes=384 if dataset.endswith("-dense") else 48,
                style="structured" if dataset.endswith("-structured") else "random",
            )
            try:
                os.rename(staging, corpus)
            except OSError:  # another process finished first
                shutil.rmtree(staging, ignore_errors=True)
        ds = load_midi_folder(corpus)
        images, labels = ds.images, ds.labels
    elif dataset == "pianoroll-synthetic":
        import torch

        from midi_vae_tpu_torch.data.synthetic import make_pianoroll_batch

        gen = torch.Generator(device=device).manual_seed(seed)
        rolls, counts = make_pianoroll_batch(gen, n, device=device)
        images = (rolls.cpu().numpy() * 255).astype(np.uint8)
        labels = counts.cpu().numpy().astype(np.int64)
    else:
        raise ValueError(dataset)
    if images.ndim == 3:
        images = images[:, :, :, None]
    return ArrayDataset(images=images, labels=labels, name=dataset)


def fetch_image_dataset(
    dataset: str,
    root: Optional[str] = None,
    transform_train: Optional[TransformSpec] = None,
    transform_eval: Optional[TransformSpec] = None,
    download: bool = False,
    split_seed: int = 0,
    device: DeviceLike = "cuda",
) -> Tuple[ArrayDataset, Optional[ArrayDataset], ArrayDataset]:
    """(train, val-or-None, test) for a dataset name. ``device`` is where the
    on-device generator of ``pianoroll-synthetic`` runs. MNIST and SVHN are
    read from local files; ``download`` raises when they are missing (the
    port downloads nothing)."""
    root = root or os.environ.get("MIDI_VAE_DATA_DIR", os.path.expanduser("~/Datasets"))
    if dataset in SYNTHETIC_SIZES or dataset.startswith(("sageev", "vae-lines", "midi")):
        if dataset in SYNTHETIC_SIZES:
            full = _synthetic_dataset(dataset, device=device)
        elif dataset.startswith("midi"):
            full = load_midi_folder(os.path.join(root, dataset))
        else:
            full = load_image_folder(os.path.join(root, dataset))
        train_idx, test_idx = random_train_test_split(len(full), TRAIN_TEST_RATIO, seed=split_seed)
        return full.subset(train_idx).with_transform(transform_train), None, full.subset(test_idx).with_transform(
            transform_eval
        )
    if dataset.startswith("rrd:"):
        # an out-of-core RRD stream: the splits stay lazy row subsets
        full = open_rrd_stream(dataset[4:])
        train_idx, test_idx = random_train_test_split(len(full), TRAIN_TEST_RATIO, seed=split_seed)
        return full.subset(train_idx).with_transform(transform_train), None, full.subset(test_idx).with_transform(
            transform_eval
        )
    if dataset in ("mnist", "svhn"):
        try:
            if dataset == "mnist":
                train, test = load_mnist(root, train=True), load_mnist(root, train=False)
            else:
                train, test = load_svhn(os.path.join(root, dataset), "train"), load_svhn(os.path.join(root, dataset), "test")
        except FileNotFoundError as e:
            if download:
                raise NotImplementedError(
                    f"{e}; --allow-download-dataset: the PyTorch package downloads nothing "
                    "(ROADMAP Queue 1 item 9), place the files under --data-dir"
                ) from e
            raise
        return train.with_transform(transform_train), None, test.with_transform(transform_eval)
    raise ValueError("Unrecognised dataset: {}".format(dataset))


def fetch_dataset(
    dataset: str,
    root: Optional[str] = None,
    prototyping: bool = False,
    transform_train: Optional[TransformSpec] = None,
    transform_eval: Optional[TransformSpec] = None,
    protoval_split_rate: float = 0.1,
    protoval_split_id: int = 0,
    download: bool = False,
    split_seed: int = 0,
    device: DeviceLike = "cuda",
) -> Tuple[ArrayDataset, ArrayDataset, ArrayDataset, bool]:
    """(train, val, test, distinct_val_test)."""
    dataset_train, dataset_val, dataset_test = fetch_image_dataset(
        dataset,
        root=root,
        transform_train=transform_train,
        transform_eval=transform_eval,
        download=download,
        split_seed=split_seed,
        device=device,
    )
    if dataset_val is not None:
        return dataset_train, dataset_val, dataset_test, True
    if not prototyping:
        return dataset_train, dataset_test, dataset_test, False
    if isinstance(protoval_split_rate, str):
        if protoval_split_rate != "auto":
            raise ValueError(f"Unsupported protoval_split_rate: {protoval_split_rate}")
        protoval_split_rate = len(dataset_test) / len(dataset_train)  # val sized like test
    train_idx, val_idx = create_train_val_split(
        len(dataset_train), labels=dataset_train.labels, split_rate=protoval_split_rate, split_id=protoval_split_id
    )
    # val is the same samples under the eval transform
    dataset_val = dataset_train.subset(val_idx).with_transform(transform_eval)
    return dataset_train.subset(train_idx), dataset_val, dataset_test, True

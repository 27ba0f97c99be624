"""Dataset registry (counterpart of ``midi_vae_tpu/data/registry.py``):
dataset name → (num_classes, img_size, num_channels)."""

from __future__ import annotations

TRAIN_TEST_RATIO = 0.8


def image_dataset_sizes(dataset: str):
    """(num_classes, img_size, num_channels) for a dataset name;
    ``num_classes == -1`` means unlabeled or labeled by folder."""
    if dataset.startswith("sageev"):
        return -1, 128, 1
    if dataset in ("vae-lines", "vae-lines-synthetic"):
        return -1, 28, 1
    if dataset in ("vae-lines-large", "vae-lines-large-synthetic"):
        return -1, 128, 1
    if dataset == "pianoroll-synthetic":
        return -1, 128, 1
    if dataset.startswith("midi"):
        # a folder of .mid files under the data root; midi-synthetic and its
        # variants generate theirs in a temporary directory
        return -1, 128, 1
    if dataset.startswith("rrd:"):
        # an out-of-core RRD stream: the name carries the path, the header the shape
        from midi_vae_tpu_torch.data.sources import rrd_shape

        _, h, w, c = rrd_shape(dataset[4:])
        return -1, min(h, w), c
    if dataset == "mnist":
        return 10, 28, 1
    if dataset == "svhn":
        return 10, 32, 3
    raise ValueError("Unrecognised dataset: {}".format(dataset))

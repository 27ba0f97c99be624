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
        raise NotImplementedError(
            "rrd: stream datasets are not ported to the PyTorch package yet (ROADMAP Queue 1 item 9)"
        )
    if dataset == "mnist":
        return 10, 28, 1
    if dataset == "svhn":
        return 10, 32, 3
    raise ValueError("Unrecognised dataset: {}".format(dataset))

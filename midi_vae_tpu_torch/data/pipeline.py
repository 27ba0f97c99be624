"""Input pipeline: host or device-resident corpora → device batches
(counterpart of ``midi_vae_tpu/data/pipeline.py``).

Two loaders with one interface (``epoch(n)`` yields :class:`Batch`es,
``len``, ``num_samples``, ``batch_size``, ``dataset``):

- :class:`DeviceLoader`, the host loader. Each batch's uint8 rows are
  gathered straight into a pinned host buffer and copied to the device
  with ``non_blocking=True`` on a side CUDA stream, ``prefetch`` batches
  ahead of the one being consumed. The consumer's stream waits on an event
  recorded after each copy before it touches the batch, and the device
  tensors are marked used by the consumer's stream (``record_stream``) so
  their memory is not handed out again while that stream may still read
  it. The pinned buffer stays referenced until the consumer has waited
  (PyTorch's pinned-memory cache also holds a block until the copies that
  read it are done). The transform then runs on the consumer's stream.
- :class:`DeviceResidentLoader`: the uint8 corpus is uploaded once; each
  epoch uploads its [num_batches, B] order and mask planes (the
  ``host_rng`` permutation); gather, pad zeroing and transform run on the
  device.

Both walk the JAX package's epoch order: ``host_rng(seed, epoch)``'s
permutation for train (the last partial batch dropped), the dataset order
for eval with the final batch zero-padded and ``mask`` 0 on its pad rows.
A train batch's random transforms are keyed by
``derive_step_seed(host_epoch_seed(seed, epoch), batch_idx)``.

On a rank of a data-parallel run (``rows``: the positions of its rows in
each global batch, ``Mesh.local_rows``) every rank walks the same order
and builds only its rows of each global batch; the eval batch is padded
as a global batch and masked by global position, and the random
transforms draw over the global batch and keep the rows' draws, so N
ranks see the batches of one rank at N times the batch size.
``batch_size`` stays the global batch.

``make_loader``'s ``placement``: ``host``; ``device``; ``auto`` =
device-resident while the resident corpora fit
``MIDI_VAE_DEVICE_DATA_BUDGET_MB`` (default 2048), else host. On a CPU
device there is no stream and no pinned memory; the batches are the same.
"""

from __future__ import annotations

import collections
import os
import weakref
from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch

from midi_vae_tpu_torch.core.device import DeviceLike, resolve_device
from midi_vae_tpu_torch.core.rng import derive_step_seed, host_epoch_seed, host_rng
from midi_vae_tpu_torch.data.sources import ArrayDataset
from midi_vae_tpu_torch.data.transforms import apply_transform


class Batch(NamedTuple):
    """One batch on the device. ``mask`` flags real (non-pad) samples."""

    x: torch.Tensor  # transformed images, float32 [B, S, S, C]
    y: torch.Tensor  # labels int64 [B]
    mask: torch.Tensor  # float32 [B]: 1.0 real sample, 0.0 padding


def transform_seed(seed: int, epoch: int, batch_idx: int) -> int:
    """The seed of a train batch's random transforms."""
    return derive_step_seed(host_epoch_seed(seed, epoch), batch_idx)


def _finish(spec, x: torch.Tensor, seed: Optional[int], rows=None) -> torch.Tensor:
    if spec is not None:
        return apply_transform(spec, x, seed, rows=rows)
    return x.float() / 255.0 if x.dtype == torch.uint8 else x.float()


def _rank_rows(batch_size: int, rows: Optional[np.ndarray]):
    """(rows as int64, local batch size, transform rows) of a rank's share
    of each global batch; ``rows`` None is the whole batch."""
    if rows is None:
        return None, batch_size, None
    rows = np.asarray(rows, np.int64)
    return rows, len(rows), (torch.from_numpy(rows), batch_size)


def _num_batches(n: int, batch_size: int, train: bool) -> int:
    if n == 0:
        raise ValueError("empty dataset")
    nb = n // batch_size if train else -(-n // batch_size)
    if nb == 0:
        raise ValueError(f"dataset of {n} samples yields no batches at batch_size={batch_size} (drop_last)")
    return nb


class DeviceLoader:
    """Host-fed loader (see the module docstring): ``dataset`` is an
    :class:`ArrayDataset` with its transform attached; ``batch_size`` the
    global batch; ``train`` shuffles and drops the last partial batch, eval
    keeps order and pads it. ``rows``: this rank's positions in each
    global batch (None: all of them)."""

    def __init__(
        self,
        dataset: ArrayDataset,
        batch_size: int,
        *,
        train: bool,
        seed: int = 0,
        device: DeviceLike = "cuda",
        prefetch: int = 2,
        rows: Optional[np.ndarray] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.train = train
        self.seed = seed
        self.device = resolve_device(device)
        self.prefetch = max(1, prefetch)
        self.num_batches = _num_batches(len(dataset), batch_size, train)
        self.rows, self.local_batch_size, self._transform_rows = _rank_rows(batch_size, rows)

    def __len__(self) -> int:
        return self.num_batches

    @property
    def num_samples(self) -> int:
        """Samples yielded per epoch (after drop_last, before padding)."""
        return self.num_batches * self.batch_size if self.train else len(self.dataset)

    def _order(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        if self.train:
            return host_rng(self.seed, epoch).permutation(n)[: self.num_batches * self.batch_size]
        return np.arange(n)

    def _host_batch(self, indices: np.ndarray, pin: bool):
        """(images, labels, mask) of this rank's rows of one global batch
        (``indices``, padded as a global batch) as CPU tensors, the images
        gathered into a (pinned) buffer of the local batch size, pad rows zero."""
        images = self.dataset.images
        if self.rows is not None:
            indices = indices[self.rows[self.rows < len(indices)]]  # pad rows come last, as globally
        B, k = self.local_batch_size, len(indices)
        buf = torch.empty((B, *images.shape[1:]), dtype=torch.uint8, pin_memory=pin)
        np.take(images, indices, axis=0, out=buf.numpy()[:k])
        if k < B:
            buf[k:] = 0
        labels = torch.zeros(B, dtype=torch.int64, pin_memory=pin)
        labels[:k] = torch.from_numpy(self.dataset.labels[indices].astype(np.int64))
        mask = torch.zeros(B, dtype=torch.float32, pin_memory=pin)
        mask[:k] = 1.0
        return buf, labels, mask

    def epoch(self, epoch: int = 1) -> Iterator[Batch]:
        """Yield the batches of one epoch (epochs indexed from 1)."""
        order = self._order(epoch)
        spec = self.dataset.transform
        cuda = self.device.type == "cuda"
        copy_stream = torch.cuda.Stream(self.device) if cuda else None

        def launch(i: int):
            host = self._host_batch(order[i * self.batch_size : (i + 1) * self.batch_size], pin=cuda)
            if not cuda:
                return host, None, host
            with torch.cuda.stream(copy_stream):
                dev = tuple(t.to(self.device, non_blocking=True) for t in host)
                done = torch.cuda.Event()
                done.record(copy_stream)
            return dev, done, host

        def consume(i: int, item) -> Batch:
            (x, y, m), done, _host = item  # _host: the pinned buffers, referenced until here
            if done is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(done)
                for t in (x, y, m):
                    t.record_stream(stream)
            seed = transform_seed(self.seed, epoch, i) if self.train else None
            return Batch(x=_finish(spec, x, seed, self._transform_rows), y=y, mask=m)

        queue: collections.deque = collections.deque()
        consumed = 0
        for i in range(self.num_batches):
            queue.append(launch(i))
            if len(queue) > self.prefetch:
                yield consume(consumed, queue.popleft())
                consumed += 1
        while queue:
            yield consume(consumed, queue.popleft())
            consumed += 1


class DeviceResidentLoader:
    """Device-resident corpus (see the module docstring); batch for batch
    the same as :class:`DeviceLoader`."""

    def __init__(
        self,
        dataset: ArrayDataset,
        batch_size: int,
        *,
        train: bool,
        seed: int = 0,
        device: DeviceLike = "cuda",
        rows: Optional[np.ndarray] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.train = train
        self.seed = seed
        self.device = resolve_device(device)
        self.num_batches = _num_batches(len(dataset), batch_size, train)
        self.rows, self.local_batch_size, self._transform_rows = _rank_rows(batch_size, rows)
        # the one corpus upload, as uint8
        self._images = torch.from_numpy(np.ascontiguousarray(dataset.images)).to(self.device)
        self._labels = torch.from_numpy(np.asarray(dataset.labels, np.int64)).to(self.device)
        self.corpus_nbytes = self._images.numel() + self._labels.numel() * 8
        _resident_loaders.add(self)

    def release(self) -> None:
        """Drop the device copy of the corpus and leave the data budget; the
        loader is unusable afterwards."""
        self._images = self._labels = None
        self.corpus_nbytes = 0
        _resident_loaders.discard(self)

    def __len__(self) -> int:
        return self.num_batches

    @property
    def num_samples(self) -> int:
        return self.num_batches * self.batch_size if self.train else len(self.dataset)

    def _epoch_planes(self, epoch: int):
        """The epoch's [num_batches, B] order and mask planes (B the local
        batch: this rank's columns of the global planes), on the device."""
        n, B, nb = len(self.dataset), self.batch_size, self.num_batches
        if self.train:
            order = host_rng(self.seed, epoch).permutation(n)[: nb * B]
            masks = np.ones(nb * B, np.float32)
        else:
            order = np.concatenate([np.arange(n), np.zeros(nb * B - n, np.int64)])
            masks = (np.arange(nb * B) < n).astype(np.float32)
        order, masks = order.reshape(nb, B), masks.reshape(nb, B)
        if self.rows is not None:
            order, masks = order[:, self.rows], masks[:, self.rows]
        order_dev = torch.from_numpy(np.ascontiguousarray(order, np.int64)).to(self.device)
        masks_dev = torch.from_numpy(np.ascontiguousarray(masks)).to(self.device)
        return order_dev, masks_dev

    def epoch(self, epoch: int = 1) -> Iterator[Batch]:
        if self._images is None:
            raise RuntimeError("the loader's corpus was released")
        order_dev, masks_dev = self._epoch_planes(epoch)
        spec = self.dataset.transform
        for i in range(self.num_batches):
            idx, mask = order_dev[i], masks_dev[i]
            real = mask > 0
            # pad rows (index 0) zeroed before the transform, as the host loader's
            rows = torch.where(real.reshape(-1, *([1] * (self._images.ndim - 1))), self._images[idx], 0)
            y = torch.where(real, self._labels[idx], 0)
            seed = transform_seed(self.seed, epoch, i) if self.train else None
            yield Batch(x=_finish(spec, rows, seed, self._transform_rows), y=y, mask=mask)


def _device_data_budget() -> int:
    return int(os.environ.get("MIDI_VAE_DEVICE_DATA_BUDGET_MB", "2048")) * (1 << 20)


# live device-resident loaders: their corpora count against the budget
_resident_loaders: "weakref.WeakSet" = weakref.WeakSet()


def _resident_nbytes() -> int:
    return sum(ldr.corpus_nbytes for ldr in _resident_loaders)


def make_loader(
    dataset: ArrayDataset,
    batch_size: int,
    *,
    train: bool,
    seed: int = 0,
    device: DeviceLike = "cuda",
    prefetch: int = 2,
    placement: str = "host",
    rows: Optional[np.ndarray] = None,
):
    """The loader for ``placement`` (``host`` | ``device`` | ``auto``);
    ``rows`` are this rank's positions in each global batch."""
    if placement not in ("host", "device", "auto"):
        raise ValueError(f"unknown placement: {placement!r} (host|device|auto)")
    kw = dict(train=train, seed=seed, device=device, rows=rows)
    if placement == "device":
        return DeviceResidentLoader(dataset, batch_size, **kw)
    if placement == "auto":
        nbytes, resident = int(dataset.images.nbytes), _resident_nbytes()
        if nbytes + resident <= _device_data_budget():
            return DeviceResidentLoader(dataset, batch_size, **kw)
        print(
            f"data placement auto: corpus {nbytes / 2**20:.0f} MiB exceeds the "
            f"{_device_data_budget() / 2**20:.0f} MiB device budget "
            f"({resident / 2**20:.0f} MiB already resident); host-fed path"
        )
    return DeviceLoader(dataset, batch_size, prefetch=prefetch, **kw)

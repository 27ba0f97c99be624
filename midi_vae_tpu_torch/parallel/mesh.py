"""Process groups and the rank mesh (counterpart of ``midi_vae_tpu/parallel/mesh.py``).

One process per GPU. A :class:`Mesh` lays the ranks of the default
process group out row-major over named axes: ``("data",)``, the
multi-slice ``("slice", "data")`` or the tensor-parallel ``("data",
"model")``, and holds one ``torch.distributed`` group per axis (each
rank keeps the group of the ranks that differ from it only along that
axis). Batches shard over the data axes (both axes of a multi-slice
mesh, flattened slice-major as ``P(("slice", "data"))`` shards them);
ranks that differ only along ``model`` hold the same rows.

The backend follows the device: NCCL for CUDA ranks, gloo for CPU ranks.
:func:`init_from_spawn` joins the group of the in-process launcher
(``parallel/launch.py``) through a ``file://`` store;
:func:`init_from_torchrun` joins one started by ``torchrun`` from its
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``), the counterpart of ``jax.distributed.initialize()``.
"""

from __future__ import annotations

import datetime
import itertools
import math
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from midi_vae_tpu_torch.core.device import DeviceLike, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
SLICE_AXIS = "slice"

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def backend_for(device: DeviceLike) -> str:
    """The collective backend of a rank on ``device``: NCCL on CUDA, gloo on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return "nccl"
    if dev.type == "cpu":
        return "gloo"
    raise ValueError(f"no collective backend for device type {dev.type!r}")


def world_size() -> int:
    """Ranks in the default process group; 1 when there is none."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the default process group; 0 when there is none."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_leader() -> bool:
    return rank() == 0


def init_from_spawn(rank_: int, world: int, store_path: str, device: DeviceLike,
                    timeout_s: Optional[float] = None) -> torch.device:
    """Join a ``world``-rank group through the ``file://`` store at
    ``store_path`` as rank ``rank_`` on ``device`` (made current when
    CUDA); returns the device. ``timeout_s`` bounds each collective's wait
    (the backend's default when None)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if dev.type == "cuda" else {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend_for(dev), init_method=f"file://{store_path}", rank=rank_,
                            world_size=world, **kw)
    return dev


def init_from_torchrun(device_type: str = "cuda") -> torch.device:
    """Join the group ``torchrun`` started, from its environment; the rank's
    device is ``cuda:LOCAL_RANK`` (or the CPU for ``device_type="cpu"``).
    Raises when the environment is missing."""
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"--multihost needs the environment torchrun sets ({', '.join(TORCHRUN_ENV)}); missing "
            f"{', '.join(missing)}. Launch with: torchrun --nnodes H --nproc-per-node G "
            "--rdzv-endpoint HOST:PORT -m midi_vae_tpu_torch.cli.train --multihost ..."
        )
    local = int(os.environ["LOCAL_RANK"])
    dev = resolve_device(f"cuda:{local}" if device_type == "cuda" else "cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(dev), init_method="env://")
    return dev


def ensure_process_group(device: DeviceLike) -> Optional[str]:
    """Start a one-rank group for ``device`` when none exists (a mesh over
    one device still runs its collectives). Returns the directory of the
    group's store when this call started it (the caller destroys the group
    and removes it), else None."""
    if dist.is_initialized():
        return None
    tmp = tempfile.mkdtemp(prefix="midi_vae_tpu_torch_pg_")
    init_from_spawn(0, 1, os.path.join(tmp, "store"), device)
    return tmp


@dataclass
class Mesh:
    """Named axes over the ranks of the default group (row-major), with one
    process group per axis. ``coords`` is this rank's index on each axis."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    rank: int
    groups: Dict[str, Optional[dist.ProcessGroup]] = field(repr=False)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def coords(self) -> Dict[str, int]:
        idx = np.unravel_index(self.rank, self.shape)
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def group(self, axes: Union[str, Sequence[str]]) -> Optional[dist.ProcessGroup]:
        """The group of one axis, or of several: ``None`` (the default group)
        when they cover the whole mesh."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if set(axes) == set(self.axis_names):
            return None
        if len(axes) != 1:
            raise ValueError(f"no process group for axes {axes} of a mesh with axes {self.axis_names}")
        return self.groups[axes[0]]

    @property
    def data_axes(self) -> Tuple[str, ...]:
        """The batch-sharding axes: ``(slice, data)`` on a multi-slice mesh, else ``(data,)``."""
        return tuple(a for a in self.axis_names if a in (SLICE_AXIS, DATA_AXIS))

    @property
    def data_group(self) -> Optional[dist.ProcessGroup]:
        return self.group(self.data_axes)

    @property
    def num_shards(self) -> int:
        """Data shards: the product of the data axes' sizes."""
        return math.prod(self.axis_size(a) for a in self.data_axes)

    @property
    def shard_index(self) -> int:
        """This rank's data shard, slice-major over the data axes."""
        c = self.coords
        idx = 0
        for a in self.data_axes:
            idx = idx * self.axis_size(a) + c[a]
        return idx

    def local_rows(self, global_batch: int, micro: int = 1) -> np.ndarray:
        """Positions of this rank's rows in a global batch of ``global_batch``.

        ``micro`` = 1: the contiguous block ``[s·b, (s+1)·b)`` of shard s,
        b = global_batch / shards. ``micro`` = n: the global batch cut into n
        contiguous micro-batches, and shard s's part of each (``[i·M + s·m,
        i·M + (s+1)·m)``, M = global / n, m = M / shards), so that local
        micro i is this rank's part of global micro i."""
        n = self.num_shards
        if global_batch % n:
            raise ValueError(
                f"global batch size {global_batch} must divide evenly across {n} processes — "
                "remainder samples would silently never be served"
            )
        if global_batch % (n * micro):
            raise ValueError(f"batch size {global_batch} not divisible by grad_accum={micro} on {n} shards")
        big, m = global_batch // micro, global_batch // (micro * n)
        s = self.shard_index
        return np.concatenate([np.arange(i * big + s * m, i * big + (s + 1) * m) for i in range(micro)])


def _make(axis_names: Tuple[str, ...], shape: Tuple[int, ...]) -> Mesh:
    """Build the per-axis groups (a collective call: every rank makes every group, in order)."""
    me = rank()
    groups: Dict[str, Optional[dist.ProcessGroup]] = {}
    ranks = np.arange(math.prod(shape)).reshape(shape)
    for ax, name in enumerate(axis_names):
        if shape[ax] == math.prod(shape):
            groups[name] = None  # the axis spans the world
            continue
        others = [range(s) for i, s in enumerate(shape) if i != ax]
        for fixed in itertools.product(*others):
            index = list(fixed)
            index.insert(ax, slice(None))
            members = [int(r) for r in ranks[tuple(index)]]
            g = dist.new_group(members) if dist.is_initialized() else None
            if me in members:
                groups[name] = g
    return Mesh(axis_names=axis_names, shape=shape, rank=me, groups=groups)


def _check_world(need: int, what: str) -> None:
    have = world_size()
    if need > have:
        raise ValueError(f"{what} needs {need} devices, have {have}")
    if need < have:
        raise ValueError(f"{what} covers {need} of the {have} ranks; launch one rank per device of the mesh")
    if need > 1 and not dist.is_initialized():
        raise RuntimeError("a mesh over several devices needs a process group (parallel/launch.py)")


def make_mesh(num_devices: Optional[int] = None) -> Mesh:
    """1-D data-parallel mesh over ``num_devices`` ranks (None: all of them)."""
    have = world_size()
    if num_devices is not None and num_devices > have:
        raise ValueError(f"requested {num_devices} devices, only {have} available")
    n = have if num_devices is None else num_devices
    _check_world(n, f"mesh of {n}")
    return _make((DATA_AXIS,), (n,))


def make_mesh_multislice(n_slices: int, chips_per_slice: Optional[int] = None) -> Mesh:
    """2-D ``(slice, data)`` mesh for hierarchical data parallelism: the
    ``data`` axis runs within a slice, ``slice`` across slices. Ranks are
    laid out slice-major, so a slice is a run of consecutive ranks (the
    GPUs of one host under torchrun)."""
    have = world_size()
    if chips_per_slice is None:
        if have % n_slices:
            raise ValueError(f"{have} devices do not divide into {n_slices} slices")
        chips_per_slice = have // n_slices
    need = n_slices * chips_per_slice
    if need > have:
        raise ValueError(f"mesh {n_slices}x{chips_per_slice} needs {need} devices, have {have}")
    _check_world(need, f"mesh {n_slices}x{chips_per_slice}")
    return _make((SLICE_AXIS, DATA_AXIS), (n_slices, chips_per_slice))


def make_mesh_2d(n_data: int, n_model: int) -> Mesh:
    """2-D ``(data, model)`` mesh for data + tensor parallelism
    (``parallel/sharding_rules.py``)."""
    need, have = n_data * n_model, world_size()
    if need > have:
        raise ValueError(f"mesh {n_data}x{n_model} needs {need} devices, have {have}")
    _check_world(need, f"mesh {n_data}x{n_model}")
    return _make((DATA_AXIS, MODEL_AXIS), (n_data, n_model))


@torch.no_grad()
def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank, in place."""
    from midi_vae_tpu_torch.parallel.collectives import broadcast_

    broadcast_([t for t in itertools.chain(module.parameters(), module.buffers())])
    return module

"""Collectives over a rank group (counterpart of ``midi_vae_tpu/parallel/collectives.py``).

The JAX package's named-axis collectives become ``torch.distributed``
calls on a process group (``None`` is the default group):

- :func:`all_reduce_sum` and :func:`concat_all_gather` are
  differentiable. A rank's loss depends on every rank's inputs through
  them, so the backward of each is the sum over ranks of the incoming
  gradients (``all_reduce``; for the gather, then this rank's rows), the
  transposes ``psum`` and ``all_gather`` have in JAX. With these, the mean
  over ranks of the per-rank gradients (:func:`psum_mean_`) is the
  gradient of the mean of the per-rank losses.
- :func:`concat_all_gather_ragged` pads, gathers and returns a mask of the
  valid rows, the JAX contract.
- :func:`all_reduce_` and :func:`psum_mean_` sum- (or min-, max-) and
  mean-reduce a list of tensors in place through one flat buffer per
  dtype: one collective, whatever the number of tensors.
- :func:`broadcast_` copies rank 0's tensors to every rank, also through
  flat buffers.
- :func:`cross_rank_statistics` makes a model's BatchNorm and VQ
  quantizer layers reduce their training statistics over a group.

Every collective issued here adds one to its kind in :data:`COUNTS`
(``all_reduce``, ``all_gather``, ``broadcast``): the collectives of a
step are the difference of two reads.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

COUNTS: Dict[str, int] = {"all_reduce": 0, "all_gather": 0, "broadcast": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def counts() -> Dict[str, int]:
    return dict(COUNTS)


def group_size(group: Optional[dist.ProcessGroup]) -> int:
    return dist.get_world_size(group)


def _all_reduce(t: torch.Tensor, group) -> None:
    dist.all_reduce(t, group=group)
    COUNTS["all_reduce"] += 1


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        _all_reduce(y, group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _all_reduce(g, ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """Sum of ``x`` over the group's ranks, on every rank; differentiable."""
    return _AllReduceSum.apply(x, group)


def all_gather_cat(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated on the leading dim (no autograd)."""
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x, group=group)
    COUNTS["all_gather"] += 1
    return torch.cat(parts, dim=0)


class _ConcatAllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return all_gather_cat(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _all_reduce(g, ctx.group)
        r = dist.get_rank(ctx.group)
        return g[r * ctx.rows : (r + 1) * ctx.rows], None


def concat_all_gather(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """Every rank's ``x`` concatenated on the leading dim, in rank order;
    differentiable (JAX ``all_gather(tiled=True)``)."""
    return _ConcatAllGather.apply(x, group)


def concat_all_gather_ragged(
    x: torch.Tensor, valid_count: int, group: Optional[dist.ProcessGroup], max_count: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, masks): ``x`` ([max_count, ...], its first ``valid_count``
    rows real) gathered from every rank, and the f32 mask of the real rows.
    The caller pads ``x`` to ``max_count`` rows first, as in JAX."""
    if x.shape[0] != max_count:
        raise ValueError(f"pad x to max_count before gathering ({x.shape[0]} != {max_count})")
    mask = (torch.arange(max_count, device=x.device) < int(valid_count)).float()
    return concat_all_gather(x, group), all_gather_cat(mask, group)


def _by_dtype(tensors: Sequence[torch.Tensor]) -> Dict[torch.dtype, List[int]]:
    buckets: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        buckets.setdefault(t.dtype, []).append(i)
    return buckets


@torch.no_grad()
def psum_mean_(tensors: Sequence[torch.Tensor], group: Optional[dist.ProcessGroup]) -> None:
    """Replace each tensor by its mean over the group's ranks, in place: one
    all-reduce of a flat buffer per dtype (JAX ``psum_mean``)."""
    all_reduce_(tensors, group)
    n = group_size(group)
    for t in tensors:
        t.div_(n)


@torch.no_grad()
def all_reduce_(tensors: Sequence[torch.Tensor], group: Optional[dist.ProcessGroup], op=dist.ReduceOp.SUM) -> None:
    """Reduce each tensor over the group's ranks with ``op``, in place: one
    all-reduce of a flat buffer per dtype."""
    for idx in _by_dtype(tensors).values():
        ts = [tensors[i] for i in idx]
        flat = _flatten_dense_tensors(ts)
        dist.all_reduce(flat, op=op, group=group)
        COUNTS["all_reduce"] += 1
        for t, v in zip(ts, _unflatten_dense_tensors(flat, ts)):
            t.copy_(v)


@torch.no_grad()
def broadcast_(tensors: Sequence[torch.Tensor], group: Optional[dist.ProcessGroup] = None, src: int = 0) -> None:
    """Overwrite each tensor with rank ``src``'s, in place: one broadcast of a
    flat buffer per dtype."""
    for idx in _by_dtype(tensors).values():
        ts = [tensors[i] for i in idx]
        flat = _flatten_dense_tensors(ts)
        dist.broadcast(flat, src=src, group=group)
        COUNTS["broadcast"] += 1
        for t, v in zip(ts, _unflatten_dense_tensors(flat, ts)):
            t.copy_(v)


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s picklable ``obj`` on every rank (identity without a group)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    COUNTS["broadcast"] += 1
    return box[0]


@dataclass(frozen=True)
class CrossRank:
    """The group a layer's training statistics span (``None``: the default group)."""

    group: Optional[dist.ProcessGroup]


@contextmanager
def cross_rank_statistics(model: torch.nn.Module, group: Optional[dist.ProcessGroup]):
    """Within the block, every layer of ``model`` with a ``cross_rank``
    attribute (BatchNorm, its subsampled variant, the VQ quantizer) reduces
    its training statistics over ``group``; on exit they are local again."""
    layers = [m for m in model.modules() if hasattr(m, "cross_rank")]
    for m in layers:
        m.cross_rank = CrossRank(group)
    try:
        yield
    finally:
        for m in layers:
            m.cross_rank = None


def barrier() -> None:
    """Wait for every rank of the default group (nothing without one)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()

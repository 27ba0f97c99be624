"""Tensor-parallel latent heads (counterpart of ``midi_vae_tpu/parallel/sharding_rules.py``).

Megatron-style pairing over the ``model`` axis of a ``(data, model)``
mesh (``mesh.make_mesh_2d``). Each model rank holds a contiguous slice of
the latent dimension:

- ``fc_mu`` and ``fc_var`` are column-parallel: the rank computes its
  slice of the latent from the (replicated) features, and the slices are
  gathered, so mu, log_var and z are whole on every rank and the loss and
  the noise are the one-device step's. The gather's backward keeps the
  rank's slice; the features' gradient is summed over the model ranks.
- ``decoder_input`` is row-parallel: the rank multiplies its slice of z
  with its rows of the weight, one all-reduce over the model group sums
  the parts, and the bias is added after it.
- Convs and norms stay replicated.

:func:`tp_param_specs` names the split of each parameter (JAX
``PartitionSpec``-like tuples over the torch weight's dims);
:func:`shard_state` cuts a whole model's weights to a rank's slices and
installs the parallel layers. The data-parallel step then runs unchanged
on the data group; its gradient norm counts each sliced parameter once
(``train/state.py``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from midi_vae_tpu_torch.models.vae import Dense
from midi_vae_tpu_torch.parallel.collectives import all_gather_cat, all_reduce_, group_size
from midi_vae_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh


def _spec_for(name: str) -> Tuple:
    if name.startswith(("fc_mu.", "fc_var.")):
        return (MODEL_AXIS, None) if name.endswith("weight") else (MODEL_AXIS,)  # weight [latent, in]
    if name == "decoder_input.weight":  # [out, latent]
        return (None, MODEL_AXIS)
    return ()  # decoder_input's bias adds after the all-reduce: replicated, like convs and norms


def tp_param_specs(model: nn.Module) -> Dict[str, Tuple]:
    """Parameter name → the mesh axis each of its dims is split over (None:
    whole); ``()`` is replicated."""
    return {name: _spec_for(name) for name, _ in model.named_parameters()}


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        all_reduce_([g], ctx.group)
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """The model ranks' last-dim slices concatenated; the gradient's own slice."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        parts = all_gather_cat(x.movedim(-1, 0).contiguous(), group)
        return parts.movedim(0, -1).contiguous()

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return g[..., r * ctx.width : (r + 1) * ctx.width].contiguous(), None


class _ReduceFromModel(torch.autograd.Function):
    """Sum over the model group; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        all_reduce_([y], group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class ColumnParallelDense(Dense):
    """A Dense whose weight and bias hold this rank's output slice; returns
    the whole output, gathered over the model group."""

    def __init__(self, dense: Dense, group, rank: int, size: int):
        nn.Module.__init__(self)
        self.dtype, self.group = dense.dtype, group
        width = dense.weight.shape[0] // size
        sl = slice(rank * width, (rank + 1) * width)
        self.weight = nn.Parameter(dense.weight.detach()[sl].clone())
        self.bias = nn.Parameter(dense.bias.detach()[sl].clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(_CopyToModel.apply(x, self.group))
        return _GatherFromModel.apply(y, self.group)


class RowParallelDense(Dense):
    """A Dense whose weight holds this rank's input columns: its slice of the
    input times them, summed over the model group, plus the whole bias."""

    def __init__(self, dense: Dense, group, rank: int, size: int):
        nn.Module.__init__(self)
        self.dtype, self.group = dense.dtype, group
        width = dense.weight.shape[1] // size
        self.cols = slice(rank * width, (rank + 1) * width)
        self.weight = nn.Parameter(dense.weight.detach()[:, self.cols].clone())
        self.bias = nn.Parameter(dense.bias.detach().clone())

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        part = F.linear(z[..., self.cols].to(self.dtype), self.weight.to(self.dtype))
        return _ReduceFromModel.apply(part, self.group) + self.bias.to(self.dtype)


def shard_state(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Cut ``model``'s latent heads to this rank's slices (in place) and
    install the parallel layers; the parameters split by
    :func:`tp_param_specs` are marked ``tp_sharded``. The optimizer is built
    after this, over the sliced parameters. Raises unless the latent
    dimension divides over the model axis, or for a model without the heads."""
    if MODEL_AXIS not in mesh.axis_names:
        raise ValueError(f"tensor parallelism needs a ('data', 'model') mesh, got axes {mesh.axis_names}")
    if not all(hasattr(model, n) for n in ("fc_mu", "fc_var", "decoder_input")):
        raise ValueError(f"{type(model).__name__} has no Gaussian latent heads to shard")
    size, rank = mesh.axis_size(MODEL_AXIS), mesh.coords[MODEL_AXIS]
    if model.latent_dim % size or getattr(model, "num_classes", 0):
        raise ValueError(
            f"latent_dim {model.latent_dim} must divide over {size} model ranks (unconditional models only)"
        )
    group = mesh.groups[MODEL_AXIS]
    model.fc_mu = ColumnParallelDense(model.fc_mu, group, rank, size)
    model.fc_var = ColumnParallelDense(model.fc_var, group, rank, size)
    model.decoder_input = RowParallelDense(model.decoder_input, group, rank, size)
    for name, p in model.named_parameters():
        p.tp_sharded = MODEL_AXIS in _spec_for(name)
    model.tp_group = group
    return model


def tp_global_norm(model: nn.Module) -> torch.Tensor:
    """The gradient norm of the whole (unsliced) model on a rank of a
    tensor-parallel model: the sliced parameters' squares summed over the
    model group, the replicated ones counted once."""
    sq = {True: [], False: []}
    for p in model.parameters():
        if p.grad is not None:
            sq[getattr(p, "tp_sharded", False)].append(torch.sum(torch.square(p.grad.float())))
    zero = torch.zeros((), device=next(model.parameters()).device)
    sharded = torch.stack(sq[True]).sum() if sq[True] else zero
    if group_size(model.tp_group) > 1:
        all_reduce_([sharded], model.tp_group)
    replicated = torch.stack(sq[False]).sum() if sq[False] else zero
    return torch.sqrt(sharded + replicated)

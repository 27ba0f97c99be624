"""Convolutional VAE (counterpart of ``midi_vae_tpu/models/vae.py``).

The public layout is the JAX package's: images go in as NHWC
``[B, H, W, C]`` and logits come out NHWC. Inside, the conv stacks run
NCHW (``channels_last`` in memory wherever the input came from an NHWC
permute), so cuDNN sees its native layout:

- encoder stacks take NHWC images and return NCHW feature maps;
- decoder stacks take and return NCHW feature maps;
- final layers take NCHW and return NHWC logits.

Submodules carry the flax module names (``ConvBlock_0/Conv_0`` …), so
``interop/from_jax.py`` maps a flax parameter tree onto the torch one
name by name.

Semantics that differ from torch's own layers and are kept here:

- flax ``Conv(k3, s2, "SAME")`` pads (0, 1) on even sizes, not torch's
  symmetric (1, 1): :func:`_same_pads`.
- flax ``ConvTranspose(k3, s2, "SAME")`` is ``conv_transpose2d`` with the
  spatially flipped kernel, cropped to 2h × 2w.
- BatchNorm computes its statistics in f32 (also under bf16), normalises
  with the biased batch variance and updates the running variance with it
  too (torch's ``BatchNorm2d`` uses the unbiased one there); flax momentum
  0.9 is torch momentum 0.1. In the conv blocks on a card a BatchNorm and
  the LeakyReLU after it run as one fused operation of hand-written
  kernels (:func:`norm_leaky_relu`, ``ops/fused_norm.py``), which computes
  the same function.
- The flatten before ``fc_mu``/``fc_var`` and the reshape after
  ``decoder_input`` are in NHWC order, so the dense weights are the flax
  ones transposed.

Compute runs in ``dtype`` (bfloat16 on the flagship) with float32
parameters, as flax's ``dtype`` argument does.

A conditional model (``num_classes`` > 0) joins the one-hot label to the
flattened features before ``fc_mu``/``fc_var`` and to z before
``decoder_input``; those Dense layers are that much wider, as in flax.
Labels go to a model only through :func:`label_kwarg`.

Variants, as the JAX package's (``vae.py:107-480``):

- ``norm``: ``batch`` (above), ``batch-subN`` (:class:`SubsampledBatchNorm`:
  training statistics from ``x[::N]``, variance not clamped, applied as one
  FMA in the compute dtype), ``group`` (:class:`GroupNorm`, flax's: f32
  statistics per sample and group of contiguous channels) or ``none``;
- ``stem="s2d"`` (:class:`S2DStem`: a 2×2 space-to-depth fold, then a
  stride-1 conv) and ``head="d2s"`` (:class:`D2SHead`: the head at half
  resolution, then a depth-to-space unfold);
- ``torch_compat``: the reference's own padding, symmetric (1, 1) on the
  stride-2 convs and torch's ``ConvTranspose2d(k3, s2, p1, op1)``
  (:class:`TorchConvTranspose`), so a reference ``state_dict``
  (``interop/torch_reference.py``) reproduces the reference's activations;
- ``remat``: the encoder, decoder and head run under
  ``torch.utils.checkpoint`` (:func:`remat_call`), their activations
  recomputed in the backward; a recompute updates no running statistics;
- ``verbose``: each stage's shape (NHWC, as JAX prints it), min and max
  printed as the forward passes it (:func:`trace_range`); off, no work.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager, nullcontext
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from midi_vae_tpu_torch.core.types import EncoderOutput, ModelOutput
from midi_vae_tpu_torch.io import tracing
from midi_vae_tpu_torch.ops.fused_elbo import fused_reparam_kl
from midi_vae_tpu_torch.ops.fused_norm import KERNEL_DTYPES, batch_norm_leaky_relu
from midi_vae_tpu_torch.parallel.collectives import all_reduce_sum, group_size

_LEAKY_SLOPE = 0.01


def trace_range(verbose: bool, name: str, x: torch.Tensor, nchw: bool = False) -> None:
    """Print ``name shape=(...) min=... max=...`` of a forward stage when
    ``verbose`` (JAX ``trace_range``, ``vae.py:48-65``); ``nchw`` marks an
    NCHW feature map, whose shape is printed in NHWC order as JAX sees it.
    Reading min and max syncs with the device, as ``jax.debug.print`` does.
    Nothing happens when ``verbose`` is off."""
    if not verbose:
        return
    shape = (x.shape[0], *x.shape[2:], x.shape[1]) if nchw else tuple(x.shape)
    x = x.detach()
    print(f"{name} shape={tuple(shape)} min={float(x.min()):.6g} max={float(x.max()):.6g}", flush=True)


_RECOMPUTE = threading.local()


@contextmanager
def _recomputing():
    prev = getattr(_RECOMPUTE, "active", False)
    _RECOMPUTE.active = True
    try:
        yield
    finally:
        _RECOMPUTE.active = prev


def in_recompute() -> bool:
    """True while :func:`remat_call` reruns a forward for the backward:
    running statistics must not be updated a second time then."""
    return getattr(_RECOMPUTE, "active", False)


def remat_call(module: nn.Module, x: torch.Tensor, train: bool) -> torch.Tensor:
    """``module(x, train)`` under ``torch.utils.checkpoint`` (non-reentrant):
    its activations are dropped and recomputed in the backward, as flax
    ``nn.remat`` does. The recompute runs under :func:`in_recompute`, so
    BatchNorm's running averages move once per forward, as in JAX."""
    return checkpoint(module, x, train, use_reentrant=False,
                      context_fn=lambda: (nullcontext(), _recomputing()))


def label_kwarg(model, y) -> dict:
    """``{"y": y}`` when ``model`` is conditional (``num_classes`` > 0) and
    labels exist, else ``{}``: the one rule for passing labels to a model.
    Callers pass whatever labels they hold; unconditional models never see
    the keyword, and a conditional model called without labels raises."""
    return {"y": y} if y is not None and getattr(model, "num_classes", 0) > 0 else {}


def class_onehot(model: nn.Module, y: Optional[torch.Tensor], where: str) -> torch.Tensor:
    """One-hot [B, num_classes] of int labels ``y`` in the model's dtype;
    an out-of-range label gives a zero row, as ``jax.nn.one_hot`` does.
    Raises when a conditional model is called without labels."""
    if y is None:
        raise ValueError(
            f"{type(model).__name__}(num_classes={model.num_classes}) is conditional: "
            f"{where} requires labels y (int [B])"
        )
    classes = torch.arange(model.num_classes, device=y.device)
    return (y.reshape(-1, 1).long() == classes).to(model.dtype)


def conv_output_size(dim: int, num_layers: int, stride: int = 2) -> int:
    """Spatial size after ``num_layers`` stride-2 SAME convolutions."""
    for _ in range(num_layers):
        dim = -(-dim // stride)
    return dim


def _xavier(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Xavier-uniform init (flax ``xavier_uniform``: fans from in/out features × receptive field)."""
    return nn.init.xavier_uniform_(t, generator=generator)


def _logit_bias_init(value: Optional[float]) -> float:
    """Output-logit bias init: zeros (``None``) or the given constant."""
    return 0.0 if value is None else float(value)


def _same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of XLA's SAME rule for one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _space_to_depth(x: torch.Tensor, f: int) -> torch.Tensor:
    """NHWC [B, H, W, C] → [B, H/f, W/f, f·f·C], channels ordered (fi, fj, c)
    as the JAX package folds (``pixel_unshuffle`` orders (c, fi, fj))."""
    b, h, w, c = x.shape
    if h % f or w % f:
        raise ValueError(f"input {h}x{w} not divisible by fold={f}")
    x = x.reshape(b, h // f, f, w // f, f, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // f, w // f, f * f * c)


def _depth_to_space(x: torch.Tensor, f: int, out_ch: int) -> torch.Tensor:
    """NHWC [B, H, W, f·f·C] → [B, H·f, W·f, C], the inverse of :func:`_space_to_depth`."""
    b, h, w, _ = x.shape
    x = x.reshape(b, h, w, f, f, out_ch)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h * f, w * f, out_ch)


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), strides, "SAME")`` on NCHW (k = 3
    unless given); ``torch_pad`` pads (k//2, k//2) on every side instead, as
    the reference's ``Conv2d(k3, padding=1)`` and JAX's torch_compat
    ``ConvBlock`` do."""

    def __init__(
        self,
        in_features: int,
        features: int,
        *,
        kernel_size: int = 3,
        stride: int = 1,
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator,
        bias_value: float = 0.0,
        torch_pad: bool = False,
    ):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.torch_pad = torch_pad
        self.dtype = dtype
        self.weight = nn.Parameter(_xavier(torch.empty(features, in_features, kernel_size, kernel_size), generator))
        self.bias = nn.Parameter(torch.full((features,), bias_value))

    def kernel(self) -> torch.Tensor:
        """The kernel the conv applies, ``[out, in, k, k]`` in f32."""
        return self.weight

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.torch_pad:
            hlo = hhi = wlo = whi = self.kernel_size // 2
        else:
            hlo, hhi = _same_pads(x.shape[2], self.kernel_size, self.stride)
            wlo, whi = _same_pads(x.shape[3], self.kernel_size, self.stride)
        x = x.to(self.dtype)
        if (hlo, wlo) == (hhi, whi):
            padding = (hlo, wlo)
        else:
            x = F.pad(x, (wlo, whi, hlo, hhi))
            padding = 0
        return F.conv2d(x, self.kernel().to(self.dtype), self.bias.to(self.dtype), self.stride, padding)


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose(features, (3, 3), (2, 2), "SAME")`` on NCHW.

    ``weight`` is in ``conv_transpose2d`` layout ``[in, out, 3, 3]`` and
    holds the flax HWIO kernel flipped in both spatial dims.
    """

    def __init__(
        self, in_features: int, features: int, *, dtype: torch.dtype = torch.float32, generator: torch.Generator
    ):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(_xavier(torch.empty(in_features, features, 3, 3), generator))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[2], x.shape[3]
        y = F.conv_transpose2d(x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype), stride=2)
        return y[:, :, : 2 * h, : 2 * w]


class TorchConvTranspose(nn.Module):
    """torch ``ConvTranspose2d(k3, s2, padding=1, output_padding=1)`` on NCHW
    (JAX ``TorchConvTranspose``, ``vae.py:214-241``): ``weight`` is torch's
    own ``[in, out, 3, 3]``, which the flax model stores as its HWIO kernel
    *unflipped* and flips at apply; the SAME :class:`ConvTranspose` stores it
    flipped, so the weight bridge maps the two differently."""

    def __init__(
        self, in_features: int, features: int, *, dtype: torch.dtype = torch.float32, generator: torch.Generator
    ):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(_xavier(torch.empty(in_features, features, 3, 3), generator))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(
            x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype), stride=2, padding=1,
            output_padding=1,
        )


class Dense(nn.Module):
    """flax ``nn.Dense``; ``weight`` is ``[out, in]`` (the flax kernel transposed)."""

    def __init__(
        self, in_features: int, features: int, *, dtype: torch.dtype = torch.float32, generator: torch.Generator
    ):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(_xavier(torch.empty(features, in_features), generator))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype))


def cross_rank_means(layer: nn.Module, *means: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``means`` (per-channel f32 batch means) as they are, or, while
    ``layer.cross_rank`` names a group, their mean over its ranks: one
    differentiable all-reduce for all of them. The shards of a step are
    equal, so the mean of the local means is the mean over the global
    batch (flax's ``pmean`` of mean and E[x²]); over one rank it is the
    local mean, bit for bit."""
    if layer.cross_rank is None:
        return means
    group = layer.cross_rank.group
    total = all_reduce_sum(torch.cat(means), group) / group_size(group)
    return tuple(torch.split(total, [m.numel() for m in means]))


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW channels.

    Training: statistics of the batch in f32 (``E[x²] − E[x]²``, clipped at
    0, as flax's fast variance), and the running averages updated in place
    with the biased variance. Eval: the running averages. The output is
    computed in f32 and cast to ``dtype``. Under
    ``parallel.collectives.cross_rank_statistics`` the statistics span the
    ranks of its group (:func:`cross_rank_means`), as ``axis_name`` makes
    flax's span the mesh.
    """

    def __init__(self, features: int, *, dtype: torch.dtype = torch.float32, momentum: float = 0.9, epsilon: float = 1e-5):
        super().__init__()
        self.dtype = dtype
        self.momentum = momentum
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(features))  # flax "scale"
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))  # flax batch_stats "mean"
        self.register_buffer("running_var", torch.ones(features))  # flax batch_stats "var"

    cross_rank = None  # set by parallel.collectives.cross_rank_statistics

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x32 = x.float()
        if train:
            mean, ex2 = cross_rank_means(self, x32.mean(dim=(0, 2, 3)), (x32 * x32).mean(dim=(0, 2, 3)))
            var = (ex2 - mean * mean).clamp_min(0.0)
            self.update_running(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        y = (x32 - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(self.dtype)

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """Move the running averages toward a batch's statistics (flax
        momentum), except in a remat recompute (:func:`in_recompute`)."""
        if in_recompute():
            return
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1.0 - m) * var)


class SubsampledBatchNorm(BatchNorm):
    """JAX ``SubsampledBatchNorm`` (``vae.py:115-169``), ``norm="batch-subN"``.

    Training statistics come from every ``stride``-th sample of the batch
    (``x[::stride]``, in f32), with the variance ``E[x²] − mean²`` *not*
    clamped at 0, and move the running averages as BatchNorm's do. The
    norm is applied to the whole batch as one FMA in the compute dtype
    (``addcmul``: one read of x, one write): ``x·a + b`` with ``a =
    scale·rsqrt(var + ε)`` and ``b = bias − mean·a`` folded in f32 and cast
    (BatchNorm normalises in f32 instead). Eval mode uses the running
    averages, as BatchNorm's."""

    def __init__(self, features: int, *, stride: int, dtype: torch.dtype = torch.float32):
        super().__init__(features, dtype=dtype)
        self.stride = stride

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if train:
            xs = x[:: self.stride].float()
            mean, ex2 = cross_rank_means(self, xs.mean(dim=(0, 2, 3)), (xs * xs).mean(dim=(0, 2, 3)))
            var = ex2 - mean * mean
            self.update_running(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        a = self.weight * torch.rsqrt(var + self.epsilon)
        b = self.bias - mean * a
        dt = self.dtype
        return torch.addcmul(b.to(dt)[:, None, None], x.to(dt), a.to(dt)[:, None, None])


def _gn_groups(channels: int, target: int = 32) -> int:
    """Largest group count ≤ ``target`` that divides ``channels``."""
    g = min(target, channels)
    while channels % g:
        g -= 1
    return g


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups=_gn_groups(C), epsilon=1e-5)`` over NCHW:
    per sample, f32 statistics over each group of contiguous channels and
    all pixels (``E[x²] − E[x]²``, clipped at 0), normalised in f32 with the
    per-channel scale and bias, cast to ``dtype``. Contiguous channels form
    the same groups in NCHW as in NHWC. No running statistics."""

    def __init__(self, features: int, *, dtype: torch.dtype = torch.float32, epsilon: float = 1e-5):
        super().__init__()
        self.dtype = dtype
        self.epsilon = epsilon
        self.num_groups = _gn_groups(features)
        self.weight = nn.Parameter(torch.ones(features))  # flax "scale"
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        b, c, h, w = x.shape
        g = self.num_groups
        xg = x.float().reshape(b, g, c // g, h, w)
        mean = xg.mean(dim=(2, 3, 4))
        var = ((xg * xg).mean(dim=(2, 3, 4)) - mean * mean).clamp_min(0.0)
        mean = mean.repeat_interleave(c // g, dim=1)[:, :, None, None]
        mul = (torch.rsqrt(var + self.epsilon).repeat_interleave(c // g, dim=1) * self.weight)[:, :, None, None]
        y = (x.float() - mean) * mul + self.bias[:, None, None]
        return y.to(self.dtype)


def add_norm(block: nn.Module, norm: str, features: int, dtype: torch.dtype) -> Optional[str]:
    """Register ``block``'s normalization sublayer under its flax name (JAX
    ``_apply_norm``, ``vae.py:172-211``) and return that name; ``None`` for
    ``norm="none"``, which adds no layer."""
    if norm == "batch":
        name, layer = "BatchNorm_0", BatchNorm(features, dtype=dtype)
    elif norm.startswith("batch-sub"):
        name, layer = "SubsampledBatchNorm_0", SubsampledBatchNorm(
            features, stride=int(norm[len("batch-sub"):]), dtype=dtype)
    elif norm == "group":
        name, layer = "GroupNorm_0", GroupNorm(features, dtype=dtype)
    elif norm == "none":
        return None
    else:
        raise ValueError(f"unknown norm: {norm!r} (batch|batch-subN|group|none)")
    block.add_module(name, layer)
    return name


def apply_norm(block: nn.Module, x: torch.Tensor, train: bool) -> torch.Tensor:
    """``block``'s normalization sublayer (:func:`add_norm`) applied to ``x``,
    traced as ``model.norm`` while a profiler records (``io/tracing.py``)."""
    if block.norm_name is None:
        return x
    with tracing.span("model.norm"):
        return getattr(block, block.norm_name)(x, train)


def _on_a_card(t: torch.Tensor) -> bool:
    return t.is_cuda


def _one_rank(norm: BatchNorm) -> bool:
    """Whether the layer's statistics stay on this rank: no group, or a group of one rank."""
    return norm.cross_rank is None or group_size(norm.cross_rank.group) == 1


def norm_leaky_relu(block: nn.Module, x: torch.Tensor, train: bool) -> torch.Tensor:
    """LeakyReLU(0.01) of ``block``'s normalization sublayer applied to ``x``.

    A :class:`BatchNorm` itself (not a subclass) whose statistics stay on
    this rank (``cross_rank`` unset, or a group of one rank, whose mean is
    the local one), given a CUDA tensor in a dtype the
    kernels take (f32, bf16, f16: every model dtype), runs as one fused
    operation, ``ops.fused_norm.batch_norm_leaky_relu`` (hand-written
    kernels computing this module's BatchNorm and the activation), traced
    as ``model.norm``. Everything else (a CPU tensor, an f64 model, every
    other norm, a BatchNorm whose statistics span two or more ranks: an
    all-reduce between the passes) runs :func:`apply_norm` and
    ``F.leaky_relu``. The counters
    ``norm.batch_calls`` and ``norm.fused_calls`` count the BatchNorm calls
    and those that took the kernels."""
    norm = None if block.norm_name is None else getattr(block, block.norm_name)
    if type(norm) is BatchNorm:
        tracing.count("norm.batch_calls", 1)
        if _on_a_card(x) and x.dtype in KERNEL_DTYPES and norm.dtype in KERNEL_DTYPES and _one_rank(norm):
            tracing.count("norm.fused_calls", 1)
            with tracing.span("model.norm"):
                return batch_norm_leaky_relu(
                    x, norm.weight, norm.bias, norm.running_mean, norm.running_var, train=train,
                    update=train and not in_recompute(), momentum=norm.momentum, eps=norm.epsilon,
                    dtype=norm.dtype, slope=_LEAKY_SLOPE)
    return F.leaky_relu(apply_norm(block, x, train), _LEAKY_SLOPE)


class ConvBlock(nn.Module):
    """Conv(k3, SAME, stride) + norm + LeakyReLU(0.01); ``torch_compat`` pads
    (1, 1) as the reference does."""

    def __init__(
        self,
        in_features: int,
        features: int,
        *,
        stride: int = 2,
        dtype: torch.dtype = torch.float32,
        norm: str = "batch",
        torch_compat: bool = False,
        generator: torch.Generator,
    ):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, stride=stride, dtype=dtype, generator=generator,
                           torch_pad=torch_compat)
        self.norm_name = add_norm(self, norm, features, dtype)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return norm_leaky_relu(self, self.Conv_0(x), train)


class DeconvBlock(nn.Module):
    """ConvTranspose(k3, s2, SAME) + norm + LeakyReLU(0.01): doubles H and W.
    ``torch_compat`` uses torch's transposed conv (:class:`TorchConvTranspose`)."""

    def __init__(
        self,
        in_features: int,
        features: int,
        *,
        dtype: torch.dtype = torch.float32,
        norm: str = "batch",
        torch_compat: bool = False,
        generator: torch.Generator,
    ):
        super().__init__()
        cls = TorchConvTranspose if torch_compat else ConvTranspose
        self.ConvTranspose_0 = cls(in_features, features, dtype=dtype, generator=generator)
        self.norm_name = add_norm(self, norm, features, dtype)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return norm_leaky_relu(self, self.ConvTranspose_0(x), train)


class S2DStem(nn.Module):
    """JAX ``S2DStem`` (``vae.py:312-350``): fold 2×2 pixel blocks into
    channels (channel ``(dy·2 + dx)·C + c``), then Conv(k3, s1, SAME) + norm
    + LeakyReLU; the same [B, features, H/2, W/2] as the stride-2 ConvBlock
    it replaces. NCHW in and out."""

    def __init__(self, in_features: int, features: int, *, dtype, norm, generator):
        super().__init__()
        self.Conv_0 = Conv(4 * in_features, features, stride=1, dtype=dtype, generator=generator)
        self.norm_name = add_norm(self, norm, features, dtype)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        h, w = x.shape[2], x.shape[3]
        if h % 2 or w % 2:
            raise ValueError(f"s2d stem needs even spatial dims, got {h}x{w}")
        x = _space_to_depth(x.permute(0, 2, 3, 1), 2).permute(0, 3, 1, 2)
        return norm_leaky_relu(self, self.Conv_0(x), train)


class BlockStack(nn.Module):
    """Blocks applied in order, registered under flax's auto-names
    (``ConvBlock_0``, ``ConvBlock_1``, ``DeconvBlock_0`` …: one counter per class)."""

    def __init__(self, blocks: Sequence[nn.Module]):
        super().__init__()
        counts: dict = {}
        for block in blocks:
            cls = type(block).__name__
            self.add_module(f"{cls}_{counts.get(cls, 0)}", block)
            counts[cls] = counts.get(cls, 0) + 1

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        for block in self.children():
            x = block(x, train)
        return x


class Encoder(BlockStack):
    """Stride-2 ConvBlock stack (the first an :class:`S2DStem` when ``stem="s2d"``):
    NHWC images → NCHW features."""

    def __init__(self, in_channels: int, hidden_dims: Sequence[int], *, dtype, norm, generator,
                 stem: str = "conv", torch_compat: bool = False):
        dims = (in_channels, *hidden_dims)
        kw = dict(dtype=dtype, norm=norm, generator=generator)
        super().__init__([
            S2DStem(dims[i], dims[i + 1], **kw) if i == 0 and stem == "s2d"
            else ConvBlock(dims[i], dims[i + 1], torch_compat=torch_compat, **kw)
            for i in range(len(hidden_dims))
        ])

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2), train)


class Decoder(BlockStack):
    """DeconvBlock stack over ``hidden_dims`` (reversed order, e.g. (256, 128, 64, 32))."""

    def __init__(self, hidden_dims: Sequence[int], *, dtype, norm, generator, torch_compat: bool = False):
        super().__init__(
            [
                DeconvBlock(hidden_dims[i], hidden_dims[i + 1], dtype=dtype, norm=norm, torch_compat=torch_compat,
                            generator=generator)
                for i in range(len(hidden_dims) - 1)
            ]
        )


class FinalLayer(nn.Module):
    """DeconvBlock + Conv(k3, s1) → NHWC logits."""

    def __init__(self, in_features: int, features: int, out_channels: int, *, dtype, norm, generator,
                 output_logit_bias=None, torch_compat: bool = False):
        super().__init__()
        self.DeconvBlock_0 = DeconvBlock(in_features, features, dtype=dtype, norm=norm, torch_compat=torch_compat,
                                         generator=generator)
        self.Conv_0 = Conv(
            features, out_channels, stride=1, dtype=dtype, generator=generator,
            bias_value=_logit_bias_init(output_logit_bias),
        )

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return self.Conv_0(self.DeconvBlock_0(x, train)).permute(0, 2, 3, 1)


class D2SHead(nn.Module):
    """JAX ``D2SHead`` (``vae.py:428-480``): Conv(k3, s1) + norm + LeakyReLU +
    Conv(k3, s1) to 4·out_ch channels at half the output resolution, then a
    2×2 depth-to-space unfold → NHWC logits. The last conv's bias lands on
    every output pixel, so it carries the output-logit bias."""

    def __init__(self, in_features: int, features: int, out_channels: int, *, dtype, norm, generator,
                 output_logit_bias=None):
        super().__init__()
        self.out_channels = out_channels
        self.Conv_0 = Conv(in_features, features, stride=1, dtype=dtype, generator=generator)
        self.norm_name = add_norm(self, norm, features, dtype)
        self.Conv_1 = Conv(
            features, 4 * out_channels, stride=1, dtype=dtype, generator=generator,
            bias_value=_logit_bias_init(output_logit_bias),
        )

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = norm_leaky_relu(self, self.Conv_0(x), train)
        return _depth_to_space(self.Conv_1(x).permute(0, 2, 3, 1), 2, self.out_channels)


class VanillaVAE(nn.Module):
    """Convolutional VAE over NHWC piano-roll images.

    ``num_classes`` > 0 makes it conditional; ``stem``, ``head``, ``norm``,
    ``torch_compat``, ``remat`` and ``verbose`` select the variants of the
    module docstring, with the JAX package's refusals (``ValueError``).
    Parameters are created on the CPU from ``generator`` (seed 0 when none
    is given); move the model with ``.to``.
    """

    def __init__(
        self,
        in_channels: int = 1,
        latent_dim: int = 10,
        input_dim: int = 32,
        hidden_dims: Sequence[int] = (32, 64, 128, 256),
        out_channels: Optional[int] = None,
        dtype: torch.dtype = torch.float32,
        fused_reparam: bool = False,
        output_logit_bias: Optional[float] = None,
        stem: str = "conv",
        head: str = "deconv",
        norm: str = "batch",
        torch_compat: bool = False,
        remat: bool = False,
        verbose: bool = False,
        num_classes: int = 0,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if stem not in ("conv", "s2d"):
            raise ValueError(f"unknown stem: {stem!r} (conv|s2d)")
        if head not in ("deconv", "d2s"):
            raise ValueError(f"unknown head: {head!r} (deconv|d2s)")
        if torch_compat and (stem != "conv" or head != "deconv"):
            raise ValueError("torch_compat requires the reference stem and head")
        if torch_compat and norm != "batch":
            raise ValueError("torch_compat requires norm='batch' (reference BatchNorm2d parity)")
        if torch_compat and num_classes > 0:
            raise ValueError(
                "torch_compat is the reference-parity mode; the reference has no conditional "
                "variant (num_classes widens the latent-head/decoder-input layers)"
            )
        self.num_classes = int(num_classes)
        self.in_channels = in_channels
        self.latent_dim = latent_dim
        self.input_dim = input_dim
        self.hidden_dims = tuple(hidden_dims)
        self.out_channels = out_channels or in_channels
        self.dtype = dtype
        self.fused_reparam = fused_reparam
        self.output_logit_bias = output_logit_bias
        self.stem, self.head, self.norm = stem, head, norm
        self.torch_compat, self.remat, self.verbose = bool(torch_compat), bool(remat), bool(verbose)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self._build(gen)

    def _build(self, gen: torch.Generator) -> None:
        kw = dict(dtype=self.dtype, norm=self.norm, generator=gen)
        rev = tuple(reversed(self.hidden_dims))
        self.encoder = Encoder(self.in_channels, self.hidden_dims, stem=self.stem, torch_compat=self.torch_compat, **kw)
        self._build_heads(gen)
        self.decoder = Decoder(rev, torch_compat=self.torch_compat, **kw)
        if self.head == "d2s":
            self.final_layer = D2SHead(rev[-1], rev[-1], self.out_channels, output_logit_bias=self.output_logit_bias, **kw)
        else:
            self.final_layer = FinalLayer(
                rev[-1], rev[-1], self.out_channels, output_logit_bias=self.output_logit_bias,
                torch_compat=self.torch_compat, **kw,
            )

    def _build_heads(self, gen: torch.Generator) -> None:
        kw = dict(dtype=self.dtype, generator=gen)
        self.fc_mu = Dense(self.flattened_size + self.num_classes, self.latent_dim, **kw)
        self.fc_var = Dense(self.flattened_size + self.num_classes, self.latent_dim, **kw)
        self.decoder_input = Dense(self.latent_dim + self.num_classes, self.flattened_size, **kw)

    def _stack(self, name: str, x: torch.Tensor, train: bool) -> torch.Tensor:
        """Run the conv stack ``name`` (encoder, decoder or final_layer),
        under :func:`remat_call` when ``remat`` is on and autograd records."""
        module = getattr(self, name)
        if self.remat and torch.is_grad_enabled():
            return remat_call(module, x, train)
        return module(x, train)

    @property
    def last_conv_size(self) -> int:
        return conv_output_size(self.input_dim, len(self.hidden_dims))

    @property
    def flattened_size(self) -> int:
        return self.last_conv_size * self.last_conv_size * self.hidden_dims[-1]

    @property
    def decoded_size(self) -> int:
        """Spatial size produced by the decoder before cropping."""
        return self.last_conv_size * (2 ** len(self.hidden_dims))

    def encode(self, x: torch.Tensor, train: bool = False, y: Optional[torch.Tensor] = None) -> EncoderOutput:
        """NHWC images → (mu, log_var); the features are flattened in NHWC
        order. A conditional model's heads also see the one-hot of ``y``;
        ``pre_latents`` stays the unconditioned features."""
        trace_range(self.verbose, "encode/input", x)
        h = self._stack("encoder", x, train)
        trace_range(self.verbose, "encode/conv_out", h, nchw=True)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        hc = torch.cat([h, class_onehot(self, y, "encode")], dim=-1) if self.num_classes > 0 else h
        mu, log_var = self.fc_mu(hc), self.fc_var(hc)
        trace_range(self.verbose, "encode/mu", mu)
        trace_range(self.verbose, "encode/log_var", log_var)
        return EncoderOutput(mu=mu, log_var=log_var, pre_latents=h)

    def decode_logits(self, z: torch.Tensor, train: bool = False, y: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Latents (and a conditional model's labels) → NHWC logits,
        center-cropped to ``input_dim`` when the decoder's natural size
        differs. Always contiguous."""
        s = self.last_conv_size
        trace_range(self.verbose, "decode/latents", z)
        if self.num_classes > 0:
            z = torch.cat([z.to(self.dtype), class_onehot(self, y, "decode")], dim=-1)
        h = self.decoder_input(z).reshape(-1, s, s, self.hidden_dims[-1])
        trace_range(self.verbose, "decode/decoder_input", h)
        return self._decode_features(h.permute(0, 3, 1, 2), train, trace=self.verbose)

    def _decode_features(self, h: torch.Tensor, train: bool, trace: bool = False) -> torch.Tensor:
        """NCHW features at the latent grid → NHWC logits through the
        decoder and the final layer, cropped to ``input_dim``; contiguous.
        ``trace`` prints the decoder's and the head's outputs."""
        h = self._stack("decoder", h, train)
        trace_range(trace, "decode/deconv_out", h, nchw=True)
        logits = self._stack("final_layer", h, train)
        trace_range(trace, "decode/logits", logits)
        d = self.decoded_size
        if d != self.input_dim:
            off = (d - self.input_dim) // 2
            logits = logits[:, off : off + self.input_dim, off : off + self.input_dim, :]
        return logits.contiguous()

    def decode(self, z: torch.Tensor, train: bool = False, y: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Latents → reconstruction probabilities (sigmoid of logits)."""
        return torch.sigmoid(self.decode_logits(z, train, y=y))

    def reparameterize(
        self,
        mu: torch.Tensor,
        log_var: torch.Tensor,
        *,
        seed: Optional[int] = None,
        eps: Optional[torch.Tensor] = None,
        rows: Optional[Tuple[int, int]] = None,
    ) -> torch.Tensor:
        """z = mu + eps·exp(log_var/2), eps ~ N(0, I).

        ``eps`` given: used as the draw (cast to mu's dtype), through plain
        autograd — the hook tests use to inject the JAX side's draw.
        Otherwise ``seed`` keys the draw: K3's Philox stream with
        ``fused_reparam=True`` (the kernel on the card, its plain version on
        the CPU: the same noise), else a ``torch.Generator`` on mu's device.
        ``rows`` = (first, total): this batch is rows [first, first + B)
        of a draw over ``total`` rows (a rank of a data-parallel step
        draws its rows of the global batch's): K3 at the first row's Philox
        counter offset, or those rows of the generator's draw. By default
        the batch is the whole draw.
        """
        if eps is not None:
            return mu + eps.to(mu.dtype) * torch.exp(0.5 * log_var)
        if seed is None:
            raise ValueError("reparameterize needs a seed or an explicit eps")
        first, total = (0, mu.shape[0]) if rows is None else rows
        if self.fused_reparam:
            z, _ = fused_reparam_kl(mu, log_var, seed, first * mu.shape[1])
            return z
        gen = torch.Generator(device=mu.device).manual_seed(int(seed))
        eps = torch.randn((total, *mu.shape[1:]), generator=gen, device=mu.device, dtype=mu.dtype)
        return mu + eps[first : first + mu.shape[0]] * torch.exp(0.5 * log_var)

    def forward(
        self,
        x: torch.Tensor,
        train: bool = False,
        *,
        seed: Optional[int] = None,
        eps: Optional[torch.Tensor] = None,
        y: Optional[torch.Tensor] = None,
        rows: Optional[Tuple[int, int]] = None,
    ) -> ModelOutput:
        """Full forward pass on NHWC ``x``; see :meth:`reparameterize` for
        ``seed``/``eps``/``rows``. ``y`` (int labels [B]) is required by a
        conditional model."""
        encoded = self.encode(x, train, y=y)
        z = self.reparameterize(encoded.mu, encoded.log_var, seed=seed, eps=eps, rows=rows)
        logits = self.decode_logits(z, train, y=y)
        return ModelOutput(output=torch.sigmoid(logits), logits=logits, input=x, encoded=encoded, latents=z)


def param_group_label(name: str) -> str:
    """Optimizer group of a parameter, by its dotted name: the encoder stack
    and the latent heads train as "encoder", everything from
    ``decoder_input`` on as "decoder" (midi_vae_tpu/models/vae.py:715-733)."""
    top = name.split(".")[0]
    if top == "encoder" or top.startswith("encoder_") or top in ("fc_mu", "fc_var"):
        return "encoder"
    return "decoder"

"""Autoregressive priors over VQ-VAE code grids (counterpart of
``midi_vae_tpu/models/prior.py``).

Both priors map an ``[B, s, s]`` grid of code indices (and, for a
class-conditional prior, int labels ``y`` [B]) to next-code logits
``[B, s, s, K]``: the logits at raster position t depend only on codes
earlier in raster order.

- :class:`CodePrior`, a PixelCNN: masked 5×5 convolutions over one-hot
  code planes (mask A excludes the centre in the first layer, mask B
  includes it after), ReLU residual stack, two 1×1 convs; a conditional
  prior adds a learned per-class bias after every masked conv.
- :class:`TransformerCodePrior`, decoder-only: code embedding, a learned
  BOS shifted in on the right, learned positions, pre-LN blocks of causal
  multi-head attention and a GELU MLP; a conditional prior adds a learned
  per-class embedding to every token.

Submodules carry the flax module names (``MaskedConv_0``,
``LayerNorm_3``, ``MultiHeadDotProductAttention_1`` …), so
``interop/from_jax.py`` carries the JAX package's weights across.
flax semantics kept: LayerNorm ε = 1e-6 with f32 statistics and output;
GELU is the tanh approximation; attention scales q by 1/√(F/H) and fills
masked scores with the dtype's most negative finite value. The code and
class embeddings are gathers, which equal the JAX package's one-hot
contractions exactly. Compute runs in ``dtype`` with f32 parameters.

:func:`sample_codes_autoregressive` (defined in ``core/sampling.py``,
which the artifact loader shares) is the ancestral sampler: one full
forward per raster position, as the JAX package's ``lax.scan``; draws
come from a ``torch.Generator`` keyed by the seed.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from midi_vae_tpu_torch.core.sampling import nucleus_mask, sample_codes_autoregressive  # noqa: F401  (this module's API too)
from midi_vae_tpu_torch.models.vae import Conv, Dense

_LN_EPS = 1e-6  # flax LayerNorm's epsilon


def causal_mask(kh: int, kw: int, include_center: bool) -> torch.Tensor:
    """[kh, kw] raster-order causal mask of a conv kernel: rows above the
    centre, and on the centre row the positions left of it (and the centre
    itself for mask B)."""
    m = torch.zeros(kh, kw)
    ch, cw = kh // 2, kw // 2
    m[:ch, :] = 1.0
    m[ch, :cw] = 1.0
    if include_center:
        m[ch, cw] = 1.0
    return m


class MaskedConv(Conv):
    """SAME stride-1 conv whose kernel is multiplied by a causal mask at
    apply time; the mask is a constant (a buffer outside the state dict)."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 5, include_center: bool = False, *,
                 dtype=torch.float32, generator: torch.Generator):
        super().__init__(in_features, features, kernel_size=kernel_size, dtype=dtype, generator=generator)
        self.register_buffer("mask", causal_mask(kernel_size, kernel_size, include_center)[None, None], persistent=False)

    def kernel(self) -> torch.Tensor:
        return self.weight * self.mask


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm()``: statistics and output in f32, ε = 1e-6."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))  # flax "scale"
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias, _LN_EPS)


class MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention(num_heads, qkv_features=F)``
    self-attention with a boolean mask. ``query``/``key``/``value`` are
    [F → H·F/H] and ``out`` [H·F/H → F] Denses (flax's DenseGeneral kernels
    flattened)."""

    def __init__(self, features: int, num_heads: int, *, dtype=torch.float32, generator: torch.Generator):
        super().__init__()
        if features % num_heads:
            raise ValueError(f"features ({features}) must be divisible by num_heads ({num_heads})")
        self.num_heads, self.dtype = num_heads, dtype
        for name in ("query", "key", "value", "out"):
            setattr(self, name, Dense(features, features, dtype=dtype, generator=generator))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, length, feats = x.shape
        h, dh = self.num_heads, feats // self.num_heads

        def heads(proj):  # [B, L, F] → [B, H, L, dh]
            return proj(x).reshape(b, length, h, dh).transpose(1, 2)

        q = heads(self.query) / math.sqrt(dh)
        k, v = heads(self.key), heads(self.value)
        scores = torch.matmul(q, k.transpose(-1, -2))
        scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
        weights = torch.softmax(scores, dim=-1).to(self.dtype)
        o = torch.matmul(weights, v).transpose(1, 2).reshape(b, length, feats)
        return self.out(o)


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    return F.one_hot(idx.long(), n).to(dtype)


def _check_labels(prior: nn.Module, y: Optional[torch.Tensor]) -> None:
    if prior.num_classes > 0 and y is None:
        raise ValueError(
            f"this {type(prior).__name__} is class-conditional over {prior.num_classes} classes; "
            "forward needs int labels y [B]"
        )


class CodePrior(nn.Module):
    """PixelCNN over ``[s, s]`` grids of ``num_codes`` indices (see the module docstring)."""

    def __init__(self, num_codes: int = 512, features: int = 128, num_layers: int = 6, kernel_size: int = 5,
                 num_classes: int = 0, dtype=torch.float32, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.num_codes, self.num_layers, self.num_classes, self.dtype = num_codes, num_layers, num_classes, dtype
        kw = dict(dtype=dtype, generator=gen)
        for i in range(num_layers):
            cin = num_codes if i == 0 else features
            setattr(self, f"MaskedConv_{i}", MaskedConv(cin, features, kernel_size, include_center=i > 0, **kw))
            if num_classes > 0:
                setattr(self, f"Dense_{i}", Dense(num_classes, features, **kw))
        self.Conv_0 = Conv(features, features, kernel_size=1, **kw)
        self.Conv_1 = Conv(features, num_codes, kernel_size=1, **kw)

    def forward(self, idx: torch.Tensor, y: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, s, s] int codes → [B, s, s, K] next-code logits."""
        _check_labels(self, y)
        cond = _one_hot(y, self.num_classes, self.dtype) if self.num_classes > 0 else None

        def layer(i: int, x: torch.Tensor) -> torch.Tensor:
            h = getattr(self, f"MaskedConv_{i}")(x)
            if cond is not None:  # spatially constant per-class pre-activation bias
                h = h + getattr(self, f"Dense_{i}")(cond)[:, :, None, None]
            return h

        h = layer(0, _one_hot(idx, self.num_codes, self.dtype).permute(0, 3, 1, 2))
        for i in range(1, self.num_layers):
            h = h + layer(i, F.relu(h))
        h = F.relu(self.Conv_0(F.relu(h)))
        return self.Conv_1(h).permute(0, 2, 3, 1)


class TransformerCodePrior(nn.Module):
    """Decoder-only transformer over raster-ordered ``[grid, grid]`` code
    grids (see the module docstring); ``grid`` fixes the learned positions."""

    def __init__(self, num_codes: int = 512, features: int = 128, num_layers: int = 4, num_heads: int = 4,
                 mlp_ratio: int = 4, num_classes: int = 0, dtype=torch.float32, *, grid: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.num_codes, self.num_layers, self.num_classes, self.dtype = num_codes, num_layers, num_classes, dtype
        length = grid * grid
        kw = dict(dtype=dtype, generator=gen)
        self.embed = Dense(num_codes, features, **kw)
        self.bos = nn.Parameter(0.02 * torch.randn(features, generator=gen))
        self.pos_embed = nn.Parameter(0.02 * torch.randn(length, features, generator=gen))
        if num_classes > 0:
            self.class_bias = Dense(num_classes, features, **kw)
        for i in range(num_layers):
            setattr(self, f"LayerNorm_{2 * i}", LayerNorm(features))
            setattr(self, f"MultiHeadDotProductAttention_{i}", MultiHeadDotProductAttention(features, num_heads, **kw))
            setattr(self, f"LayerNorm_{2 * i + 1}", LayerNorm(features))
            setattr(self, f"Dense_{2 * i}", Dense(features, features * mlp_ratio, **kw))
            setattr(self, f"Dense_{2 * i + 1}", Dense(features * mlp_ratio, features, **kw))
        setattr(self, f"LayerNorm_{2 * num_layers}", LayerNorm(features))
        setattr(self, f"Dense_{2 * num_layers}", Dense(features, num_codes, **kw))
        self.register_buffer("causal", torch.ones(length, length, dtype=torch.bool).tril(), persistent=False)

    def forward(self, idx: torch.Tensor, y: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, s, s] int codes → [B, s, s, K] next-code logits."""
        _check_labels(self, y)
        b, s1, s2 = idx.shape
        dt = self.dtype
        h = F.embedding(idx.reshape(b, s1 * s2).long(), self.embed.weight.t().to(dt)) + self.embed.bias.to(dt)
        # shift right: the logits at position t see [BOS, x_0 .. x_{t-1}]
        h = torch.cat([self.bos.to(dt).expand(b, 1, -1), h[:, :-1]], dim=1) + self.pos_embed.to(dt)[None]
        if self.num_classes > 0:
            cb = self.class_bias
            h = h + (F.embedding(y.long(), cb.weight.t().to(dt)) + cb.bias.to(dt))[:, None, :]
        for i in range(self.num_layers):
            a = getattr(self, f"MultiHeadDotProductAttention_{i}")(getattr(self, f"LayerNorm_{2 * i}")(h), self.causal)
            h = h + a
            m = getattr(self, f"Dense_{2 * i}")(getattr(self, f"LayerNorm_{2 * i + 1}")(h))
            h = h + getattr(self, f"Dense_{2 * i + 1}")(F.gelu(m, approximate="tanh"))
        h = getattr(self, f"LayerNorm_{2 * self.num_layers}")(h)
        return getattr(self, f"Dense_{2 * self.num_layers}")(h).reshape(b, s1, s2, self.num_codes)


def grid_log_likelihood(logits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Mean per-grid log-likelihood (nats) of [B, s, s] grids from their [B, s, s, K] logits."""
    return torch.mean(torch.sum(picked_log_probs(logits, idx), dim=(1, 2)))


def picked_log_probs(logits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[B, s, s] log-probabilities (f32) of the codes ``idx`` under ``logits``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(logp, -1, idx.long()[..., None])[..., 0]


def prior_nll(prior: nn.Module, idx: torch.Tensor, y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The prior's training loss: mean NLL in nats per position, f32."""
    return -torch.mean(picked_log_probs(prior(idx, y), idx))

"""FoldedVAE — the folded conv VAE layout (counterpart of
``midi_vae_tpu/models/folded.py``).

Space-to-depth folds the input by ``fold`` first (128²×1 → 16²×64 at
fold 8), so every conv runs at small spatial size with many channels; the
head unfolds the logits with depth-to-space. Stage plan for L hidden dims
and fold f (a power of two ≤ 2^L):

- encoder: s2d(f) → L ConvBlocks; the first ``L − log2(f)`` use stride 2,
  the rest stride 1;
- decoder: L−1 blocks; the last ``L − log2(f)`` are stride-2 DeconvBlocks,
  the earlier ones stride-1 ConvBlocks;
- head: ConvBlock(s1) → Conv(f²·out_ch) → depth-to-space(f) → NHWC logits.

Both folds order channels (fi, fj, c), as the JAX package does; that is
``pixel_unshuffle``/``pixel_shuffle``'s order only for one channel, so
they are written out (``models/vae.py``, shared with the s2d stem and the
d2s head). ``norm`` and ``remat`` apply as in VanillaVAE; ``stem``,
``head`` and ``torch_compat`` do not (``ValueError``, as in JAX).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn

from midi_vae_tpu_torch.models.vae import (  # noqa: F401  (the folds are this module's API too)
    BlockStack,
    Conv,
    ConvBlock,
    DeconvBlock,
    VanillaVAE,
    _depth_to_space,
    _logit_bias_init,
    _space_to_depth,
)


def _log2_int(n: int) -> int:
    r = int(math.log2(n))
    if 2**r != n:
        raise ValueError(f"fold must be a power of two, got {n}")
    return r


class FoldedEncoder(BlockStack):
    """s2d(fold) → ConvBlocks: NHWC images → NCHW features."""

    def __init__(self, in_channels: int, hidden_dims: Sequence[int], *, fold: int, dtype, norm, generator):
        n_down = len(hidden_dims) - _log2_int(fold)
        if n_down < 0:
            raise ValueError(f"fold={fold} exceeds the 2^{len(hidden_dims)} stage downsample")
        dims = (fold * fold * in_channels, *hidden_dims)
        super().__init__(
            [
                ConvBlock(dims[i], dims[i + 1], stride=2 if i < n_down else 1, dtype=dtype, norm=norm, generator=generator)
                for i in range(len(hidden_dims))
            ]
        )
        self.fold = fold

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return super().forward(_space_to_depth(x, self.fold).permute(0, 3, 1, 2), train)


class FoldedDecoder(BlockStack):
    """Stride-1 ConvBlocks, then stride-2 DeconvBlocks (``hidden_dims`` reversed)."""

    def __init__(self, hidden_dims: Sequence[int], *, fold: int, dtype, norm, generator):
        n_up = len(hidden_dims) - _log2_int(fold)
        n_flat = len(hidden_dims) - 1 - n_up
        kw = dict(dtype=dtype, norm=norm, generator=generator)
        blocks = []
        for i in range(len(hidden_dims) - 1):
            cin, cout = hidden_dims[i], hidden_dims[i + 1]
            blocks.append(ConvBlock(cin, cout, stride=1, **kw) if i < n_flat else DeconvBlock(cin, cout, **kw))
        super().__init__(blocks)


class FoldedHead(nn.Module):
    """ConvBlock(s1) → Conv(f²·out_ch) → depth-to-space(f) → NHWC logits."""

    def __init__(
        self, features: int, out_channels: int, *, fold: int, dtype, norm, generator, output_logit_bias=None
    ):
        super().__init__()
        self.fold = fold
        self.out_channels = out_channels
        self.ConvBlock_0 = ConvBlock(features, features, stride=1, dtype=dtype, norm=norm, generator=generator)
        # unfolds onto output pixels, so this bias IS the output-logit bias
        self.Conv_0 = Conv(
            features, fold * fold * out_channels, stride=1, dtype=dtype, generator=generator,
            bias_value=_logit_bias_init(output_logit_bias),
        )

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = self.Conv_0(self.ConvBlock_0(x, train)).permute(0, 2, 3, 1)
        return _depth_to_space(x, self.fold, self.out_channels)


class FoldedVAE(VanillaVAE):
    """VanillaVAE with the folded compute layout (see module docstring):
    same interface, latent heads and crop rule; different conv stacks."""

    def __init__(self, *args, fold: int = 4, **kwargs):
        if kwargs.get("torch_compat") or kwargs.get("stem", "conv") != "conv" or kwargs.get("head", "deconv") != "deconv":
            raise ValueError(f"{type(self).__name__} has its own layout; stem/head/torch_compat do not apply")
        if fold < 2:
            raise ValueError(f"FoldedVAE needs fold >= 2, got {fold}")
        self.fold = fold
        super().__init__(*args, **kwargs)
        if self.input_dim % fold:
            raise ValueError(f"input_dim={self.input_dim} not divisible by fold={fold}")

    @property
    def decoded_size(self) -> int:
        n_up = len(self.hidden_dims) - _log2_int(self.fold)
        return self.last_conv_size * (2**n_up) * self.fold

    def _build(self, gen: torch.Generator) -> None:
        kw = dict(fold=self.fold, dtype=self.dtype, norm=self.norm, generator=gen)
        rev = tuple(reversed(self.hidden_dims))
        self.encoder = FoldedEncoder(self.in_channels, self.hidden_dims, **kw)
        self._build_heads(gen)
        self.decoder = FoldedDecoder(rev, **kw)
        self.final_layer = FoldedHead(rev[-1], self.out_channels, output_logit_bias=self.output_logit_bias, **kw)

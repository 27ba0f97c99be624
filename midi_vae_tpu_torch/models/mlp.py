"""MLPVAE: a dense encoder and decoder over flattened NHWC images
(counterpart of ``midi_vae_tpu/models/mlp.py``).

Dense layers with Xavier-uniform kernels and zero biases, LeakyReLU 0.01
between them, and the output-logit bias on ``decoder_out``. The layers
carry flax's names (``encoder_0``, ``encoder_1``, …, ``fc_mu``,
``fc_var``, ``decoder_0``, …, ``decoder_out``), so
``interop/from_jax.py`` maps a flax tree onto the model. The interface is
VanillaVAE's: the same reparameterization (K3 with ``fused_reparam``),
labels for ``num_classes`` > 0 joined at the dense bottleneck, NHWC
logits out. ``verbose`` prints the JAX package's two encoder stages
(``trace_range``); ``remat`` is accepted and inert, as in JAX (the dense
stack stores little).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from midi_vae_tpu_torch.core.types import EncoderOutput
from midi_vae_tpu_torch.models.vae import _LEAKY_SLOPE, Dense, VanillaVAE, _logit_bias_init, class_onehot, trace_range


class MLPVAE(nn.Module):
    """Dense encoder/decoder VAE; parameters are drawn on the CPU from
    ``generator`` (seed 0 when none is given)."""

    def __init__(
        self,
        in_channels: int = 1,
        latent_dim: int = 10,
        input_dim: int = 32,
        hidden_dims: Sequence[int] = (512, 256),
        out_channels: Optional[int] = None,
        dtype: torch.dtype = torch.float32,
        fused_reparam: bool = False,
        output_logit_bias: Optional[float] = None,
        num_classes: int = 0,
        verbose: bool = False,
        remat: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.verbose, self.remat = bool(verbose), bool(remat)
        self.in_channels = in_channels
        self.latent_dim = latent_dim
        self.input_dim = input_dim
        self.hidden_dims = tuple(hidden_dims)
        self.out_channels = out_channels or in_channels
        self.dtype = dtype
        self.fused_reparam = fused_reparam
        self.num_classes = int(num_classes)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        kw = dict(dtype=dtype, generator=gen)
        dims = (self.flat_size, *self.hidden_dims)
        self.n_layers = len(self.hidden_dims)
        for i in range(self.n_layers):
            self.add_module(f"encoder_{i}", Dense(dims[i], dims[i + 1], **kw))
        self.fc_mu = Dense(dims[-1] + self.num_classes, latent_dim, **kw)
        self.fc_var = Dense(dims[-1] + self.num_classes, latent_dim, **kw)
        rev = (latent_dim + self.num_classes, *reversed(self.hidden_dims))
        for i in range(self.n_layers):
            self.add_module(f"decoder_{i}", Dense(rev[i], rev[i + 1], **kw))
        self.decoder_out = Dense(rev[-1], input_dim * input_dim * self.out_channels, **kw)
        with torch.no_grad():
            self.decoder_out.bias.fill_(_logit_bias_init(output_logit_bias))

    @property
    def flat_size(self) -> int:
        return self.input_dim * self.input_dim * self.in_channels

    def _stack(self, prefix: str, h: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            h = F.leaky_relu(getattr(self, f"{prefix}_{i}")(h), _LEAKY_SLOPE)
        return h

    def encode(self, x: torch.Tensor, train: bool = False, y: Optional[torch.Tensor] = None) -> EncoderOutput:
        """NHWC images → (mu, log_var); ``pre_latents`` is the last hidden layer."""
        trace_range(self.verbose, "encode/input", x)
        h = self._stack("encoder", x.reshape(x.shape[0], -1))
        trace_range(self.verbose, "encode/hidden", h)
        hc = torch.cat([h, class_onehot(self, y, "encode")], dim=-1) if self.num_classes > 0 else h
        return EncoderOutput(mu=self.fc_mu(hc), log_var=self.fc_var(hc), pre_latents=h)

    def decode_logits(self, z: torch.Tensor, train: bool = False, y: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Latents → NHWC logits [B, input_dim, input_dim, out_channels]."""
        if self.num_classes > 0:
            z = torch.cat([z.to(self.dtype), class_onehot(self, y, "decode")], dim=-1)
        logits = self.decoder_out(self._stack("decoder", z))
        return logits.reshape(-1, self.input_dim, self.input_dim, self.out_channels)

    def decode(self, z: torch.Tensor, train: bool = False, y: Optional[torch.Tensor] = None) -> torch.Tensor:
        return torch.sigmoid(self.decode_logits(z, train, y=y))

    reparameterize = VanillaVAE.reparameterize
    forward = VanillaVAE.forward  # one forward: the train step's CUDA graphs engage on it (train/graphs.py)

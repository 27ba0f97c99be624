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
  0.9 is torch momentum 0.1.
- The flatten before ``fc_mu``/``fc_var`` and the reshape after
  ``decoder_input`` are in NHWC order, so the dense weights are the flax
  ones transposed.

Compute runs in ``dtype`` (bfloat16 on the flagship) with float32
parameters, as flax's ``dtype`` argument does.

A conditional model (``num_classes`` > 0) joins the one-hot label to the
flattened features before ``fc_mu``/``fc_var`` and to z before
``decoder_input``; those Dense layers are that much wider, as in flax.
Labels go to a model only through :func:`label_kwarg`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from midi_vae_tpu_torch.core.types import EncoderOutput, ModelOutput
from midi_vae_tpu_torch.ops.fused_elbo import fused_reparam_kl

_LEAKY_SLOPE = 0.01


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


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), strides, "SAME")`` on NCHW (k = 3 unless given)."""

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
    ):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.dtype = dtype
        self.weight = nn.Parameter(_xavier(torch.empty(features, in_features, kernel_size, kernel_size), generator))
        self.bias = nn.Parameter(torch.full((features,), bias_value))

    def kernel(self) -> torch.Tensor:
        """The kernel the conv applies, ``[out, in, k, k]`` in f32."""
        return self.weight

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW channels.

    Training: statistics of the batch in f32 (``E[x²] − E[x]²``, clipped at
    0, as flax's fast variance), and the running averages updated in place
    with the biased variance. Eval: the running averages. The output is
    computed in f32 and cast to ``dtype``.
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

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x32 = x.float()
        if train:
            mean = x32.mean(dim=(0, 2, 3))
            var = ((x32 * x32).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        y = (x32 - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(self.dtype)


def _check_norm(norm: str) -> None:
    if norm != "batch":
        raise NotImplementedError(f"norm={norm!r} is not ported to the PyTorch package yet (only 'batch')")


class ConvBlock(nn.Module):
    """Conv(k3, SAME, stride) + BatchNorm + LeakyReLU(0.01)."""

    def __init__(
        self,
        in_features: int,
        features: int,
        *,
        stride: int = 2,
        dtype: torch.dtype = torch.float32,
        norm: str = "batch",
        generator: torch.Generator,
    ):
        super().__init__()
        _check_norm(norm)
        self.Conv_0 = Conv(in_features, features, stride=stride, dtype=dtype, generator=generator)
        self.BatchNorm_0 = BatchNorm(features, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return F.leaky_relu(self.BatchNorm_0(self.Conv_0(x), train), _LEAKY_SLOPE)


class DeconvBlock(nn.Module):
    """ConvTranspose(k3, s2, SAME) + BatchNorm + LeakyReLU(0.01): doubles H and W."""

    def __init__(
        self,
        in_features: int,
        features: int,
        *,
        dtype: torch.dtype = torch.float32,
        norm: str = "batch",
        generator: torch.Generator,
    ):
        super().__init__()
        _check_norm(norm)
        self.ConvTranspose_0 = ConvTranspose(in_features, features, dtype=dtype, generator=generator)
        self.BatchNorm_0 = BatchNorm(features, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return F.leaky_relu(self.BatchNorm_0(self.ConvTranspose_0(x), train), _LEAKY_SLOPE)


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
    """Stride-2 ConvBlock stack: NHWC images → NCHW features."""

    def __init__(self, in_channels: int, hidden_dims: Sequence[int], *, dtype, norm, generator):
        dims = (in_channels, *hidden_dims)
        super().__init__(
            [ConvBlock(dims[i], dims[i + 1], dtype=dtype, norm=norm, generator=generator) for i in range(len(hidden_dims))]
        )

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2), train)


class Decoder(BlockStack):
    """DeconvBlock stack over ``hidden_dims`` (reversed order, e.g. (256, 128, 64, 32))."""

    def __init__(self, hidden_dims: Sequence[int], *, dtype, norm, generator):
        super().__init__(
            [
                DeconvBlock(hidden_dims[i], hidden_dims[i + 1], dtype=dtype, norm=norm, generator=generator)
                for i in range(len(hidden_dims) - 1)
            ]
        )


class FinalLayer(nn.Module):
    """DeconvBlock + Conv(k3, s1) → NHWC logits."""

    def __init__(self, in_features: int, features: int, out_channels: int, *, dtype, norm, generator, output_logit_bias=None):
        super().__init__()
        self.DeconvBlock_0 = DeconvBlock(in_features, features, dtype=dtype, norm=norm, generator=generator)
        self.Conv_0 = Conv(
            features, out_channels, stride=1, dtype=dtype, generator=generator,
            bias_value=_logit_bias_init(output_logit_bias),
        )

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return self.Conv_0(self.DeconvBlock_0(x, train)).permute(0, 2, 3, 1)


class VanillaVAE(nn.Module):
    """Convolutional VAE over NHWC piano-roll images.

    Only the reference layout is ported: ``stem="conv"``, ``head="deconv"``,
    ``norm="batch"``; ``num_classes`` > 0 makes it conditional. Parameters
    are created on the CPU from ``generator`` (seed 0 when none is given);
    move the model with ``.to``.
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
        num_classes: int = 0,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if stem != "conv" or head != "deconv":
            raise NotImplementedError("only stem='conv' and head='deconv' are ported to the PyTorch package yet")
        _check_norm(norm)
        self.num_classes = int(num_classes)
        self.in_channels = in_channels
        self.latent_dim = latent_dim
        self.input_dim = input_dim
        self.hidden_dims = tuple(hidden_dims)
        self.out_channels = out_channels or in_channels
        self.dtype = dtype
        self.fused_reparam = fused_reparam
        self.output_logit_bias = output_logit_bias
        self.norm = norm
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self._build(gen)

    def _build(self, gen: torch.Generator) -> None:
        kw = dict(dtype=self.dtype, norm=self.norm, generator=gen)
        rev = tuple(reversed(self.hidden_dims))
        self.encoder = Encoder(self.in_channels, self.hidden_dims, **kw)
        self._build_heads(gen)
        self.decoder = Decoder(rev, **kw)
        self.final_layer = FinalLayer(
            rev[-1], rev[-1], self.out_channels, output_logit_bias=self.output_logit_bias, **kw
        )

    def _build_heads(self, gen: torch.Generator) -> None:
        kw = dict(dtype=self.dtype, generator=gen)
        self.fc_mu = Dense(self.flattened_size + self.num_classes, self.latent_dim, **kw)
        self.fc_var = Dense(self.flattened_size + self.num_classes, self.latent_dim, **kw)
        self.decoder_input = Dense(self.latent_dim + self.num_classes, self.flattened_size, **kw)

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
        h = self.encoder(x, train)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        hc = torch.cat([h, class_onehot(self, y, "encode")], dim=-1) if self.num_classes > 0 else h
        return EncoderOutput(mu=self.fc_mu(hc), log_var=self.fc_var(hc), pre_latents=h)

    def decode_logits(self, z: torch.Tensor, train: bool = False, y: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Latents (and a conditional model's labels) → NHWC logits,
        center-cropped to ``input_dim`` when the decoder's natural size
        differs. Always contiguous."""
        s = self.last_conv_size
        if self.num_classes > 0:
            z = torch.cat([z.to(self.dtype), class_onehot(self, y, "decode")], dim=-1)
        h = self.decoder_input(z).reshape(-1, s, s, self.hidden_dims[-1]).permute(0, 3, 1, 2)
        return self._decode_features(h, train)

    def _decode_features(self, h: torch.Tensor, train: bool) -> torch.Tensor:
        """NCHW features at the latent grid → NHWC logits through the
        decoder and the final layer, cropped to ``input_dim``; contiguous."""
        logits = self.final_layer(self.decoder(h, train), train)
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
    ) -> torch.Tensor:
        """z = mu + eps·exp(log_var/2), eps ~ N(0, I).

        ``eps`` given: used as the draw (cast to mu's dtype), through plain
        autograd — the hook tests use to inject the JAX side's draw.
        Otherwise ``seed`` keys the draw: K3's Philox stream with
        ``fused_reparam=True`` (the kernel on the card, its plain version on
        the CPU: the same noise), else a ``torch.Generator`` on mu's device.
        """
        if eps is not None:
            return mu + eps.to(mu.dtype) * torch.exp(0.5 * log_var)
        if seed is None:
            raise ValueError("reparameterize needs a seed or an explicit eps")
        if self.fused_reparam:
            z, _ = fused_reparam_kl(mu, log_var, seed)
            return z
        gen = torch.Generator(device=mu.device).manual_seed(int(seed))
        eps = torch.randn(mu.shape, generator=gen, device=mu.device, dtype=mu.dtype)
        return mu + eps * torch.exp(0.5 * log_var)

    def forward(
        self,
        x: torch.Tensor,
        train: bool = False,
        *,
        seed: Optional[int] = None,
        eps: Optional[torch.Tensor] = None,
        y: Optional[torch.Tensor] = None,
    ) -> ModelOutput:
        """Full forward pass on NHWC ``x``; see :meth:`reparameterize` for
        ``seed``/``eps``. ``y`` (int labels [B]) is required by a conditional
        model."""
        encoded = self.encode(x, train, y=y)
        z = self.reparameterize(encoded.mu, encoded.log_var, seed=seed, eps=eps)
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

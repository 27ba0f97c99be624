"""VQ-VAE: vector-quantized discrete latents over piano rolls (counterpart
of ``midi_vae_tpu/models/vq.py``).

The conv trunks are the Gaussian models' (``models/vae.py``,
``models/folded.py``), with their ``stem``, ``head``, ``norm`` and
``remat`` variants (the quantizer stays outside the rematted stacks, as
in JAX; ``verbose`` is stored and prints nothing, as JAX's VQ models);
only the bottleneck differs: a 1×1 projection to
the code dimension D, a nearest-code quantizer over an EMA codebook of K
vectors, and a 1×1 projection back. The latent stays spatial: an
``[s, s]`` grid of code indices, s = input_dim / 2^stages.

The quantizer's state (``codebook`` [K, D], ``cluster_size`` [K],
``embed_avg`` [K, D]) is three buffers, updated in the forward with
``train=True`` and no autograd, as BatchNorm's running statistics are: it
rides the state dict, the checkpoints and the train step with them.
Semantics kept from the JAX package:

- quantization uses the codebook from before this batch's update;
- distances ``‖z‖² − 2 z·eᵀ + ‖e‖²`` in f32, whatever the model's compute
  dtype. The cross term is computed in f64 and rounded to f32, so no
  TF32 setting of the process can lower its precision (TF32 ranks
  near-ties wrongly); the argmin takes the first index on a tie;
- the EMA counts and sums (``one_hot(idx).T @ 1`` and ``one_hot(idx).T @ z``
  in JAX) are f32 sums of ones and vectors into [K] and [K, D]: the same
  sums, in another order; the counts are exact below 2^24 vectors. They
  make no host sync.
  Under ``parallel.collectives.cross_rank_statistics`` they are summed
  over the group's ranks before the update, so every rank's codebook
  takes the global batch's update (JAX ``psum`` over ``bn_axis_name``);
- Laplace smoothing of the cluster sizes before the codebook division;
- the straight-through output ``z_e + (z_q − z_e).detach()``.

Where it runs: on a card (CUDA tensors, the f32 codebook every model
dtype but f64 keeps), the search and the sums are the hand-written
kernels of ``ops/vq_search.py``: one launch finds each vector's nearest
code, in f64 cross terms rounded to f32 and an f32 distance in registers,
and writes the index, z_q and, in training, each block's partial counts
and sums; a second launch sums those. Nothing of size [N, K] is written.
Everywhere else (the CPU, an f64 model) the plain version of the same
module runs: :meth:`VectorQuantizerEMA.distances` (``distances_plain``),
``argmin`` and ``index_select``, then ``index_add_`` for the sums
(``code_sums_plain``; unlike ``bincount``, which reads the indices' range
back to the host on a CUDA tensor). The rules above hold on both; an
index may differ between the two only where two codes' f32 distances are
a rounding of the cross term apart.

While a profiler records, a call is the span ``model.quantize``
(the search, the code gather and the straight-through value) and,
in training, ``model.codebook_update`` (the sums' reduction and the EMA
update) after it; the counters ``vq.calls`` and ``vq.vectors`` count every
call and its vectors, and ``vq.fused_calls`` the calls that took the
kernels (``io/tracing.py``).

``encode`` returns the flattened pre-quantization latent as ``mu`` (NHWC
order) with ``log_var`` zero; ``decode``/``decode_logits`` quantize a
flattened latent before decoding, so the inference entry points work
unchanged. ``sample`` draws codes i.i.d. per position from the EMA usage
marginal; the learned prior is ``models/prior.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from midi_vae_tpu_torch.core.rng import categorical
from midi_vae_tpu_torch.core.types import EncoderOutput, ModelOutput
from midi_vae_tpu_torch.io import tracing
from midi_vae_tpu_torch.models.folded import FoldedVAE
from midi_vae_tpu_torch.models.vae import Conv, VanillaVAE
from midi_vae_tpu_torch.ops import vq_search
from midi_vae_tpu_torch.parallel.collectives import all_reduce_sum


class VectorQuantizerEMA(nn.Module):
    """Nearest-code quantizer with EMA codebook updates (see the module
    docstring). ``codebook = embed_avg / laplace(cluster_size)`` after each
    update; ``cluster_size`` starts at ones and ``embed_avg`` at the
    codebook, so the first update does not inflate the codebook."""

    def __init__(
        self, num_codes: int = 512, embed_dim: int = 16, decay: float = 0.99, epsilon: float = 1e-5,
        *, generator: torch.Generator,
    ):
        super().__init__()
        self.num_codes, self.embed_dim = num_codes, embed_dim
        self.decay, self.epsilon = decay, epsilon
        codebook = torch.randn(num_codes, embed_dim, generator=generator)
        self.register_buffer("codebook", codebook)
        self.register_buffer("cluster_size", torch.ones(num_codes))
        self.register_buffer("embed_avg", codebook.clone())

    def distances(self, flat: torch.Tensor) -> torch.Tensor:
        """[N, D] f32 vectors → [N, K] squared distances to the codes, f32 (the plain version's)."""
        return vq_search.distances_plain(flat, self.codebook)

    def forward(self, z_e: torch.Tensor, train: bool):
        """``z_e`` [..., D] → (straight-through z_q [..., D] f32, indices [...]);
        ``train=True`` also applies one EMA update from this batch."""
        with tracing.span("model.quantize"):
            z_e32 = z_e.float()
            flat = z_e32.reshape(-1, self.embed_dim)  # a view where z_e is dense: one f32 copy, not two
            with torch.no_grad():
                idx, z_q, partials = vq_search.nearest_codes(flat, self.codebook, train=train)
            z_st = z_e32 + (z_q.reshape(z_e.shape) - z_e32).detach()
        if train:
            with tracing.span("model.codebook_update"), torch.no_grad():
                self._ema_apply(*vq_search.code_sums(flat, idx, partials, self.num_codes))
        tracing.count("vq.calls", 1)
        tracing.count("vq.vectors", flat.shape[0])
        return z_st, idx.reshape(z_e.shape[:-1])

    cross_rank = None  # set by parallel.collectives.cross_rank_statistics

    @torch.no_grad()
    def _ema_update(self, flat: torch.Tensor, idx: torch.Tensor) -> None:
        """One EMA update from ``flat``'s vectors picked by ``idx``, the sums on the plain version."""
        self._ema_apply(*vq_search.code_sums_plain(flat.detach(), idx, self.num_codes))

    @torch.no_grad()
    def _ema_apply(self, counts: torch.Tensor, dw: torch.Tensor) -> None:
        """The EMA update from this rank's counts [K] and sums [K, D]."""
        k = self.num_codes
        if self.cross_rank is not None:  # the sums of the whole group's batch, in one all-reduce
            both = all_reduce_sum(torch.cat([counts[:, None], dw], dim=1), self.cross_rank.group)
            counts, dw = both[:, 0], both[:, 1:]
        # decay and 1 - decay rounded to f32, as the JAX package computes them
        d = np.float32(self.decay)
        one_minus = float(np.float32(1.0) - d)
        new_cs = self.cluster_size * float(d) + counts * one_minus
        new_ea = self.embed_avg * float(d) + dw * one_minus
        n = torch.sum(new_cs)
        smoothed = (new_cs + self.epsilon) / (n + k * self.epsilon) * n
        self.cluster_size.copy_(new_cs)
        self.embed_avg.copy_(new_ea)
        self.codebook.copy_(new_ea / smoothed[:, None])

    def embed(self, idx: torch.Tensor) -> torch.Tensor:
        """Code indices [...] → codebook vectors [..., D] (f32)."""
        return self.codebook.index_select(0, idx.reshape(-1).long()).reshape(*idx.shape, self.embed_dim)

    def usage_probs(self) -> torch.Tensor:
        """EMA code-usage marginal [K] (uniform when the counts sum to 0)."""
        cs = self.cluster_size
        total = torch.sum(cs)
        return torch.where(total > 0, cs / torch.clamp_min(total, 1e-9), torch.full_like(cs, 1.0 / self.num_codes))


class VQVAE(VanillaVAE):
    """Convolutional VQ-VAE over NHWC piano-roll images: the VanillaVAE
    trunk with the Gaussian heads replaced by ``to_latent`` (1×1 conv),
    ``quantizer`` and ``from_latent`` (1×1 conv). Unconditional only."""

    latent_kind = "vq"  # dispatch marker (inference.sample_prior, the CLIs, serving)

    def __init__(
        self,
        in_channels: int = 1,
        latent_dim: int = 16,
        input_dim: int = 32,
        hidden_dims=(32, 64, 128, 256),
        *,
        codebook_size: int = 512,
        vq_decay: float = 0.99,
        num_classes: int = 0,
        **kwargs,
    ):
        if num_classes:
            raise ValueError(
                "VQVAE has no conditional variant yet (the label would need to enter "
                "as spatial planes; use --model VanillaVAE for --conditional)"
            )
        self.codebook_size = int(codebook_size)
        self.vq_decay = float(vq_decay)
        super().__init__(in_channels=in_channels, latent_dim=latent_dim, input_dim=input_dim,
                         hidden_dims=hidden_dims, **kwargs)

    def _build_heads(self, gen: torch.Generator) -> None:
        kw = dict(kernel_size=1, dtype=self.dtype, generator=gen)
        self.to_latent = Conv(self.hidden_dims[-1], self.latent_dim, **kw)
        self.quantizer = VectorQuantizerEMA(self.codebook_size, self.latent_dim, self.vq_decay, generator=gen)
        self.from_latent = Conv(self.latent_dim, self.hidden_dims[-1], **kw)

    @property
    def flat_latent_dim(self) -> int:
        """Size of the flattened latent the encode/decode API carries."""
        return self.last_conv_size * self.last_conv_size * self.latent_dim

    # -- encoder side ------------------------------------------------------

    def _encode_spatial(self, x: torch.Tensor, train: bool):
        """NHWC images → (z_e NHWC [B, s, s, D], NCHW trunk features)."""
        h = self._stack("encoder", x, train)
        return self.to_latent(h).permute(0, 2, 3, 1), h

    @staticmethod
    def _encoded(z_e: torch.Tensor, h: torch.Tensor) -> EncoderOutput:
        flat = z_e.float().reshape(z_e.shape[0], -1)
        pre = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        return EncoderOutput(mu=flat, log_var=torch.zeros_like(flat), pre_latents=pre)

    def encode(self, x: torch.Tensor, train: bool = False) -> EncoderOutput:
        """``mu`` is the flattened pre-quantization latent; ``log_var`` is 0
        (the posterior is a point mass on the nearest code)."""
        return self._encoded(*self._encode_spatial(x, train))

    def encode_indices(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images → [B, s, s] int32 code grid."""
        z_e, _ = self._encode_spatial(x, False)
        return self.quantizer(z_e, False)[1].int()

    # -- decoder side ------------------------------------------------------

    def _decode_from_spatial(self, z_q: torch.Tensor, train: bool) -> torch.Tensor:
        h = self.from_latent(z_q.permute(0, 3, 1, 2).to(self.dtype))
        return self._decode_features(h, train)

    def decode_logits(self, z: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Flattened latent [B, s·s·D] → logits, quantized to the nearest
        codes first (no EMA update)."""
        s = self.last_conv_size
        z_q, _ = self.quantizer(z.reshape(-1, s, s, self.latent_dim), False)
        return self._decode_from_spatial(z_q, train)

    def decode(self, z: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Flattened latent → reconstruction probabilities, through the
        quantizer (VanillaVAE's ``decode`` passes labels, which a VQ model
        does not take)."""
        return torch.sigmoid(self.decode_logits(z, train))

    def decode_indices(self, idx: torch.Tensor) -> torch.Tensor:
        """[B, s, s] code grid → reconstruction probabilities [B, H, W, C]."""
        return torch.sigmoid(self._decode_from_spatial(self.quantizer.embed(idx), False))

    def forward(
        self,
        x: torch.Tensor,
        train: bool = False,
        *,
        seed: Optional[int] = None,
        eps: Optional[torch.Tensor] = None,
        rows: Optional[Tuple[int, int]] = None,
    ) -> ModelOutput:
        """Full forward pass (the EMA update happens here when ``train``).
        ``seed``, ``eps`` and ``rows`` are accepted for the Gaussian models'
        signature and unused: the VQ forward draws nothing."""
        z_e, h = self._encode_spatial(x, train)
        z_st, _ = self.quantizer(z_e, train)
        logits = self._decode_from_spatial(z_st, train)
        return ModelOutput(
            output=torch.sigmoid(logits), logits=logits, input=x, encoded=self._encoded(z_e, h),
            latents=z_st.reshape(z_st.shape[0], -1),
        )

    # -- prior sampling ----------------------------------------------------

    def sample_codes(self, num_samples: int, seed: int = 0) -> torch.Tensor:
        """[num, s, s] int32 code grids drawn i.i.d. per position from the EMA
        usage marginal, from a ``torch.Generator`` on the model's device
        keyed by ``seed``."""
        dev = self.quantizer.codebook.device
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        s = self.last_conv_size
        logits = torch.log(self.quantizer.usage_probs() + 1e-20).expand(num_samples, s, s, self.codebook_size)
        return categorical(logits, gen).int()

    def sample(self, num_samples: int, seed: int = 0) -> torch.Tensor:
        """Marginal code draws → decode: [num, H, W, C] probabilities."""
        return self.decode_indices(self.sample_codes(num_samples, seed))


class FoldedVQVAE(VQVAE, FoldedVAE):
    """VQ-VAE on the folded trunk (``models/folded.py``): the same
    bottleneck and code API as :class:`VQVAE`."""

    def __init__(self, *args, stem: str = "conv", head: str = "deconv", **kwargs):
        if stem != "conv" or head != "deconv":
            raise ValueError("FoldedVQVAE has its own layout; stem/head do not apply")
        super().__init__(*args, **kwargs)


def codebook_metrics(model) -> dict:
    """Codebook health from the EMA counts of a VQ model; ``{}`` for others.

    - ``codebook-perplexity``: exp(entropy) of the usage distribution
      (1 = collapsed to one code, K = uniform);
    - ``active-codes``: codes holding more than 1 % of a uniform share.
    """
    quantizer = getattr(model, "quantizer", None)
    if not isinstance(quantizer, VectorQuantizerEMA):
        return {}
    cs = quantizer.cluster_size.detach().double().cpu().numpy()
    total = cs.sum()
    if total <= 0:
        return {"codebook-perplexity": 0.0, "active-codes": 0}
    p = cs / total
    ent = -np.sum(p * np.log(np.maximum(p, 1e-20)))
    return {"codebook-perplexity": float(np.exp(ent)), "active-codes": int(np.sum(p > 0.01 / len(cs)))}

"""Plain reference of the folded VQ-VAE (FoldedVQVAE), as
``configs/vq16_fold8.yaml`` lays it out.

The model of van den Oord, Vinyals and Kavukcuoglu, *Neural Discrete
Representation Learning* (arXiv:1711.00937), on this repository's folded
trunk: the FoldedVAE's encoder, decoder and head from
``reference/vae.py`` (its convolutions, its f32 BatchNorm, LeakyReLU and
the folds), with the Gaussian heads replaced by a 1×1 convolution
``to_latent`` to the code dimension D, the nearest of K codes, and a 1×1
convolution ``from_latent`` back. Convolutions compute in the
configuration's dtype from f32 parameters, as in ``reference/vae.py``.

- Quantization: squared distances ‖z‖² − 2 z·e + ‖e‖² to the codebook
  from before the batch, computed in f64 in blocks of rows so that the
  [N, K] matrix fits; the first index on a tie. The straight-through value
  is z_e + (z_q − z_e) with the difference taken out of the gradient.
- The loss: the mean clamped BCE of the logits against the raw targets
  (the normalised input de-normalised, x·std + mean clipped to [0, 1]),
  plus β · mean((z_e − sg[z_q])²), β the commitment weight (``kld_weight``).
- The codebook learns by the EMA updates of the paper's Appendix A.1 and
  not by the loss: counts N_i and sums m_i of the vectors each code took,
  both kept as exponential moving averages at ``vq_decay`` (with
  1 − decay rounded to f32), then e_i = m_i / N_i; the counts start at
  ones and the sums at the codebook. The sums are taken in f64 and
  rounded to f32.
- AdamW under OneCycle, the learning rate and β1 cycles and the data of
  ``reference/vae.py`` and ``bench_cuda/frozen.py``.

Departures from the paper, each as this repository trains the model:

- Laplace smoothing of the counts before the division, N_i ← (N_i + ε) /
  (n + K ε) · n with n = Σ N_i and ε 1e-5, as in Sonnet's EMA quantizer,
  so that a code nobody picks does not divide by zero;
- the distances in f64 (the paper states no precision): the port takes the
  cross term in f64, so that no TF32 setting can mis-rank near-ties;
- a Bernoulli likelihood of the raw targets (the BCE) in place of the
  paper's decoder likelihood for images.

``compute="fp8"`` rounds every convolution's operands to float8 e4m3, and
``reordered=True`` takes BatchNorm's statistics in f64 on channels-last
convolutions, both as ``reference/vae.py`` defines them.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from bench_cuda import frozen
from bench_cuda.reference import vae

BLOCK_ROWS = 65536  # rows of the [N, K] f64 distance matrix computed at once
LAPLACE_EPS = 1e-5
RAW_MEAN, RAW_STD = 0.5, 1.0  # the pianoroll transform's normalisation, undone for raw BCE targets
BUFFERS = ("quantizer.codebook", "quantizer.cluster_size", "quantizer.embed_avg")


def trunk_config(cfg: dict) -> dict:
    """The configuration of the FoldedVAE whose trunk the model shares."""
    if cfg["arch"].lower() != "foldedvqvae":
        raise ValueError(f"no VQ reference for arch {cfg['arch']!r}")
    return {**cfg, "arch": "FoldedVAE"}


def spec(cfg: dict):
    """(parameters, buffers) as ``reference/vae.py`` ``spec`` gives them,
    with ``to_latent`` and ``from_latent`` in the place of the Gaussian
    heads and the quantizer's three buffers (init ``codebook``, ``ones``,
    ``codebook``)."""
    lay = vae.layout(trunk_config(cfg))
    params, buffers = vae.spec(trunk_config(cfg))
    heads = ("fc_mu.", "fc_var.", "decoder_input.")
    at = next(i for i, (name, _, _) in enumerate(params) if name.startswith(heads))
    params = [leaf for leaf in params if not leaf[0].startswith(heads)]
    c, d = lay["channels"], int(cfg["n_features"])
    params[at:at] = [("to_latent.weight", (d, c, 1, 1), "xavier"), ("to_latent.bias", (d,), "zeros"),
                     ("from_latent.weight", (c, d, 1, 1), "xavier"), ("from_latent.bias", (c,), "zeros")]
    k = int(cfg["codebook_size"])
    buffers += [("quantizer.codebook", (k, d), "codebook"), ("quantizer.cluster_size", (k,), "ones"),
                ("quantizer.embed_avg", (k, d), "codebook")]
    return params, buffers


def nearest(flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """[N, D] vectors → int64 [N], the index of the nearest code."""
    cb = codebook.double()
    e2 = (cb * cb).sum(dim=1)
    out = []
    for i in range(0, flat.shape[0], BLOCK_ROWS):
        z = flat[i : i + BLOCK_ROWS].double()
        out.append(torch.argmin((z * z).sum(dim=1, keepdim=True) - 2.0 * (z @ cb.T) + e2, dim=1))
    return torch.cat(out)


def ema_update(buffers: Dict[str, torch.Tensor], flat: torch.Tensor, idx: torch.Tensor, decay: float) -> dict:
    """The three buffers after one EMA update from the vectors ``flat`` and
    their codes ``idx``."""
    cs, ea = buffers["quantizer.cluster_size"], buffers["quantizer.embed_avg"]
    k = cs.shape[0]
    counts = torch.zeros(k, dtype=torch.float64, device=flat.device).index_add_(
        0, idx, torch.ones(idx.shape[0], dtype=torch.float64, device=flat.device)).float()
    sums = torch.zeros(ea.shape, dtype=torch.float64, device=flat.device).index_add_(0, idx, flat.double()).float()
    d = np.float32(decay)
    one_minus = float(np.float32(1.0) - d)
    new_cs = cs * float(d) + counts * one_minus
    new_ea = ea * float(d) + sums * one_minus
    n = new_cs.sum()
    smoothed = (new_cs + LAPLACE_EPS) / (n + k * LAPLACE_EPS) * n
    return {"quantizer.codebook": new_ea / smoothed[:, None], "quantizer.cluster_size": new_cs,
            "quantizer.embed_avg": new_ea}


class Model(vae.Model):
    """The reference model of ``cfg`` in ``compute`` precision (``float32``,
    ``bfloat16`` or ``fp8``); ``reordered``: in another order."""

    def __init__(self, cfg: dict, compute: Optional[str] = None, reordered: bool = False):
        super().__init__(trunk_config(cfg), compute, reordered)
        self.dim = int(cfg["n_features"])

    def _conv1x1(self, P, name, x):
        return F.conv2d(self._op(x), self._op(P[f"{name}.weight"]), P[f"{name}.bias"].to(self.dt))

    def encode_z(self, P, x):
        """NHWC images → z_e, NHWC [B, s, s, D] in the compute dtype."""
        f = self.lay["fold"]
        b, hh, ww, c = x.shape
        x = x.reshape(b, hh // f, f, ww // f, f, c).permute(0, 1, 3, 2, 4, 5).reshape(b, hh // f, ww // f, f * f * c)
        h = x.permute(0, 3, 1, 2)
        for blk in self.lay["enc"]:
            h = self._block(P, blk, h)
        return self._conv1x1(P, "to_latent", h).permute(0, 2, 3, 1)

    def decode_z(self, P, z):
        """NHWC [B, s, s, D] latents → NHWC logits in the compute dtype."""
        h = self._conv1x1(P, "from_latent", z.permute(0, 3, 1, 2).to(self.dt))
        for blk in self.lay["dec"] + self.lay["head"]:
            h = self._block(P, blk, h)
        y = self._conv(P, self.lay["out"][0], h, 1).permute(0, 2, 3, 1)
        f, c_in = self.lay["fold"], self.lay["in_channels"]
        b, hh, ww, _ = y.shape
        return y.reshape(b, hh, ww, f, f, c_in).permute(0, 1, 3, 2, 4, 5).reshape(b, hh * f, ww * f, c_in)

    def forward_train(self, P, x, codebook):
        """(logits, z_e in f32, the straight-through value, the codes) of a
        batch against ``codebook``."""
        z_e = self.encode_z(P, x).float()
        idx = nearest(z_e.detach().reshape(-1, self.dim), codebook)
        z_q = codebook[idx].reshape(z_e.shape)
        z_st = z_e + (z_q - z_e).detach()
        return self.decode_z(P, z_st), z_e, z_st, idx


def vq_loss(logits, x, z_e, z_st, beta: float):
    """(loss, reconstruction, commitment) in f32."""
    t = (x.float() * RAW_STD + RAW_MEAN).clamp(0.0, 1.0)
    l32 = logits.float()
    log_p = (-F.softplus(-l32)).clamp_min(vae.LOG_CLAMP)
    log_1mp = (-F.softplus(l32)).clamp_min(vae.LOG_CLAMP)
    recon = torch.mean(-(t * log_p + (1.0 - t) * log_1mp))
    commit = torch.mean(torch.square(z_e - z_st.detach()))
    return recon + beta * commit, recon, commit


def train_steps(cfg: dict, P0: Dict[str, torch.Tensor], corpus: torch.Tensor, *, batch: int, seed: int, steps: int,
                compute: Optional[str] = None, rows: Optional[int] = None, reordered: bool = False,
                buffers: Dict[str, torch.Tensor]) -> dict:
    """The first ``steps`` AdamW steps of epoch 1 from the parameters ``P0``
    and the quantizer's ``buffers`` over the uint8 ``corpus``, as
    ``reference/vae.py`` ``train_steps`` takes them: each step's loss,
    commitment term (under ``kls``, as the check reads it) and commitment
    weight, the first step's gradients, the parameters and the three
    buffers after the last step, and the codes of step 1 (``codes1``).
    ``rows`` keeps only the first rows of each batch."""
    if cfg.get("optimizer", "AdamW").lower() != "adamw" or cfg.get("scheduler", "OneCycle").lower() != "onecycle":
        raise ValueError("the reference trains with AdamW under OneCycle only")
    model = Model(cfg, compute, reordered)
    dev, n = corpus.device, len(corpus)
    P = {k: v.detach().clone().float().requires_grad_(True) for k, v in P0.items()}
    B = {k: buffers[k].detach().clone().float() for k in BUFFERS}
    names = list(P)
    m = {k: torch.zeros_like(P[k]) for k in names}
    v = {k: torch.zeros_like(P[k]) for k in names}
    order = frozen.train_order(seed, 1, n, batch)
    total = int(cfg["epochs"]) * (n // batch)
    max_lr = float(cfg["lr_relative"]) * batch / 128
    wd = float(cfg.get("weight_decay", 0.0))
    losses, commits, betas, first_grads, codes1 = [], [], [], None, None
    for t in range(steps):
        x = frozen.pianoroll_train_transform(corpus[torch.as_tensor(order[t], device=dev)],
                                             frozen.transform_seed(seed, 1, t))[:rows]
        logits, z_e, z_st, idx = model.forward_train(P, x, B["quantizer.codebook"])
        beta = vae.kl_weight(cfg, t)
        loss, _, commit = vq_loss(logits, x, z_e, z_st, beta)
        grads = torch.autograd.grad(loss, [P[k] for k in names])
        B = ema_update(B, z_e.detach().reshape(-1, model.dim), idx, float(cfg["vq_decay"]))
        if t == 0:
            first_grads = {k: g.detach().clone() for k, g in zip(names, grads)}
            codes1 = idx
        lr, b1 = vae.onecycle_lr(max_lr, total, t), vae.onecycle_beta1(total, t)
        with torch.no_grad():
            for k, g in zip(names, grads):
                p = P[k]
                m[k].mul_(b1).add_(g, alpha=1.0 - b1)
                v[k].mul_(vae.ADAM_B2).addcmul_(g, g, value=1.0 - vae.ADAM_B2)
                p.mul_(1.0 - lr * wd)
                denom = (v[k].sqrt() / math.sqrt(1.0 - vae.ADAM_B2 ** (t + 1))).add_(vae.ADAM_EPS)
                p.addcdiv_(m[k], denom, value=-lr / (1.0 - b1 ** (t + 1)))
        losses.append(float(loss.detach()))
        commits.append(float(commit.detach()))
        betas.append(beta)
    return {"losses": losses, "kls": commits, "kl_weights": betas, "first_grads": first_grads,
            "params": {k: P[k].detach() for k in names}, "buffers": B, "codes1": codes1}

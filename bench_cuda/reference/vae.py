"""Plain reference of the convolutional VAEs (VanillaVAE, FoldedVAE).

A functional model over a dict of named tensors, written from the model's
description: NHWC images; flax "SAME" convolutions (a stride-2 conv pads
(0, 1) on even sizes), transposed convolutions cropped to twice the input,
BatchNorm with f32 batch statistics and flax's default variance
E[x²] − E[x]² (on sparse rolls it differs from a two-pass variance by
~1e-3 in the first layers' gradients, even in f32), LeakyReLU
0.01; the flatten before the latent heads and the reshape after
``decoder_input`` in NHWC order; FoldedVAE folds 2-D blocks of ``fold``
pixels into channels first (channels ordered (row, column, channel)) and
unfolds the logits last. Convolutions and dense layers compute in the
configuration's dtype from f32 parameters, as mixed precision does.

On top: the ELBO (mean BCE over the logits with log terms clamped at
−100, plus β times the batch-mean Gaussian KL, in f32), AdamW as torch
defines it, the OneCycle learning-rate and β1 cycles, the KL weight's
schedule, and the training steps that hold the port's first steps. The
data and the noise come from the frozen copies in ``bench_cuda/frozen.py``.

``compute="fp8"`` rounds every convolution's and dense layer's operands to
float8 e4m3 (one scale a tensor, as fp8 matmuls take them) and passes the
gradient straight through: the lower precision that the checks must tell
apart from the configuration's. ``reordered=True`` computes the same model
in another order: BatchNorm's statistics accumulated in f64 and the
convolutions on channels-last tensors (other cuDNN kernels). It rounds
differently, as a sound change to the port's kernels would, and sets how
far apart two sound computations of one step read.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from bench_cuda import frozen

LEAKY_SLOPE = 0.01
BN_EPS = 1e-5
ADAM_B2 = 0.999
ADAM_EPS = 1e-8
LOG_CLAMP = -100.0
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_FP8_MAX = 448.0


def _log2(n: int) -> int:
    r = int(math.log2(n))
    if 2**r != n:
        raise ValueError(f"fold must be a power of two, got {n}")
    return r


def layout(cfg: dict) -> dict:
    """The blocks of the configuration's model in forward order, each
    (name, kind, in channels, out channels, stride); the heads' sizes."""
    hd = tuple(cfg["hidden_dims"])
    L, rev, c_in = len(hd), tuple(reversed(hd)), int(cfg.get("in_channels", 1))
    arch = cfg["arch"].lower()
    if arch == "vanillavae":
        fold, dims = 1, (c_in, *hd)
        enc = [(f"encoder.ConvBlock_{i}", "conv", dims[i], dims[i + 1], 2) for i in range(L)]
        dec = [(f"decoder.DeconvBlock_{i}", "deconv", rev[i], rev[i + 1], 2) for i in range(L - 1)]
        head = [("final_layer.DeconvBlock_0", "deconv", rev[-1], rev[-1], 2)]
        out_ch = c_in
    elif arch == "foldedvae":
        fold = int(cfg["fold"])
        n_down = L - _log2(fold)
        dims = (fold * fold * c_in, *hd)
        enc = [(f"encoder.ConvBlock_{i}", "conv", dims[i], dims[i + 1], 2 if i < n_down else 1) for i in range(L)]
        n_flat = L - 1 - n_down
        dec, counts = [], {"conv": 0, "deconv": 0}
        for i in range(L - 1):
            kind = "conv" if i < n_flat else "deconv"
            cls = "ConvBlock" if kind == "conv" else "DeconvBlock"
            dec.append((f"decoder.{cls}_{counts[kind]}", kind, rev[i], rev[i + 1], 1 if kind == "conv" else 2))
            counts[kind] += 1
        head = [("final_layer.ConvBlock_0", "conv", rev[-1], rev[-1], 1)]
        out_ch = fold * fold * c_in
    else:
        raise ValueError(f"no reference for arch {cfg['arch']!r}")
    grid = int(cfg["image_size"])
    for _ in range(L):
        grid = -(-grid // 2)
    return dict(enc=enc, dec=dec, head=head, out=("final_layer.Conv_0", rev[-1], out_ch), fold=fold, grid=grid,
                channels=hd[-1], flat=grid * grid * hd[-1], latent=int(cfg["n_features"]), in_channels=c_in,
                image_size=int(cfg["image_size"]))


def spec(cfg: dict):
    """(parameters, buffers): lists of (name, shape, init) in module order;
    init is ``xavier``, ``zeros``, ``ones``, ``logit_bias`` (the output
    conv's bias), ``running_mean`` or ``running_var``."""
    lay = layout(cfg)
    params, buffers = [], []

    def block(name, kind, cin, cout):
        if kind == "conv":
            params.extend([(f"{name}.Conv_0.weight", (cout, cin, 3, 3), "xavier"), (f"{name}.Conv_0.bias", (cout,), "zeros")])
        else:
            params.extend([(f"{name}.ConvTranspose_0.weight", (cin, cout, 3, 3), "xavier"),
                           (f"{name}.ConvTranspose_0.bias", (cout,), "zeros")])
        params.extend([(f"{name}.BatchNorm_0.weight", (cout,), "ones"), (f"{name}.BatchNorm_0.bias", (cout,), "zeros")])
        buffers.extend([(f"{name}.BatchNorm_0.running_mean", (cout,), "running_mean"),
                        (f"{name}.BatchNorm_0.running_var", (cout,), "running_var")])

    for name, kind, cin, cout, _ in lay["enc"]:
        block(name, kind, cin, cout)
    for head in ("fc_mu", "fc_var"):
        params.extend([(f"{head}.weight", (lay["latent"], lay["flat"]), "xavier"), (f"{head}.bias", (lay["latent"],), "zeros")])
    params.extend([("decoder_input.weight", (lay["flat"], lay["latent"]), "xavier"),
                   ("decoder_input.bias", (lay["flat"],), "zeros")])
    for name, kind, cin, cout, _ in lay["dec"] + lay["head"]:
        block(name, kind, cin, cout)
    name, cin, cout = lay["out"]
    params.extend([(f"{name}.weight", (cout, cin, 3, 3), "xavier"), (f"{name}.bias", (cout,), "logit_bias")])
    return params, buffers


# ------------------------------------------------------------------ forward


class _Fp8(torch.autograd.Function):
    """Round to float8 e4m3 under one per-tensor scale; gradient straight through."""

    @staticmethod
    def forward(ctx, t):
        amax = t.detach().abs().amax().float().clamp_min(1e-30)
        scale = _FP8_MAX / amax
        return (t.float() * scale).to(torch.float8_e4m3fn).float().div(scale).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


class Model:
    """The reference model of ``cfg`` in ``compute`` precision: ``float32``,
    ``bfloat16`` or ``fp8`` (bfloat16 with fp8 operands); ``reordered``: in
    another order (module docstring)."""

    def __init__(self, cfg: dict, compute: Optional[str] = None, reordered: bool = False):
        self.cfg, self.lay, self.reordered = cfg, layout(cfg), reordered
        compute = compute or cfg["dtype"]
        self.fp8 = compute == "fp8"
        self.dt = torch.bfloat16 if self.fp8 else DTYPES[compute]

    def _op(self, t):
        t = t.to(self.dt)
        if self.reordered and t.dim() == 4:
            t = t.contiguous(memory_format=torch.channels_last)
        return _Fp8.apply(t) if self.fp8 else t

    def _conv(self, P, name, x, stride):
        pads = []
        for size in (x.shape[3], x.shape[2]):  # F.pad takes the last dim first
            out = -(-size // stride)
            total = max((out - 1) * stride + 3 - size, 0)
            pads += [total // 2, total - total // 2]
        x = F.pad(self._op(x), pads)
        return F.conv2d(x, self._op(P[f"{name}.weight"]), P[f"{name}.bias"].to(self.dt), stride)

    def _deconv(self, P, name, x):
        h, w = x.shape[2], x.shape[3]
        y = F.conv_transpose2d(self._op(x), self._op(P[f"{name}.weight"]), P[f"{name}.bias"].to(self.dt), stride=2)
        return y[:, :, : 2 * h, : 2 * w]

    def _bn(self, P, name, x):
        """Train-mode BatchNorm: batch statistics with flax's default (fast)
        variance E[x²] − E[x]², clipped at 0."""
        x32 = x.float()
        acc = x32.double() if self.reordered else x32
        mean = acc.mean(dim=(0, 2, 3))
        var = ((acc * acc).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
        mean, var = mean.float(), var.float()
        scale = torch.rsqrt(var + BN_EPS) * P[f"{name}.weight"]
        y = (x32 - mean[:, None, None]) * scale[:, None, None] + P[f"{name}.bias"][:, None, None]
        return y.to(self.dt)

    def _block(self, P, blk, x):
        name, kind, _, _, stride = blk
        if kind == "conv":
            y = self._bn(P, f"{name}.BatchNorm_0", self._conv(P, f"{name}.Conv_0", x, stride))
        else:
            y = self._bn(P, f"{name}.BatchNorm_0", self._deconv(P, f"{name}.ConvTranspose_0", x))
        return F.leaky_relu(y, LEAKY_SLOPE)

    def _dense(self, P, name, x):
        return F.linear(self._op(x), self._op(P[f"{name}.weight"]), P[f"{name}.bias"].to(self.dt))

    def encode(self, P, x):
        """NHWC images → (mu, log_var) in the compute dtype."""
        f = self.lay["fold"]
        if f > 1:
            b, h, w, c = x.shape
            x = x.reshape(b, h // f, f, w // f, f, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h // f, w // f, f * f * c)
        h = x.permute(0, 3, 1, 2)
        for blk in self.lay["enc"]:
            h = self._block(P, blk, h)
        flat = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        return self._dense(P, "fc_mu", flat), self._dense(P, "fc_var", flat)

    def decode_logits(self, P, z):
        """Latents → NHWC logits in the compute dtype."""
        s, c = self.lay["grid"], self.lay["channels"]
        h = self._dense(P, "decoder_input", z).reshape(-1, s, s, c).permute(0, 3, 1, 2)
        for blk in self.lay["dec"] + self.lay["head"]:
            h = self._block(P, blk, h)
        y = self._conv(P, self.lay["out"][0], h, 1).permute(0, 2, 3, 1)
        f, c_in = self.lay["fold"], self.lay["in_channels"]
        if f > 1:
            b, hh, ww, _ = y.shape
            y = y.reshape(b, hh, ww, f, f, c_in).permute(0, 1, 3, 2, 4, 5).reshape(b, hh * f, ww * f, c_in)
        size, d = self.lay["image_size"], y.shape[1]
        if d != size:
            off = (d - size) // 2
            y = y[:, off : off + size, off : off + size, :]
        return y

    def forward_train(self, P, x, eps):
        """Train-mode forward with the draw ``eps``: (logits, mu, log_var).
        z = mu + eps·exp(log_var/2) in f32, rounded once, where the
        configuration fuses it (``fused``: one kernel); else in the compute
        dtype, one rounding an operation, as plain tensor operations do."""
        mu, lv = self.encode(P, x)
        if self.cfg.get("fused"):
            z = (mu.float() + eps.float() * torch.exp(0.5 * lv.float())).to(self.dt)
        else:
            z = mu + eps.to(self.dt) * torch.exp(0.5 * lv)
        return self.decode_logits(P, z), mu, lv


def elbo(logits, targets, mu, log_var, kl_weight: float):
    """(loss, reconstruction, KL) in f32."""
    l32, t32 = logits.float(), targets.float()
    log_p = (-F.softplus(-l32)).clamp_min(LOG_CLAMP)
    log_1mp = (-F.softplus(l32)).clamp_min(LOG_CLAMP)
    recon = torch.mean(-(t32 * log_p + (1.0 - t32) * log_1mp))
    mu32, lv32 = mu.float(), log_var.float()
    kl = -0.5 * torch.mean(torch.sum(1.0 + lv32 - mu32 * mu32 - torch.exp(lv32), dim=-1))
    return recon + kl_weight * kl, recon, kl


# ------------------------------------------------------------------ schedules


def _cos_anneal(start: float, end: float, pct: float) -> float:
    return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)


def _phases(total: int):
    up = max(0.3 * total - 1.0, 1.0)
    return up, max(total - up - 1.0, 1.0)


def onecycle_lr(max_lr: float, total: int, step: int) -> float:
    """torch's OneCycleLR (cosine, pct_start 0.3, div_factor 25, final_div_factor 1e4)."""
    s, (up, down) = min(step, total - 1), _phases(total)
    initial = max_lr / 25.0
    if s <= up:
        return _cos_anneal(initial, max_lr, s / up)
    return _cos_anneal(max_lr, initial / 1e4, (s - up) / down)


def onecycle_beta1(total: int, step: int) -> float:
    """OneCycle's β1 counter-cycle, 0.95 → 0.85 → 0.95."""
    s, (up, down) = min(step, total - 1), _phases(total)
    if s <= up:
        return _cos_anneal(0.95, 0.85, s / up)
    return _cos_anneal(0.85, 0.95, (s - up) / down)


def kl_weight(cfg: dict, step: int) -> float:
    kind, w = cfg.get("kl_schedule", "constant"), float(cfg["kld_weight"])
    if kind == "constant":
        return w
    if kind == "linear":
        return min(max(step / max(int(cfg["kl_warmup_steps"]), 1), 0.0), 1.0) * w
    raise ValueError(f"no reference for kl_schedule {kind!r}")


# ------------------------------------------------------------------ training


def train_steps(cfg: dict, P0: Dict[str, torch.Tensor], corpus: torch.Tensor, *, batch: int, seed: int, steps: int,
                compute: Optional[str] = None, rows: Optional[int] = None, reordered: bool = False) -> dict:
    """The first ``steps`` AdamW steps of epoch 1 from the parameters ``P0``
    over the uint8 ``corpus``: each step's loss, KL term and KL weight, the
    first step's gradients and the parameters after the last step. AdamW under OneCycle (learning rate
    ``lr_relative``·batch/128, total steps ``epochs``·(corpus // batch)),
    decoupled weight decay, ε 1e-8, β2 0.999. ``rows`` keeps only the
    first rows of each batch (and of its draw)."""
    if cfg.get("optimizer", "AdamW").lower() != "adamw" or cfg.get("scheduler", "OneCycle").lower() != "onecycle":
        raise ValueError("the reference trains with AdamW under OneCycle only")
    model = Model(cfg, compute, reordered)
    dev, n, D = corpus.device, len(corpus), int(cfg["n_features"])
    P = {k: v.detach().clone().float().requires_grad_(True) for k, v in P0.items()}
    names = list(P)
    m = {k: torch.zeros_like(P[k]) for k in names}
    v = {k: torch.zeros_like(P[k]) for k in names}
    order = frozen.train_order(seed, 1, n, batch)
    e_seed = frozen.epoch_seed(seed, 1)
    total = int(cfg["epochs"]) * (n // batch)
    max_lr = float(cfg["lr_relative"]) * batch / 128
    wd = float(cfg.get("weight_decay", 0.0))
    losses, kls, kl_weights, first_grads = [], [], [], None
    for t in range(steps):
        x = frozen.pianoroll_train_transform(corpus[torch.as_tensor(order[t], device=dev)],
                                             frozen.transform_seed(seed, 1, t))
        s = frozen.step_seed(e_seed, t)
        if cfg.get("fused"):
            eps = frozen.k3_eps((batch, D), s, dev)
        else:
            gen = torch.Generator(device=dev).manual_seed(s)
            eps = torch.randn((batch, D), generator=gen, device=dev, dtype=DTYPES[cfg["dtype"]])
        x, eps = x[:rows], eps[:rows]
        logits, mu, lv = model.forward_train(P, x, eps)
        w = kl_weight(cfg, t)
        loss, _, kl = elbo(logits, x, mu, lv, w)
        grads = torch.autograd.grad(loss, [P[k] for k in names])
        if t == 0:
            first_grads = {k: g.detach().clone() for k, g in zip(names, grads)}
        lr, b1 = onecycle_lr(max_lr, total, t), onecycle_beta1(total, t)
        with torch.no_grad():
            for k, g in zip(names, grads):
                p = P[k]
                m[k].mul_(b1).add_(g, alpha=1.0 - b1)
                v[k].mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
                p.mul_(1.0 - lr * wd)
                denom = (v[k].sqrt() / math.sqrt(1.0 - ADAM_B2 ** (t + 1))).add_(ADAM_EPS)
                p.addcdiv_(m[k], denom, value=-lr / (1.0 - b1 ** (t + 1)))
        losses.append(float(loss.detach()))
        kls.append(float(kl.detach()))
        kl_weights.append(w)
    return {"losses": losses, "kls": kls, "kl_weights": kl_weights, "first_grads": first_grads,
            "params": {k: P[k].detach() for k in names}}


"""Plain reference of Moonlight-16B-A3B's block as the stage-2 code prior
(``bench_cuda/configs/vq16_moonlight_prior.json``).

The block of ``moonshotai/Moonlight-16B-A3B``'s ``config.json``
(``model_type: deepseek_v3``), written from its equations with nothing of
the port. Each layer is h += MLA(RMSNorm(h)); h += FFN(RMSNorm(h)):

- MLA without query LoRA: ``q = W_q x`` split per head into a no-RoPE
  part and a RoPE part; ``W_kva x`` gives the latent (through its own
  RMSNorm, ``c_kv``) and one RoPE key ``k_pe`` shared by all heads;
  ``W_kvb c_kv`` gives each head's no-RoPE key and value. RoPE (θ from
  the config, no scaling) turns the adjacent pairs (2i, 2i+1) of the rope
  parts by t·θ^(−2i/d) in f32. Causal softmax at 1/√(d_nope + d_rope),
  the scores and the softmax in f32 from operands in the compute dtype,
  the probabilities rounded to it for the values; ``W_o`` back to D.
- FFN: a SwiGLU MLP (``intermediate_size``) in the first
  ``first_k_dense_replace`` layers; after them the routed experts and the
  shared SwiGLU (``n_shared_experts`` × ``moe_intermediate_size``). The
  router in f32: s = sigmoid(x W_rᵀ); the top ``num_experts_per_tok`` of
  s + b (b a buffer, no gradient); the chosen s over their sum (+1e-20)
  times ``routed_scaling_factor``. Each held expert is computed densely
  for every token and masked by the top-k, so routing is plain to read;
  the weighted outputs are summed in f32 and rounded to the compute dtype
  before the shared expert is added.
- RMSNorm with f32 statistics, a final RMSNorm, an untied head.
- Training: the loss is the mean NLL plus α·L_bal, DeepSeek-V3's
  sequence-wise balance loss (arXiv:2412.19437 §2.1.2), summed over the MoE
  layers: per sequence of T tokens, f_i = E/(k·T) Σ_t 1[i ∈ top-k_t] and
  P_i = mean_t s_{i,t}/Σ_j s_{j,t}, L_bal = mean over sequences of
  Σ_i f_i P_i over all E experts. Adam (torch's defaults, constant lr);
  after each step b_i += γ·sign(mean load − load_i) in each MoE layer,
  the loads of all E experts over the step's tokens.

Departures from the published model, each as the port's prior has them:

- the expert share: the router keeps all ``n_routed_experts_published``
  outputs and its top-k, but only the experts ``experts_held`` of each
  layer are computed, and what the others would add is left out;
- the vocabulary is the stage-1 codebook's ``vocab_size`` codes, and the
  sequence is the code grid's ``grid²`` positions in raster order;
- a learned BOS shifted in on the right (position t sees codes before t)
  and, for a class-conditional prior, a learned class embedding added to
  every token.

``compute``: ``float32``, ``bfloat16`` or ``fp8`` (bfloat16 with every
matmul's operands rounded to float8 e4m3, one scale a tensor, as
``reference/vae.py``); the parameters stay f32. ``reordered=True``
computes the same model in another order: RMSNorm statistics and the
attention scores in f64, the experts summed last to first, other chunks of
sequences. Batches run in chunks of sequences (every term is a mean over
sequences or tokens, so the chunks' weighted sum is the batch's), so
that the dense experts fit.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from bench_cuda.reference.vae import _Fp8

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
CHUNK = 32  # sequences a chunk
REORDERED_CHUNK = 16


def shape(cfg: dict) -> dict:
    """The sizes the reference reads from a configuration file."""
    p = cfg["prior"]
    lo, hi = (int(v) for v in str(p["experts_held"]).split(":"))
    return {"d": int(cfg["hidden_size"]), "heads": int(cfg["num_attention_heads"]),
            "nope": int(cfg["qk_nope_head_dim"]), "rope": int(cfg["qk_rope_head_dim"]), "dv": int(cfg["v_head_dim"]),
            "lora": int(cfg["kv_lora_rank"]), "dense": int(cfg["intermediate_size"]),
            "expert": int(cfg["moe_intermediate_size"]), "experts": int(cfg["n_routed_experts_published"]),
            "shared": int(cfg["n_shared_experts"]), "top_k": int(cfg["num_experts_per_tok"]),
            "scale": float(cfg["routed_scaling_factor"]), "theta": float(cfg["rope_theta"]),
            "eps": float(cfg["rms_norm_eps"]), "first_dense": int(cfg["first_k_dense_replace"]),
            "layers": int(cfg["num_hidden_layers"]), "codes": int(cfg["vocab_size"]), "grid": int(p["grid"]),
            "classes": int(p.get("num_classes", 0)), "lo": lo, "hi": hi}


def spec(cfg: dict):
    """(parameters, buffers): (name, shape, init) in the port's names; init
    ``xavier`` (fans of an [out, in] matrix, of each expert's for a stack),
    ``ones``, ``bos`` (0.02 · N(0, 1)) or ``zeros``."""
    s = shape(cfg)
    d, h, held = s["d"], s["heads"], s["hi"] - s["lo"]
    params = [("embed", (s["codes"], d), "xavier"), ("bos", (d,), "bos")]
    if s["classes"]:
        params.append(("class_embed", (s["classes"], d), "xavier"))
    buffers = []
    for i in range(s["layers"]):
        pre = f"layers.{i}."
        params += [(pre + "attn_norm.weight", (d,), "ones"),
                   (pre + "attn.q_proj.weight", (h * (s["nope"] + s["rope"]), d), "xavier"),
                   (pre + "attn.kv_a_proj.weight", (s["lora"] + s["rope"], d), "xavier"),
                   (pre + "attn.kv_a_norm.weight", (s["lora"],), "ones"),
                   (pre + "attn.kv_b_proj.weight", (h * (s["nope"] + s["dv"]), s["lora"]), "xavier"),
                   (pre + "attn.o_proj.weight", (d, h * s["dv"]), "xavier"),
                   (pre + "ffn_norm.weight", (d,), "ones")]
        if i < s["first_dense"]:
            w = s["dense"]
            params += [(pre + "ffn.gate_proj.weight", (w, d), "xavier"), (pre + "ffn.up_proj.weight", (w, d), "xavier"),
                       (pre + "ffn.down_proj.weight", (d, w), "xavier")]
        else:
            w, ws = s["expert"], s["expert"] * s["shared"]
            params += [(pre + "ffn.gate_proj", (held, w, d), "xavier"), (pre + "ffn.up_proj", (held, w, d), "xavier"),
                       (pre + "ffn.down_proj", (held, d, w), "xavier"),
                       (pre + "ffn.router.weight", (s["experts"], d), "xavier"),
                       (pre + "ffn.shared.gate_proj.weight", (ws, d), "xavier"),
                       (pre + "ffn.shared.up_proj.weight", (ws, d), "xavier"),
                       (pre + "ffn.shared.down_proj.weight", (d, ws), "xavier")]
            buffers.append((pre + "ffn.router.bias", (s["experts"],), "zeros"))
    params += [("norm.weight", (d,), "ones"), ("head.weight", (s["codes"], d), "xavier")]
    return params, buffers


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """name → f32 tensor on ``device`` for every parameter of :func:`spec`,
    drawn from one generator seeded with ``seed``."""
    params, _ = spec(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    for name, shp, init in params:
        if init == "xavier":
            fan_out, fan_in = shp[-2], shp[-1]
            bound = math.sqrt(6.0 / (fan_in + fan_out))
            out[name] = (torch.rand(shp, generator=gen, device=device) * 2.0 - 1.0) * bound
        elif init == "bos":
            out[name] = 0.02 * torch.randn(shp, generator=gen, device=device)
        elif init == "ones":
            out[name] = torch.ones(shp, device=device)
        else:
            raise ValueError(f"unknown init {init!r} for {name}")
    return out


def zero_bias(cfg: dict, device) -> Dict[str, torch.Tensor]:
    return {name: torch.zeros(shp, device=device) for name, shp, _ in spec(cfg)[1]}


class Model:
    """The reference prior of ``cfg`` in ``compute`` precision; ``reordered``: in another order."""

    def __init__(self, cfg: dict, compute: Optional[str] = None, reordered: bool = False):
        self.s = shape(cfg)
        compute = compute or cfg["prior"]["dtype"]
        self.fp8 = compute == "fp8"
        self.dt = torch.bfloat16 if self.fp8 else DTYPES[compute]
        self.reordered = reordered

    def _op(self, t):
        t = t.to(self.dt)
        return _Fp8.apply(t) if self.fp8 else t

    def _lin(self, x, w):
        return F.linear(self._op(x), self._op(w))

    def _rms(self, x, w):
        x32 = x.double() if self.reordered else x.float()
        r = torch.rsqrt(x32.square().mean(-1, keepdim=True) + self.s["eps"])
        return (x32 * r).float().mul(w).to(self.dt)

    def _rope(self, x, length):
        d = x.shape[-1]
        inv = 1.0 / self.s["theta"] ** (torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d)
        ang = torch.arange(length, dtype=torch.float64, device=x.device)[:, None] * inv[None]
        c, s = torch.cos(ang).float()[None, :, None, :], torch.sin(ang).float()[None, :, None, :]
        xp = x.float().reshape(*x.shape[:-1], d // 2, 2)
        return torch.stack((xp[..., 0] * c - xp[..., 1] * s, xp[..., 0] * s + xp[..., 1] * c), -1).reshape(x.shape).to(x.dtype)

    def _attention(self, P, pre, x):
        s = self.s
        b, length, _ = x.shape
        h, nope, rd, dv, lora = s["heads"], s["nope"], s["rope"], s["dv"], s["lora"]
        q = self._lin(x, P[pre + "q_proj.weight"]).reshape(b, length, h, nope + rd)
        kva = self._lin(x, P[pre + "kv_a_proj.weight"])
        c_kv = self._rms(kva[..., :lora], P[pre + "kv_a_norm.weight"])
        k_pe = kva[..., lora:].reshape(b, length, 1, rd)
        kv = self._lin(c_kv, P[pre + "kv_b_proj.weight"]).reshape(b, length, h, nope + dv)
        q_pe = q[..., nope:]
        q_pe, k_pe = self._rope(q_pe, length), self._rope(k_pe, length)
        q = torch.cat([q[..., :nope], q_pe], -1).transpose(1, 2)
        k = torch.cat([kv[..., :nope], k_pe.expand(b, length, h, rd)], -1).transpose(1, 2)
        v = kv[..., nope:].transpose(1, 2)
        acc = torch.float64 if self.reordered else torch.float32
        scores = (self._op(q).to(acc) @ self._op(k).to(acc).transpose(-1, -2)) * (nope + rd) ** -0.5
        causal = torch.ones(length, length, dtype=torch.bool, device=x.device).tril()
        p = torch.softmax(scores.masked_fill(~causal, -math.inf), dim=-1).float()
        o = (self._op(p).float() @ self._op(v).float()).to(self.dt)
        return self._lin(o.transpose(1, 2).reshape(b, length, h * dv), P[pre + "o_proj.weight"])

    def _swiglu(self, x, gate, up, down):
        return self._lin(F.silu(self._lin(x, gate)) * self._lin(x, up), down)

    def _moe(self, P, B, pre, x, seqs):
        """(output, balance term, loads [E], top-k [T, k]) of one MoE layer over [T, D] tokens."""
        s = self.s
        e, k = s["experts"], s["top_k"]
        scores = torch.sigmoid(F.linear(x.float(), P[pre + "router.weight"]))
        top = torch.topk(scores.detach() + B[pre + "router.bias"], k, dim=-1).indices
        w = scores.gather(1, top)
        w = w / (w.sum(-1, keepdim=True) + 1e-20) * s["scale"]
        hits = F.one_hot(top, e).sum(1).float()  # [T, E]
        f = hits.reshape(seqs, -1, e).mean(1) * (e / k)
        pr = (scores / scores.sum(-1, keepdim=True)).reshape(seqs, -1, e).mean(1)
        aux = (f * pr).sum(-1).mean()
        acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        order = range(s["hi"] - s["lo"])
        for j in (reversed(order) if self.reordered else order):
            wj = (w * (top == s["lo"] + j)).sum(-1)  # 0 where the token did not choose expert lo + j
            y = self._swiglu(x, P[pre + "gate_proj"][j], P[pre + "up_proj"][j], P[pre + "down_proj"][j])
            acc = acc + y.float() * wj[:, None]
        shared = self._swiglu(x, P[pre + "shared.gate_proj.weight"], P[pre + "shared.up_proj.weight"],
                              P[pre + "shared.down_proj.weight"])
        return acc.to(self.dt) + shared, aux, hits.sum(0), top

    def forward(self, P, B, idx, y=None):
        """[b, s, s] codes → (logits [b, s, s, K] in the compute dtype, the
        balance loss summed over the MoE layers, loads [n_moe, E], top-k
        per MoE layer)."""
        s = self.s
        b, s1, s2 = idx.shape
        length = s1 * s2
        h = F.embedding(idx.reshape(b, length).long(), P["embed"].to(self.dt))
        h = torch.cat([P["bos"].to(self.dt).expand(b, 1, -1), h[:, :-1]], dim=1)
        if s["classes"]:
            h = h + F.embedding(y.long(), P["class_embed"].to(self.dt))[:, None, :]
        auxes, loads, tops = [], [], []
        for i in range(s["layers"]):
            pre = f"layers.{i}."
            h = h + self._attention(P, pre + "attn.", self._rms(h, P[pre + "attn_norm.weight"]))
            x = self._rms(h, P[pre + "ffn_norm.weight"])
            if i < s["first_dense"]:
                h = h + self._swiglu(x, P[pre + "ffn.gate_proj.weight"], P[pre + "ffn.up_proj.weight"],
                                     P[pre + "ffn.down_proj.weight"])
                continue
            out, aux, load, top = self._moe(P, B, pre + "ffn.", x.reshape(b * length, -1), b)
            h = h + out.reshape(h.shape)
            auxes.append(aux)
            loads.append(load)
            tops.append(top)
        logits = self._lin(self._rms(h, P["norm.weight"]), P["head.weight"]).reshape(b, s1, s2, s["codes"])
        aux = torch.stack(auxes).sum() if auxes else logits.new_zeros((), dtype=torch.float32)
        return logits, aux, (torch.stack(loads) if loads else None), tops


def nll(logits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Mean NLL (nats a position) in f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, idx.long()[..., None]).mean()


def train_steps(cfg: dict, P0: Dict[str, torch.Tensor], batches: List[torch.Tensor], *, steps: int,
                compute: Optional[str] = None, reordered: bool = False, labels: Optional[List[torch.Tensor]] = None,
                lr: Optional[float] = None) -> dict:
    """The first ``steps`` Adam steps from ``P0`` (routing biases zero) on
    the code grids ``batches[t]``: each step's NLL (``losses``) and balance
    loss (``kls``, as the check reads it) and the balance weight
    (``kl_weights``), the first step's gradients, the parameters and the
    routing biases (``bias``) after the last step, and each MoE layer's
    top-k of step 1 (``routes1``)."""
    p = cfg["prior"]
    alpha, gamma = float(p["balance_alpha"]), float(p["bias_gamma"])
    lr = float(p["lr"]) if lr is None else lr
    model = Model(cfg, compute, reordered)
    P = {k: v.detach().clone().float().requires_grad_(True) for k, v in P0.items()}
    dev = next(iter(P.values())).device
    B = zero_bias(cfg, dev)
    names = list(P)
    m = {k: torch.zeros_like(P[k]) for k in names}
    v = {k: torch.zeros_like(P[k]) for k in names}
    chunk = REORDERED_CHUNK if reordered else CHUNK
    losses, auxes, first_grads, routes1 = [], [], None, None
    for t in range(steps):
        idx = batches[t]
        n = idx.shape[0]
        grads = {k: torch.zeros_like(P[k]) for k in names}
        loss_t, aux_t, loads, tops = 0.0, 0.0, None, []
        for c0 in range(0, n, chunk):
            part = idx[c0:c0 + chunk]
            share = part.shape[0] / n
            yc = labels[t][c0:c0 + chunk] if labels is not None else None
            logits, aux, load, top = model.forward(P, B, part, yc)
            nl = nll(logits, part)
            g = torch.autograd.grad((nl + alpha * aux) * share, [P[k] for k in names], allow_unused=True)
            for k, gk in zip(names, g):
                if gk is not None:
                    grads[k] += gk
            loss_t += float(nl.detach()) * share
            aux_t += float(aux.detach()) * share
            loads = load if loads is None else loads + load
            tops.append(top)
        if t == 0:
            first_grads = {k: g.detach().clone() for k, g in grads.items()}
            routes1 = [torch.cat([c[i] for c in tops]) for i in range(len(tops[0]))] if tops and tops[0] else []
        with torch.no_grad():
            for k in names:
                m[k].mul_(ADAM_B1).add_(grads[k], alpha=1.0 - ADAM_B1)
                v[k].mul_(ADAM_B2).addcmul_(grads[k], grads[k], value=1.0 - ADAM_B2)
                denom = (v[k].sqrt() / math.sqrt(1.0 - ADAM_B2 ** (t + 1))).add_(ADAM_EPS)
                P[k].addcdiv_(m[k], denom, value=-lr / (1.0 - ADAM_B1 ** (t + 1)))
            if loads is not None:
                for name, load in zip(B, loads):
                    B[name] = B[name] + gamma * torch.sign(load.mean() - load)
        losses.append(loss_t)
        auxes.append(aux_t)
    return {"losses": losses, "kls": auxes, "kl_weights": [alpha] * steps, "first_grads": first_grads,
            "params": {k: P[k].detach() for k in names}, "bias": B, "routes1": routes1}

"""Moonlight-16B-A3B's decoder block as a stage-2 code prior.

:class:`MoonlightPrior` maps ``[B, s, s]`` code grids (and, when
class-conditional, int labels ``y`` [B]) to next-code logits
``[B, s, s, K]``, like the priors of ``models/prior.py``: raster order, a
learned BOS shifted in on the right (the logits at position t see codes
0..t−1 only), and a learned per-class embedding added to every token of a
conditional prior. Positions come from RoPE, not from a learned table.

The block is that of ``moonshotai/Moonlight-16B-A3B``'s ``config.json``
(``model_type: deepseek_v3``); :data:`MOONLIGHT` holds its published
widths. With D the hidden size and H the heads, each layer is

    h = h + MLA(RMSNorm(h));   h = h + FFN(RMSNorm(h))

- **MLA** (multi-head latent attention, no query LoRA): ``q = W_q x``
  split per head into ``q_nope`` [128] and ``q_pe`` [64]; ``W_kva x``
  gives [512 + 64], whose 512 part goes through its own RMSNorm to
  ``c_kv`` and whose 64 part is ``k_pe``, one for all heads;
  ``W_kvb c_kv`` gives ``k_nope`` [128] and ``v`` [128] a head. RoPE
  (θ 50,000, no scaling) turns ``q_pe`` and ``k_pe`` only. Causal
  softmax attention over query–key heads of 192 at scale 1/√192, values
  of 128; ``W_o`` maps [H·128] back to D. On a card the attention is
  ``scaled_dot_product_attention`` pinned to its memory-efficient
  backend: the flash backend needs equal query and value head sizes
  (192 ≠ 128) and would pay a value padded to 192; the memory-efficient
  one takes them as they are and, like flash, never writes the [L, L]
  scores (the math backend stays allowed for shapes it refuses).
  Elsewhere torch picks the backend.
- **FFN**: the first ``first_k_dense_replace`` layers a SwiGLU MLP
  ``W_down(silu(W_gate x) · W_up x)`` of width 11,264; every later layer a
  mixture of experts (:class:`MoE`): 64 routed SwiGLU experts of width
  1,408 and one shared SwiGLU of width 2 × 1,408. The router is f32:
  ``s = sigmoid(x W_rᵀ)``; the top 6 by ``s + b``, ``b`` a bias buffer
  that no gradient moves (``noaux_tc``; one group, so no group limit);
  the chosen ``s`` normalised to sum 1 and times 2.446.
- RMSNorm ε 1e-5, statistics in f32; a final RMSNorm and an untied head.

**RoPE's pairing.** The 64 rope dimensions rotate in adjacent pairs
(2i, 2i+1) by the angle t·θ^(−2i/64), i = 0..31, t the position 0..L−1
(the BOS at 0), in f32. DeepSeek-V3's reference code de-interleaves the
pairs before its rotate-half, which permutes ``q_pe`` and ``k_pe`` alike
and leaves every score as here.

**The expert share.** An :class:`MoE` is told which routed experts it
holds, ``held = range(lo, hi)``, the share of one chip when several chips
divide a layer's experts between them. It routes every token over all 64
experts, with the bias, and computes ``shared(x) + Σ_{i ∈ top-6 ∩ held}
w_i E_i(x)``; what the other experts would add is left out, and no code
stands in for the absent chips or their exchange.

**Dispatch** reads nothing back to the host. One assignment slot at a
time (a token's first, second, ... chosen expert), the tokens whose
choice is a held expert are sorted by expert, each expert's rows padded
to a multiple of 16, in a buffer sized for the worst case (every token's
choice held here); one grouped GEMM (``torch._grouped_mm``) a projection
computes each expert over its own rows only; the rows are weighted in
f32 and summed back by ``index_add_``. Rows past the last group are never
written by the GEMM: their values are masked, and so are their
gradients. In training the held experts' part is recomputed in the
backward (``torch.utils.checkpoint``), so no buffer is kept between the
passes.

Parameters are f32; compute runs in ``dtype`` with f32 parameters cast at
use, as ``Dense`` does; the router, the routing weights and the combine
run in f32. Training adds DeepSeek-V3's sequence-wise balance loss
(:meth:`MoonlightPrior.forward_train`) and its bias update
(:meth:`MoonlightPrior.update_routing_bias`), arXiv:2412.19437 §2.1.2.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from midi_vae_tpu_torch.io import tracing
from midi_vae_tpu_torch.models.vae import _xavier

GROUP_ROWS = 16  # each held expert's rows are padded to a multiple of this (and to at least this)
BALANCE_ALPHA = 1e-4  # the balance loss's weight (DeepSeek-V3's paper; the config gives none)
BIAS_GAMMA = 1e-3  # the routing bias's update speed (the same)


@dataclass(frozen=True)
class MoonlightWidths:
    """The block's published widths (Moonlight-16B-A3B ``config.json``,
    under its own key names); the depth kept is the prior's own argument."""

    hidden_size: int = 2048
    num_attention_heads: int = 16
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    kv_lora_rank: int = 512
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    routed_scaling_factor: float = 2.446
    rope_theta: float = 50000.0
    rms_norm_eps: float = 1e-5
    first_k_dense_replace: int = 1


MOONLIGHT = MoonlightWidths()


def parse_held(text: str, n_experts: int) -> Tuple[int, int]:
    """``"lo:hi"`` → (lo, hi), a non-empty slice of ``range(n_experts)``."""
    try:
        lo, hi = (int(v) for v in str(text).split(":"))
    except ValueError:
        raise ValueError(f"held experts must read lo:hi, got {text!r}") from None
    if not 0 <= lo < hi <= n_experts:
        raise ValueError(f"held experts {lo}:{hi} are not a non-empty slice of the {n_experts} experts")
    return lo, hi


class Linear(nn.Module):
    """A bias-free dense layer: ``weight`` [out, in] in f32 (Xavier-uniform,
    as ``Dense``), applied in ``dtype``."""

    def __init__(self, in_features: int, features: int, *, dtype, generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(_xavier(torch.empty(features, in_features), generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype))


class RMSNorm(nn.Module):
    """``x / √(mean(x²) + ε) · w`` with the statistics and the product in
    f32, returned in ``dtype``."""

    def __init__(self, features: int, eps: float, *, dtype):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        return (x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + self.eps) * self.weight).to(self.dtype)


def rope_tables(length: int, dim: int, theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 cos and sin [length, dim / 2] of the angles t·θ^(−2i/dim)."""
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    ang = torch.arange(length, dtype=torch.float64)[:, None] * inv[None]
    return torch.cos(ang).float(), torch.sin(ang).float()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Turn ``x`` [B, L, heads, d] by position: the pairs (2i, 2i+1) of its
    last dimension, in f32, returned in ``x``'s dtype."""
    b, length, h, d = x.shape
    xp = x.float().reshape(b, length, h, d // 2, 2)
    x0, x1 = xp[..., 0], xp[..., 1]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.stack((x0 * c - x1 * s, x0 * s + x1 * c), dim=-1).reshape(b, length, h, d).to(x.dtype)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Causal softmax attention of [B, H, L, d] heads; on a card the
    memory-efficient backend (see the module docstring)."""
    if q.is_cuda:
        from torch.nn.attention import SDPBackend, sdpa_kernel

        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH]):  # math only where the other refuses
            return F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=scale)
    return F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=scale)


class MLA(nn.Module):
    """Multi-head latent attention without query LoRA (module docstring)."""

    def __init__(self, w: MoonlightWidths, *, dtype, generator: torch.Generator):
        super().__init__()
        d, h = w.hidden_size, w.num_attention_heads
        self.heads, self.nope, self.rope_dim, self.v_dim = h, w.qk_nope_head_dim, w.qk_rope_head_dim, w.v_head_dim
        self.lora = w.kv_lora_rank
        self.scale = (self.nope + self.rope_dim) ** -0.5
        kw = dict(dtype=dtype, generator=generator)
        self.q_proj = Linear(d, h * (self.nope + self.rope_dim), **kw)
        self.kv_a_proj = Linear(d, self.lora + self.rope_dim, **kw)
        self.kv_a_norm = RMSNorm(self.lora, w.rms_norm_eps, dtype=dtype)
        self.kv_b_proj = Linear(self.lora, h * (self.nope + self.v_dim), **kw)
        self.o_proj = Linear(h * self.v_dim, d, **kw)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        """[B, L, D] → [B, L, D], the rope parts turned by ``cos``/``sin`` [L, d_rope / 2]."""
        b, length, _ = x.shape
        h = self.heads
        with tracing.span("prior.attention"):
            q = self.q_proj(x).reshape(b, length, h, self.nope + self.rope_dim)
            q_nope, q_pe = q.split([self.nope, self.rope_dim], dim=-1)
            c_kv, k_pe = self.kv_a_proj(x).split([self.lora, self.rope_dim], dim=-1)
            kv = self.kv_b_proj(self.kv_a_norm(c_kv)).reshape(b, length, h, self.nope + self.v_dim)
            k_nope, v = kv.split([self.nope, self.v_dim], dim=-1)
            k_pe = k_pe.reshape(b, length, 1, self.rope_dim)
            q_pe, k_pe = apply_rope(q_pe, cos, sin), apply_rope(k_pe, cos, sin)
            q = torch.cat([q_nope, q_pe], dim=-1).transpose(1, 2)
            k = torch.cat([k_nope, k_pe.expand(b, length, h, self.rope_dim)], dim=-1).transpose(1, 2)
            o = causal_attention(q, k, v.transpose(1, 2), self.scale)
            return self.o_proj(o.transpose(1, 2).reshape(b, length, h * self.v_dim))


class SwiGLU(nn.Module):
    """``W_down(silu(W_gate x) · W_up x)``, bias-free, in ``dtype``."""

    def __init__(self, d: int, width: int, *, dtype, generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.gate_proj, self.up_proj, self.down_proj = Linear(d, width, **kw), Linear(d, width, **kw), Linear(width, d, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Router(nn.Module):
    """f32 sigmoid scores over all experts and the top-k by scores plus the
    ``bias`` buffer (no gradient moves it; :meth:`MoonlightPrior.update_routing_bias` does)."""

    def __init__(self, d: int, n_experts: int, top_k: int, *, generator: torch.Generator):
        super().__init__()
        self.top_k = top_k
        self.weight = nn.Parameter(_xavier(torch.empty(n_experts, d), generator))
        self.register_buffer("bias", torch.zeros(n_experts))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """[T, D] → (f32 scores [T, E], top-k indices [T, k])."""
        scores = torch.sigmoid(F.linear(x.float(), self.weight))
        return scores, torch.topk(scores.detach() + self.bias, self.top_k, dim=-1).indices


def grouped_linear(x: torch.Tensor, w: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """Rows ``[ends[g−1], ends[g])`` of ``x`` [R, in] times ``w[g]ᵀ`` ([G, out,
    in]) for each group g: [R, out], rows from ``ends[−1]`` on unwritten."""
    return torch._grouped_mm(x, w.transpose(-2, -1), offs=ends.to(torch.int32))


class _KeepGrad(torch.autograd.Function):
    """The identity; backward, the gradient of the rows outside ``keep`` is zeroed."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(keep)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (keep,) = ctx.saved_tensors
        return torch.where(keep[:, None], g, 0), None


def dispatch(expert: torch.Tensor, w: torch.Tensor, n: int):
    """Buffer rows for one assignment a token, without a host read:
    ``expert`` [T] its held expert (n: not held here), ``w`` [T] its f32
    weight. Returns (row_token [R], row_w [R], the groups' ends [n]):
    the assignments sorted by expert, each expert's rows padded to a
    multiple of :data:`GROUP_ROWS`, in a buffer of R = T + n·16 + 1 rows
    (every token here, and one row more: the groups end before the buffer
    does). A row no assignment fills holds weight 0 and any token (r mod
    T, so that no token's gradient gathers from many rows)."""
    t, dev = expert.shape[0], expert.device
    counts = torch.zeros(n + 1, dtype=torch.int64, device=dev).scatter_add_(0, expert, torch.ones_like(expert))
    sizes = ((counts[:n] + GROUP_ROWS - 1) // GROUP_ROWS).clamp_min(1) * GROUP_ROWS
    ends = torch.cumsum(sizes, 0)
    first = torch.cumsum(counts, 0) - counts  # each expert's first place in the sorted order
    order = torch.argsort(expert, stable=True)
    e_sorted = expert[order]
    e_c = e_sorted.clamp_max(n - 1)
    rows = t + n * GROUP_ROWS + 1
    dest = (ends - sizes)[e_c] + torch.arange(t, device=dev) - first[e_c]
    dest = torch.where(e_sorted < n, dest, rows)  # the assignments of other experts: a slot cut off below
    row_token = (torch.arange(rows + 1, device=dev) % t).index_put_((dest,), order)
    row_w = torch.zeros(rows + 1, dtype=torch.float32, device=dev).index_put((dest,), w[order])
    return row_token[:rows], row_w[:rows], ends


def held_experts(x: torch.Tensor, expert: torch.Tensor, w: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
                 down: torch.Tensor) -> torch.Tensor:
    """f32 [T, D]: for each of ``x``'s T tokens the sum of ``w[t, j] ·
    E(x_t)`` over its assignments j to held experts (``expert`` [T, k]
    local indices, n where not held here), one assignment slot at a time
    (:func:`dispatch`), so the buffers hold T rows, not T·k."""
    t, d = x.shape
    n, dt = gate.shape[0], x.dtype
    gate, up, down = gate.to(dt), up.to(dt), down.to(dt)
    acc = torch.zeros(t, d, dtype=torch.float32, device=x.device)
    for j in range(expert.shape[1]):
        row_token, row_w, ends = dispatch(expert[:, j], w[:, j], n)
        # rows past the last group are never written by the GEMM: their values and gradients are dropped
        keep = torch.arange(row_token.shape[0], device=x.device) < ends[-1]
        rows = _KeepGrad.apply(x[row_token], keep)
        mid = F.silu(grouped_linear(rows, gate, ends)) * grouped_linear(rows, up, ends)
        y = torch.where(keep[:, None], grouped_linear(mid, down, ends), 0)
        acc = acc.index_add(0, row_token, y * row_w[:, None])  # the product in f32, as type promotion takes it
    return acc


class MoE(nn.Module):
    """Routed experts ``held`` of ``n_routed_experts``, and the shared
    expert (module docstring)."""

    def __init__(self, w: MoonlightWidths, held: Tuple[int, int], *, dtype, generator: torch.Generator):
        super().__init__()
        d, width = w.hidden_size, w.moe_intermediate_size
        self.lo, self.hi = held
        n = self.hi - self.lo
        self.n_experts, self.scale, self.dtype = w.n_routed_experts, w.routed_scaling_factor, dtype
        self.router = Router(d, w.n_routed_experts, w.num_experts_per_tok, generator=generator)

        def stacked(out_f, in_f):
            return nn.Parameter(torch.stack([_xavier(torch.empty(out_f, in_f), generator) for _ in range(n)]))

        self.gate_proj, self.up_proj, self.down_proj = stacked(width, d), stacked(width, d), stacked(d, width)
        self.shared = SwiGLU(d, width * w.n_shared_experts, dtype=dtype, generator=generator)

    def route(self, x: torch.Tensor, seqs: int, want_aux: bool):
        """(top-k indices [T, k], their f32 weights, the balance term of
        this call (0 unless ``want_aux``), the loads of all experts [E]
        in f32, and [held assignments, largest held expert's])."""
        scores, top = self.router(x)
        t, k, e = x.shape[0], top.shape[1], self.n_experts
        w = scores.gather(1, top)
        w = w / (w.sum(-1, keepdim=True) + 1e-20) * self.scale
        hits = torch.zeros(t, e, device=x.device).scatter_(1, top, 1.0)
        loads = hits.sum(0)
        aux = x.new_zeros((), dtype=torch.float32)
        if want_aux:  # DeepSeek-V3's sequence-wise balance term, averaged over the sequences
            f = hits.reshape(seqs, -1, e).mean(1) * (e / k)
            p = (scores / scores.sum(-1, keepdim=True)).reshape(seqs, -1, e).mean(1)
            aux = (f * p).sum(-1).mean()
        held = loads[self.lo:self.hi]
        return top, w, aux, loads, torch.stack([held.sum(), held.max()])

    def forward(self, h: torch.Tensor, want_aux: bool = False):
        """[B, L, D] → ([B, L, D], balance term, loads [E], held stats [2]); see :meth:`route`."""
        b, length, d = h.shape
        x = h.reshape(b * length, d)
        tracing.count("moe.calls", 1)
        tracing.count("moe.assignments", b * length * self.router.top_k)
        with tracing.span("prior.moe.route"):
            top, w, aux, loads, held = self.route(x, b, want_aux)
        with tracing.span("prior.moe.experts"):
            local = top - self.lo
            n = self.hi - self.lo
            expert = torch.where((local >= 0) & (local < n), local, n)
            args = (x, expert, w, self.gate_proj, self.up_proj, self.down_proj)
            if torch.is_grad_enabled():
                routed = torch.utils.checkpoint.checkpoint(held_experts, *args, use_reentrant=False)
            else:
                routed = held_experts(*args)
            out = routed.to(h.dtype) + self.shared(x)
        return out.reshape(b, length, d), aux, loads, held


class Block(nn.Module):
    """Pre-norm decoder layer: MLA, then the dense MLP or the :class:`MoE`."""

    def __init__(self, w: MoonlightWidths, dense: bool, held: Tuple[int, int], *, dtype, generator):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.attn_norm = RMSNorm(w.hidden_size, w.rms_norm_eps, dtype=dtype)
        self.attn = MLA(w, **kw)
        self.ffn_norm = RMSNorm(w.hidden_size, w.rms_norm_eps, dtype=dtype)
        self.ffn = SwiGLU(w.hidden_size, w.intermediate_size, **kw) if dense else MoE(w, held, **kw)

    def forward(self, h, cos, sin, want_aux: bool):
        h = h + self.attn(self.attn_norm(h), cos, sin)
        if isinstance(self.ffn, MoE):
            f, aux, loads, held = self.ffn(self.ffn_norm(h), want_aux)
            return h + f, (aux, loads, held)
        return h + self.ffn(self.ffn_norm(h)), None


class MoonlightPrior(nn.Module):
    """Decoder-only prior over raster-ordered ``[grid, grid]`` code grids
    built from Moonlight-16B-A3B's block (module docstring): ``num_layers``
    layers of widths ``widths``, the routed experts ``held`` of each MoE
    layer."""

    def __init__(self, num_codes: int = 512, num_layers: int = 5, num_classes: int = 0, dtype=torch.float32, *,
                 grid: int, held: Optional[Sequence[int]] = None, widths: MoonlightWidths = MOONLIGHT,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.num_codes, self.num_layers, self.num_classes, self.dtype = num_codes, num_layers, num_classes, dtype
        self.widths = widths
        self.held = tuple(held) if held is not None else (0, widths.n_routed_experts)
        parse_held(f"{self.held[0]}:{self.held[1]}", widths.n_routed_experts)
        d = widths.hidden_size
        self.embed = nn.Parameter(_xavier(torch.empty(num_codes, d), gen))
        self.bos = nn.Parameter(0.02 * torch.randn(d, generator=gen))
        if num_classes > 0:
            self.class_embed = nn.Parameter(_xavier(torch.empty(num_classes, d), gen))
        self.layers = nn.ModuleList(
            Block(widths, i < widths.first_k_dense_replace, self.held, dtype=dtype, generator=gen)
            for i in range(num_layers))
        self.norm = RMSNorm(d, widths.rms_norm_eps, dtype=dtype)
        self.head = Linear(d, num_codes, dtype=dtype, generator=gen)
        cos, sin = rope_tables(grid * grid, widths.qk_rope_head_dim, widths.rope_theta)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    def moe_layers(self):
        return [blk.ffn for blk in self.layers if isinstance(blk.ffn, MoE)]

    def _run(self, idx: torch.Tensor, y: Optional[torch.Tensor], want_aux: bool):
        if self.num_classes > 0 and y is None:
            raise ValueError(f"this MoonlightPrior is class-conditional over {self.num_classes} classes; "
                             "forward needs int labels y [B]")
        b, s1, s2 = idx.shape
        length, dt = s1 * s2, self.dtype
        h = F.embedding(idx.reshape(b, length).long(), self.embed.to(dt))
        # shift right: the logits at position t see [BOS, x_0 .. x_{t-1}]
        h = torch.cat([self.bos.to(dt).expand(b, 1, -1), h[:, :-1]], dim=1)
        if self.num_classes > 0:
            h = h + F.embedding(y.long(), self.class_embed.to(dt))[:, None, :]
        cos, sin = self.rope_cos[:length], self.rope_sin[:length]
        moe = []
        for blk in self.layers:
            h, stats = blk(h, cos, sin, want_aux)
            if stats is not None:
                moe.append(stats)
        return self.head(self.norm(h)).reshape(b, s1, s2, self.num_codes), moe

    def forward(self, idx: torch.Tensor, y: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, s, s] int codes → [B, s, s, K] next-code logits."""
        return self._run(idx, y, False)[0]

    def forward_train(self, idx: torch.Tensor, y: Optional[torch.Tensor] = None):
        """(logits, the balance loss summed over the MoE layers, the
        layers' expert loads [n_moe, E], [held assignments, the sum over
        layers of the largest held expert's]), all on the device."""
        logits, moe = self._run(idx, y, True)
        if not moe:
            zero = logits.new_zeros((), dtype=torch.float32)
            return logits, zero, logits.new_zeros((0, self.widths.n_routed_experts), dtype=torch.float32), \
                torch.stack([zero, zero])
        aux, loads, held = zip(*moe)
        return logits, torch.stack(aux).sum(), torch.stack(loads), torch.stack(held).sum(0)

    @torch.no_grad()
    def update_routing_bias(self, loads: torch.Tensor, gamma: float = BIAS_GAMMA) -> None:
        """``b_i += γ · sign(mean load − load_i)`` in each MoE layer, from the
        loads [n_moe, E] of all experts in the step that just ran."""
        for layer, load in zip(self.moe_layers(), loads):
            layer.router.bias.add_(gamma * torch.sign(load.mean() - load))

"""The model's encoder and decoder as CUDA graphs inside the train step.

On the single-rank path of ``train/state.py`` ``make_train_step`` (no
mesh, no gradient accumulation, no injected draw), a step whose model
sits on a CUDA device runs ``model.encode(x, True)`` and
``model.decode_logits(z, True)``, forward and backward, as four CUDA
graph replays. What lies between and after them stays eager, as in the
eager step: the reparameterization (K3 with its host seed), the loss
(K1/K2 on the fused path), ``zero_grad``, the gradient norm, the clip,
the optimizer with its host learning rate, and EMA. A replay launches
the kernels the eager encoder or decoder launches, in the same order on
the same tensors, so the step computes the same numbers; the host pays
for one graph launch where it paid for ~270 kernel launches.

:meth:`StepGraphs.engages` says when, from what the model shows: its
parameters on a CUDA device, Gaussian latents, the stock forward
(``VanillaVAE.forward``: encode, reparameterize, decode), no ``remat``,
no ``verbose``, no module hooks (global or on any submodule), autograd's
anomaly mode off. Everything else runs the eager forward.

Captures are kept per input key (shape, strides and dtype of the batch
and of the labels) and made at the first step that has the key, so that
step already replays: a half batch or another resolution captures once
more. A capture warms up on a side stream (three forward and backward
passes, so that cuDNN, cuBLAS and the allocator do their first-call work
outside the graphs), then captures the encoder's forward, the decoder's
forward, the decoder's backward and the encoder's backward, in the order
a step replays them, into one memory pool of the capture's own (cuBLAS's
per-stream workspaces are cleared before and after, so the workspace the
graphs use lies in that pool too, and no workspace outlives them). Warm-up
and capture leave the training state as they found it: the parameters,
``.grad`` and the optimizer are not touched (the backward passes go
through ``torch.autograd.grad``), and the model's buffers (BatchNorm's
running statistics, which the warm-up forwards move) are saved before
and copied back after. So are the fused BatchNorm's launch counters
(``ops/fused_norm.py``): each replay adds the launches its graph holds,
so they count one call per forward and backward, as in the eager step.

A capture stays valid while the model is the same object and its
parameters and buffers stay at the addresses they had: in-place restores
(``load_state_dict``, a resume) keep it, and a moved or converted model
is captured anew. Gradients reach ``.grad`` through autograd as in the
eager step, and a parameter's ``.grad`` then shares memory with the
graph's output: the next step's replay overwrites it (``zero_grad`` has
set it to ``None`` by then), so a caller that keeps a gradient across
steps clones it. Nothing holds a capture but the step's
:class:`StepGraphs`: dropping the step frees the graphs and their pools
(``torch.cuda.empty_cache`` then returns the memory).
"""

from __future__ import annotations

import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
from torch.autograd.function import once_differentiable

from midi_vae_tpu_torch.core.types import EncoderOutput, ModelOutput
from midi_vae_tpu_torch.models.vae import VanillaVAE
from midi_vae_tpu_torch.ops import fused_norm

WARMUP_PASSES = 3
_HOOK_DICTS = ("_forward_hooks", "_forward_pre_hooks", "_backward_hooks", "_backward_pre_hooks")


def _global_hooks() -> bool:
    m = nn.modules.module
    return bool(m._global_forward_hooks or m._global_forward_pre_hooks or m._global_backward_hooks
                or m._global_backward_pre_hooks)


def _on_a_card(t: torch.Tensor) -> bool:
    return t.is_cuda


def _hooked(modules: Sequence[nn.Module]) -> bool:
    return _global_hooks() or any(getattr(m, d) for m in modules for d in _HOOK_DICTS)


class _Graphed:
    """One callable's forward and backward as two CUDA graphs over fixed
    buffers: ``args`` (the callable's tensor arguments), ``outputs``,
    ``grad_outputs`` (the backward's seeds), ``arg_grads`` (per argument,
    its gradient buffer or None) and ``params`` with their ``param_grads``;
    ``launches``: the fused BatchNorm's launches each graph holds."""

    def __init__(self, fwd, bwd, args, outputs, grad_outputs, arg_grads, params, param_grads, launches):
        self.fwd, self.bwd = fwd, bwd
        self.fwd_launches, self.bwd_launches = launches
        self.args, self.outputs, self.grad_outputs = args, outputs, grad_outputs
        self.arg_grads, self.params, self.param_grads = arg_grads, params, param_grads
        self.zeroed = [True] * len(grad_outputs)  # the seeds start as zeros

    def replay_forward(self, args) -> Tuple[torch.Tensor, ...]:
        for static, a in zip(self.args, args):
            if static.data_ptr() != a.data_ptr():
                static.copy_(a)
        self.fwd.replay()
        fused_norm.add_launch_counts(self.fwd_launches)
        return tuple(o.detach() for o in self.outputs)

    def replay_backward(self, grads) -> Tuple[Optional[torch.Tensor], ...]:
        for i, (seed, g) in enumerate(zip(self.grad_outputs, grads)):
            if g is None:  # an output nothing used: its seed must read zero
                if not self.zeroed[i]:
                    seed.zero_()
                    self.zeroed[i] = True
            else:
                if seed.data_ptr() != g.data_ptr():
                    seed.copy_(g)
                self.zeroed[i] = False
        self.bwd.replay()
        fused_norm.add_launch_counts(self.bwd_launches)
        # detached aliases: autograd hands each parameter its gradient without a copy
        return tuple(None if g is None else g.detach() for g in (*self.arg_grads, *self.param_grads))

    def __call__(self, *args) -> Tuple[torch.Tensor, ...]:
        return _Replay.apply(self, *args, *self.params)


class _Replay(torch.autograd.Function):
    """A :class:`_Graphed` as one autograd node over its arguments and parameters."""

    @staticmethod
    def forward(ctx, graphed: _Graphed, *inputs):
        ctx.graphed = graphed
        ctx.set_materialize_grads(False)
        return graphed.replay_forward(inputs[: len(graphed.args)])

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        return (None, *ctx.graphed.replay_backward(grads))


def _static(t: torch.Tensor) -> torch.Tensor:
    """A buffer with ``t``'s shape, strides and dtype, holding ``t``."""
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=t.device).copy_(t)


def _split(grads: Sequence[Optional[torch.Tensor]], params: List[torch.Tensor]):
    """The parameters a backward reached, and their gradients."""
    used = [(p, g) for p, g in zip(params, grads) if g is not None]
    return [p for p, _ in used], [g for _, g in used]


class _Capture:
    """The encoder's and the decoder's graphs for one input key of one model."""

    def __init__(self, model: nn.Module, x: torch.Tensor, y: Optional[torch.Tensor]):
        self.model = weakref.ref(model)
        params = [p for p in model.parameters() if p.requires_grad]
        buffers = list(model.buffers())
        self.tensors = params + buffers
        self.ptrs = [t.data_ptr() for t in self.tensors]
        dev = x.device
        saved = [b.detach().clone() for b in buffers]
        sx, sy = _static(x), None if y is None else _static(y)
        labels = {} if sy is None else {"y": sy}

        def encode(x_):
            e = model.encode(x_, True, **labels)
            return e.mu, e.log_var, e.pre_latents

        def decode(z_):
            return (model.decode_logits(z_, True, **labels),)

        side = torch.cuda.Stream(dev)
        launched = fused_norm.launch_counts()
        marks = []  # the launch counters before and after each capture
        with torch.cuda.device(dev):
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(WARMUP_PASSES):
                    e = encode(sx)
                    z = e[0].detach().requires_grad_()
                    d = decode(z)
                    torch.autograd.grad(d, params + [z], [torch.empty_like(t) for t in d], allow_unused=True)
                    torch.autograd.grad(e, params, [torch.empty_like(t) for t in e], allow_unused=True)
                del e, z, d
            torch.cuda.current_stream(dev).wait_stream(side)
            graphs = [torch.cuda.CUDAGraph() for _ in range(4)]
            pool = torch.cuda.graph_pool_handle()

            def capture(graph):
                marks.append(fused_norm.launch_counts())
                return torch.cuda.graph(graph, pool=pool, stream=side, capture_error_mode="thread_local")

            # cuBLAS keeps one workspace per stream outside any pool; cleared, the captures
            # allocate theirs in the pool, which then lives exactly as long as the graphs
            torch._C._cuda_clearCublasWorkspaces()
            with capture(graphs[0]):
                e_out = encode(sx)
            sz = torch.empty_like(e_out[0]).requires_grad_()
            with capture(graphs[1]):
                d_out = decode(sz)
            d_seeds = [torch.zeros_like(t) for t in d_out]
            with capture(graphs[2]):
                d_grads = torch.autograd.grad(d_out, params + [sz], d_seeds, allow_unused=True)
            e_seeds = [torch.zeros_like(t) for t in e_out]
            with capture(graphs[3]):
                e_grads = torch.autograd.grad(e_out, params, e_seeds, allow_unused=True)
            torch._C._cuda_clearCublasWorkspaces()
            marks.append(fused_norm.launch_counts())
            with torch.no_grad():
                for b, s in zip(buffers, saved):
                    b.copy_(s)
        fused_norm.reset_launch_counts()
        fused_norm.add_launch_counts(launched)
        held = [{k: after[k] - before[k] for k in after} for before, after in zip(marks, marks[1:])]
        ys = () if sy is None else (sy,)
        self.encode = _Graphed(graphs[0], graphs[3], (sx, *ys), tuple(o.detach() for o in e_out), e_seeds,
                               [None] * (1 + len(ys)), *_split(e_grads, params), (held[0], held[3]))
        self.decode = _Graphed(graphs[1], graphs[2], (sz, *ys), tuple(o.detach() for o in d_out), d_seeds,
                               [d_grads[-1]] + [None] * len(ys), *_split(d_grads[:-1], params), (held[1], held[2]))

    def valid_for(self, model: nn.Module) -> bool:
        """Still the captured model, with its tensors where they were."""
        return self.model() is model and all(t.data_ptr() == p for t, p in zip(self.tensors, self.ptrs))


class StepGraphs:
    """The captures of one train step, by input key; see the module docstring."""

    def __init__(self):
        self._captures: Dict[tuple, _Capture] = {}
        self._model = None  # weak reference to the last model seen, with its submodules and first parameter
        self._modules: List[nn.Module] = []
        self._first: Optional[torch.Tensor] = None

    def engages(self, model: nn.Module) -> bool:
        """Whether the model's encoder and decoder can run as graph replays."""
        if (getattr(model, "latent_kind", "gaussian") != "gaussian" or getattr(model, "remat", False)
                or getattr(model, "verbose", False) or type(model).forward is not VanillaVAE.forward
                or torch.is_anomaly_enabled()):
            return False
        if self._model is None or self._model() is not model:
            self._model = weakref.ref(model)
            self._modules, self._first = list(model.modules()), next(model.parameters(), None)
        return self._first is not None and _on_a_card(self._first) and not _hooked(self._modules)

    def forward(self, model: nn.Module, x: torch.Tensor, y: Optional[torch.Tensor], seed: int) -> ModelOutput:
        """``model(x, train=True, seed=seed, y=y)`` with the encoder and the
        decoder replayed; captures first where the key is new or its
        capture no longer holds."""
        key = (x.shape, x.stride(), x.dtype, None if y is None else (y.shape, y.stride(), y.dtype))
        cap = self._captures.get(key)
        if cap is None or not cap.valid_for(model):
            self._captures.pop(key, None)  # its pool goes before the new one is made
            cap = self._captures[key] = _Capture(model, x, y)
        args = () if y is None else (y,)
        mu, log_var, pre = cap.encode(x, *args)
        z = model.reparameterize(mu, log_var, seed=seed)
        (logits,) = cap.decode(z, *args)
        return ModelOutput(output=torch.sigmoid(logits), logits=logits, input=x,
                           encoded=EncoderOutput(mu=mu, log_var=log_var, pre_latents=pre), latents=z)

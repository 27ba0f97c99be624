"""Train state and the train step (counterpart of ``midi_vae_tpu/train/state.py``).

One step is forward → ELBO → backward → AdamW, eagerly. Nothing in it
waits for the device: the schedules and the reparameterization seed are
computed on the host from the host step counter, and the loss terms and
gradient norm come back as device scalars for the caller to read when it
wants them.

With ``ema_decay`` the step also keeps an exponential moving average of
the parameters (``TrainState.ema_params``), the weights evaluation and
best-model selection then use. With a VQ model (``loss_type="vq"``) the
forward also updates the quantizer's EMA buffers, as it does BatchNorm's
running statistics: they ride the state dict and the checkpoints, and the
weights' EMA covers the parameters only, as the JAX package's does.

``grad_accum=n`` splits each batch (and its labels) into n sequential
micro-batches with one ``backward()`` each: the gradients sum in
``.grad`` and are scaled by 1/n before the norm, the clip and the single
optimizer update, as the JAX package's ``accumulate_grads`` scales its
sum. BatchNorm's running statistics and a VQ quantizer's EMA buffers
chain from micro to micro, since each train-mode forward updates them.
Conditional models take their labels with the batch (``y=``).

With a ``mesh`` (``parallel/mesh.py``) the step runs on every rank of a
data-parallel group and is the one-rank step on the global batch, as the
JAX package's jit-partitioned step is: BatchNorm statistics and a VQ
quantizer's sums span the data group, the noise is this rank's rows of
the global draw (the models' ``rows=``), β-TC gathers the latents, the
free-bits floor applies to the global batch's per-dimension KL, and the
gradients and loss terms are mean-reduced
in one flat all-reduce before the clip and the update, which then run
identically on every rank. Rank r's batch holds its rows of each
global micro-batch (``Mesh.local_rows``), so local micro i is its part of
global micro i. ``per_shard=True`` makes it the explicit per-shard step
(``parallel/spmd.py``) from the same body.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from midi_vae_tpu_torch.core.rng import derive_micro_seed, derive_shard_seed, derive_step_seed
from midi_vae_tpu_torch.core.types import LossOutput
from midi_vae_tpu_torch.io import tracing
from midi_vae_tpu_torch.losses.elbo import elbo_loss
from midi_vae_tpu_torch.losses.tcvae import beta_tc_elbo_loss
from midi_vae_tpu_torch.losses.vq import vq_loss
from midi_vae_tpu_torch.models.vae import label_kwarg
from midi_vae_tpu_torch.ops.fused_elbo import fused_elbo_terms
from midi_vae_tpu_torch.parallel.collectives import CrossRank, cross_rank_statistics, psum_mean_
from midi_vae_tpu_torch.train.graphs import StepGraphs
from midi_vae_tpu_torch.train.optim import OptimizerBundle, set_step_hyperparams


@dataclass
class TrainState:
    """The model (parameters and BatchNorm running statistics), its
    optimizer, ``step``, the number of optimizer steps taken, and
    ``ema_params`` (parameter name → its moving average) when EMA tracking
    is on, else ``None``. The step updates model, optimizer and averages in
    place and returns the state with the next step count."""

    model: nn.Module
    optimizer: OptimizerBundle
    step: int = 0
    ema_params: Optional[Dict[str, torch.Tensor]] = None


def _param_copies(model: nn.Module) -> Dict[str, torch.Tensor]:
    return {name: p.detach().clone() for name, p in model.named_parameters()}


def create_train_state(model: nn.Module, optimizer: OptimizerBundle, *, ema: bool = False) -> TrainState:
    """Bundle a built model (parameters already initialised by
    ``build_model``) with its optimizer at step 0; ``ema=True`` seeds the
    moving average with copies of the parameters."""
    return TrainState(model=model, optimizer=optimizer, step=0, ema_params=_param_copies(model) if ema else None)


def state_dict(state: TrainState) -> dict:
    """The state as plain tensors, dicts and ints (the checkpoint payload):
    ``model`` (parameters and running statistics), ``optimizer``, ``step``
    and ``ema_params`` (``{}`` when EMA is off)."""
    return {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.optimizer.state_dict(),
        "step": int(state.step),
        "ema_params": dict(state.ema_params or {}),
    }


def reconcile_ema_state_dict(st_dict: dict, state: TrainState) -> dict:
    """Normalise a checkpoint's state dict across EMA generations: a run
    that tracks EMA resumed from a checkpoint without it seeds the average
    from the restored parameters; a run without EMA drops a checkpoint's."""
    st_dict = dict(st_dict)
    if state.ema_params is not None and not st_dict.get("ema_params"):
        params = dict(state.model.named_parameters())
        st_dict["ema_params"] = {k: v.clone() for k, v in st_dict["model"].items() if k in params}
    if state.ema_params is None:
        st_dict["ema_params"] = {}
    return st_dict


def load_state_dict(state: TrainState, st_dict: dict) -> TrainState:
    """Restore ``state`` in place from :func:`state_dict`'s payload (after
    :func:`reconcile_ema_state_dict`); returns it with the restored step."""
    state.model.load_state_dict(st_dict["model"])
    state.optimizer.optimizer.load_state_dict(st_dict["optimizer"])
    if state.ema_params is not None:
        with torch.no_grad():
            for name, t in state.ema_params.items():
                t.copy_(st_dict["ema_params"][name])
    return dataclasses.replace(state, step=int(st_dict["step"]))


@torch.no_grad()
def ema_update(ema_params: Dict[str, torch.Tensor], model: nn.Module, decay: float) -> None:
    """One EMA step in place: ``ema ← decay·ema + (1 − decay)·params``, with
    decay and 1 − decay rounded to f32 as the JAX package computes them."""
    d = np.float32(decay)
    ema = [ema_params[name] for name, _ in model.named_parameters()]
    params = [p.detach().to(e.dtype) for (_, p), e in zip(model.named_parameters(), ema)]
    torch._foreach_mul_(ema, float(d))
    torch._foreach_add_(ema, params, alpha=float(np.float32(1.0) - d))


def make_loss(
    *,
    loss_type: str = "elbo",
    fused_loss: bool = False,
    log_var_clamp: Optional[Tuple[float, float]] = None,
    free_bits: Optional[float] = None,
    pos_weight: Optional[float] = None,
    target_denorm=None,
    tc_beta: float = 6.0,
    dataset_size: int = 1,
    tc_gather: Optional[CrossRank] = None,
    free_bits_group: Optional[CrossRank] = None,
) -> Callable:
    """Build the training objective ``(ModelOutput, kld_weight) → LossOutput``,
    validating option compatibility as midi_vae_tpu/train/state.py:195-206 does.
    ``tc_beta`` and ``dataset_size`` configure the β-TC objective, and
    ``tc_gather`` the group its estimator gathers the latents over;
    ``free_bits_group`` the group whose global batch the free-bits floor
    applies to."""
    if loss_type not in ("elbo", "beta-tc", "vq"):
        raise ValueError(f"unknown loss_type: {loss_type}")
    if loss_type != "elbo" and fused_loss:
        raise ValueError("fused loss implements the plain ELBO only; drop --fused")
    if free_bits is not None and (fused_loss or loss_type != "elbo"):
        raise ValueError("--free-bits is implemented on the plain (non-fused) ELBO path")
    if loss_type == "vq" and log_var_clamp is not None:
        raise ValueError("--log-var-clamp has no effect on the VQ objective (no posterior variance)")
    if pos_weight is not None and fused_loss:
        raise ValueError("the fused BCE implements the unweighted reference formula; drop --fused for --bce-pos-weight")
    if target_denorm is not None and fused_loss:
        raise ValueError("the fused BCE consumes normalized targets; drop --fused for --bce-targets raw")

    def _loss(out, w: float) -> LossOutput:
        if loss_type == "vq":
            # the scheduled "KL weight" is the commitment β of this objective
            return vq_loss(out, commitment_weight=w, pos_weight=pos_weight, target_denorm=target_denorm)
        if loss_type == "beta-tc":
            return beta_tc_elbo_loss(
                out,
                tc_beta=tc_beta,
                dataset_size=dataset_size,
                kld_weight=w,
                log_var_clamp=log_var_clamp,
                pos_weight=pos_weight,
                target_denorm=target_denorm,
                gather=tc_gather,
            )
        if not fused_loss:
            return elbo_loss(
                out,
                kld_weight=w,
                log_var_clamp=log_var_clamp,
                free_bits=free_bits,
                pos_weight=pos_weight,
                target_denorm=target_denorm,
                free_bits_group=free_bits_group,
            )
        lv = out.encoded.log_var
        if log_var_clamp is not None:
            lv = lv.clamp(log_var_clamp[0], log_var_clamp[1])
        loss, recon, kl = fused_elbo_terms(out.logits, out.input, out.encoded.mu, lv, w)
        return LossOutput(
            loss=loss,
            reconstruction_loss=recon.detach(),
            kld_loss=-kl.detach(),
            kl=kl.detach(),
            kld_weight=torch.full((), w, dtype=loss.dtype, device=loss.device),
        )

    return _loss


def _global_norm(grads) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))


def _grad_norm(model: nn.Module, grads) -> torch.Tensor:
    """The global gradient norm; on a rank of a tensor-parallel model, the
    whole model's (``parallel/sharding_rules.py``)."""
    if not hasattr(model, "tp_group"):
        return _global_norm(grads)
    from midi_vae_tpu_torch.parallel.sharding_rules import tp_global_norm

    return tp_global_norm(model)


def _running_stats(model: nn.Module):
    return [b for name, b in model.named_buffers() if name.endswith(("running_mean", "running_var"))]


def make_train_step(
    kl_schedule: Callable[[int], float],
    *,
    log_var_clamp: Optional[Tuple[float, float]] = None,
    free_bits: Optional[float] = None,
    pos_weight: Optional[float] = None,
    target_denorm=None,
    fused_loss: bool = False,
    loss_type: str = "elbo",
    tc_beta: float = 6.0,
    dataset_size: int = 1,
    grad_accum: int = 1,
    ema_decay: Optional[float] = None,
    mesh=None,
    per_shard: bool = False,
) -> Callable:
    """Build the train step ``(state, x, epoch_seed, *, y=None, eps=None) →
    (state, LossOutput, grad_norm)``.

    ``x`` is an NHWC batch on the model's device and ``y`` its int labels,
    passed to conditional models only. The reparameterization seed of each
    step is :func:`derive_step_seed` of (``epoch_seed``, ``state.step``),
    and micro-batch i of an accumulated step draws with
    :func:`derive_micro_seed` of (that seed, i). ``eps`` replaces the draw
    (tests inject the JAX side's noise with it): one tensor, or with
    ``grad_accum`` > 1 a list of one per micro-batch. ``fused_loss=True``
    takes the BCE through the K1/K2 kernels (``ops/fused_elbo.py``).
    ``grad_norm`` is the global gradient norm before clipping. While a
    profiler records, each step is the span ``train.step``
    (``io/tracing.py``).

    Without ``mesh``, ``grad_accum`` and ``eps``, a model on a CUDA device
    runs its encoder and decoder as CUDA graph replays where
    ``train/graphs.py`` ``StepGraphs.engages``: the same kernels on the same
    tensors, with the reparameterization, the loss and the update eager
    between and after them. Each such step adds one to the counter
    ``train.graph_steps``.

    ``mesh`` makes it the data-parallel auto step of the module docstring
    (``x`` and ``y`` are this rank's rows); with ``per_shard`` it is the
    explicit per-shard step of ``parallel/spmd.py`` instead.
    """
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    group = None if mesh is None else mesh.data_group
    coords = () if mesh is None else tuple(mesh.coords[a] for a in mesh.axis_names)
    _loss = make_loss(
        loss_type=loss_type,
        fused_loss=fused_loss,
        log_var_clamp=log_var_clamp,
        free_bits=free_bits,
        pos_weight=pos_weight,
        target_denorm=target_denorm,
        tc_beta=tc_beta,
        dataset_size=dataset_size,
        tc_gather=CrossRank(group) if mesh is not None and loss_type == "beta-tc" else None,
        # the auto step floors the global batch's KL; the explicit step each shard's
        free_bits_group=CrossRank(group) if mesh is not None and not per_shard and free_bits is not None else None,
    )

    def draw_rows(b: int) -> Optional[Tuple[int, int]]:
        """The auto step's rows of the global draw for a forward of ``b`` local rows."""
        if mesh is None or per_shard:
            return None
        return mesh.shard_index * b, mesh.num_shards * b

    graphs = StepGraphs() if mesh is None and grad_accum == 1 else None

    def forward_backward(model, x, y, seed, eps, w, graphed=False) -> LossOutput:
        if graphed:
            out = graphs.forward(model, x, label_kwarg(model, y).get("y"), seed)
        else:
            out = model(x, train=True, seed=seed, eps=eps, rows=draw_rows(x.shape[0]), **label_kwarg(model, y))
        lo = _loss(out, w)
        lo.loss.backward()
        return dataclasses.replace(lo, loss=lo.loss.detach())

    def synced(model):
        """The auto step's norms and codebook span the group; the explicit
        step's only for a VQ model, as the JAX package hands a VQ model the
        mesh axes as ``bn_axis_name`` (``train/loop.py:237-241``)."""
        if mesh is None or per_shard and getattr(model, "latent_kind", "gaussian") != "vq":
            return contextlib.nullcontext()
        return cross_rank_statistics(model, group)

    def step(state: TrainState, x: torch.Tensor, epoch_seed: int, *, y=None, eps=None):
        with tracing.span("train.step"):
            return step_body(state, x, epoch_seed, y, eps)

    def step_body(state: TrainState, x: torch.Tensor, epoch_seed: int, y, eps):
        model, bundle = state.model, state.optimizer
        set_step_hyperparams(bundle, state.step)
        model.zero_grad(set_to_none=True)  # also the frozen groups, which are outside the optimizer
        step_seed = derive_step_seed(epoch_seed, state.step)
        if per_shard:
            step_seed = derive_shard_seed(step_seed, coords)
        w = kl_schedule(state.step)
        with synced(model):
            if grad_accum == 1:
                graphed = graphs is not None and eps is None and graphs.engages(model)
                lo = forward_backward(model, x, y, step_seed, eps, w, graphed)
                if graphed:
                    tracing.count("train.graph_steps", 1)
            else:
                n, b = grad_accum, x.shape[0]
                if b % n:
                    raise ValueError(f"{'per-shard ' if per_shard else ''}batch size {b} not divisible by grad_accum={n}")
                m = b // n
                sums = None
                for i in range(n):
                    part = forward_backward(
                        model, x[i * m : (i + 1) * m], None if y is None else y[i * m : (i + 1) * m],
                        derive_micro_seed(step_seed, i), None if eps is None else eps[i], w,
                    )
                    fields = [getattr(part, f.name) for f in dataclasses.fields(LossOutput)]
                    sums = fields if sums is None else [a + v for a, v in zip(sums, fields)]
                # the sums scaled by 1/n in f32, as accumulate_grads scales them
                inv = float(np.float32(1.0 / n))
                lo = LossOutput(*(v * inv for v in sums))
                torch._foreach_mul_([p.grad for p in model.parameters() if p.grad is not None], inv)
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        if mesh is not None:
            # one all-reduce: gradients, loss terms (and running statistics of the explicit step)
            terms = torch.stack([lo.loss.float(), lo.reconstruction_loss.float(), lo.kld_loss.float(), lo.kl.float()])
            buffers = _running_stats(model) if per_shard else []
            psum_mean_(grads + [terms] + buffers, group)
            lo = LossOutput(*terms.unbind(), kld_weight=lo.kld_weight)
        grad_norm = _grad_norm(model, grads)
        if bundle.grad_clip is not None:
            trainable = [p.grad for g in bundle.optimizer.param_groups for p in g["params"] if p.grad is not None]
            coef = (bundle.grad_clip / _grad_norm(model, trainable)).clamp(max=1.0)
            for g in trainable:
                g.mul_(coef)
        bundle.optimizer.step()
        ema = state.ema_params
        if ema_decay is not None:
            if ema is None:  # resumed without averages: seed them from the parameters
                ema = _param_copies(model)
            else:
                ema_update(ema, model, ema_decay)
        return TrainState(model=model, optimizer=bundle, step=state.step + 1, ema_params=ema), lo, grad_norm

    return step

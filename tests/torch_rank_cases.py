"""Rank-side cases of the multi-rank tests (``tests/test_torch_parallel.py``,
``test_torch_spmd.py``, ``test_torch_multirank_cli.py``).

This module imports torch and the port only, never JAX: the launcher
(``midi_vae_tpu_torch.parallel.launch.spawn``) imports it in each rank
process. :func:`run_cases` runs the named cases of :data:`CASES` in one
process group, every rank in the same order, and returns rank 0's results,
one ``("ok", value)`` or ``("error", traceback)`` per case; a case that
needs the other ranks' values gathers them to rank 0 itself. The tests
compare those results with the one-rank step (computed in the test
process with :func:`train_steps`) or with the JAX package.
"""

from __future__ import annotations

import traceback

import numpy as np
import torch
import torch.distributed as dist

from midi_vae_tpu_torch.core.rng import derive_shard_seed, derive_step_seed
from midi_vae_tpu_torch.core.types import EncoderOutput, ModelOutput
from midi_vae_tpu_torch.losses.schedules import kl_weight_schedule
from midi_vae_tpu_torch.losses.tcvae import beta_tc_elbo_loss
from midi_vae_tpu_torch.models.registry import build_model
from midi_vae_tpu_torch.models.vae import BatchNorm, param_group_label
from midi_vae_tpu_torch.parallel import collectives
from midi_vae_tpu_torch.parallel.collectives import CrossRank, cross_rank_statistics
from midi_vae_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d, make_mesh_multislice
from midi_vae_tpu_torch.parallel.spmd import make_spmd_train_step
from midi_vae_tpu_torch.train.optim import build_optimizer
from midi_vae_tpu_torch.train.state import create_train_state, make_train_step

SGD = dict(optimizer="SGD", lr=0.1, scheduler="constant", total_steps=10, cycle_momentum=False)
CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def gather_to_rank0(value):
    """Every rank's ``value`` (picklable) on rank 0, in rank order."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def run_cases(rank: int, device, names, payload: dict) -> dict:
    """Run each named case on every rank; rank 0's results by name."""
    results = {}
    for name in names:
        torch.manual_seed(0)
        try:
            results[name] = ("ok", CASES[name](rank, payload.get(name)))
        except Exception:
            results[name] = ("error", traceback.format_exc())
        dist.barrier()
    return results


# ------------------------------------------------------------- train steps


def make_data(spec: dict, n_steps: int):
    """(images [steps, B, S, S, C], labels [steps, B]) of a spec, from its seed."""
    rng = np.random.default_rng(spec.get("data_seed", 1))
    kw = spec["model"]
    shape = (n_steps, spec["batch"], kw["input_dim"], kw["input_dim"], kw.get("in_channels", 1))
    x = (rng.uniform(size=shape) > 0.7).astype(np.float32)
    y = (np.arange(spec["batch"])[None, :].repeat(n_steps, 0) % max(kw.get("num_classes", 0), 1)).astype(np.int64)
    return x, y


def build_spec_model(spec: dict):
    """The spec's model, with its ``state_dict`` (numpy arrays: the specs
    reach the ranks pickled, and numpy pickles by value where torch tensors
    would go through shared memory and a file-descriptor server thread in
    the test process) when it has one."""
    model = build_model(spec["arch"], device="cpu", seed=spec.get("seed", 3), **spec["model"])
    if "state_dict" in spec:
        model.load_state_dict({k: torch.from_numpy(v) for k, v in spec["state_dict"].items()})
    return model


def train_steps(spec: dict, mesh=None, impl: str = "auto") -> dict:
    """``spec["steps"]`` steps of ``spec``'s model and step options: on the
    one rank of no mesh (the whole batch), or on this rank of ``mesh``
    (its rows). ``spec["eps"]`` ([steps, B, D], optional) is the noise to
    inject, of which each rank takes its rows. Returns the loss fields,
    grad norms and the final state dict."""
    model = build_spec_model(spec)
    state = create_train_state(model, build_optimizer(model, param_group_label, **spec.get("opt", SGD)))
    kl = kl_weight_schedule("constant", spec.get("kl", 0.05))
    step_kw = dict(spec.get("step", {}))
    if mesh is not None and impl == "shard_map":
        step = make_spmd_train_step(kl, mesh, **step_kw)
    else:
        step = make_train_step(kl, mesh=mesh, **step_kw)
    n = spec.get("steps", 3)
    x, y = make_data(spec, n)
    micro = step_kw.get("grad_accum", 1) if impl == "auto" else 1
    rows = np.arange(spec["batch"]) if mesh is None else mesh.local_rows(spec["batch"], micro)
    conditional = spec["model"].get("num_classes", 0) > 0
    eps = spec.get("eps")
    fields, norms = [], []
    for i in range(n):
        xb, yb = torch.from_numpy(x[i][rows]), torch.from_numpy(y[i][rows])
        e = None if eps is None else torch.from_numpy(eps[i][rows])
        state, lo, gn = step(state, xb, spec.get("epoch_seed", 5), y=yb if conditional else None, eps=e)
        fields.append([float(getattr(lo, f)) for f in ("loss", "reconstruction_loss", "kld_loss", "kl", "kld_weight")])
        norms.append(float(gn))
    return {"fields": fields, "grad_norms": norms, "state": {k: v.clone() for k, v in model.state_dict().items()}}


@case
def auto_steps(rank, specs):
    """The auto step on this group's 1-D mesh, for each spec."""
    mesh = make_mesh()
    return {name: train_steps(spec, mesh) for name, spec in specs.items()}


@case
def spmd_steps(rank, specs):
    """The explicit step on this group's 1-D mesh; each rank's final state."""
    mesh = make_mesh()
    return {name: gather_to_rank0(train_steps(spec, mesh, "shard_map")) for name, spec in specs.items()}


@case
def multislice_steps(rank, spec):
    """The auto and explicit steps on the (2, 2) multi-slice mesh and on the flat 4-rank mesh."""
    flat, sliced = make_mesh(4), make_mesh_multislice(2, 2)
    return {
        "axes": (flat.axis_names, sliced.axis_names, sliced.coords),
        "auto_flat": train_steps(spec["auto"], flat), "auto_sliced": train_steps(spec["auto"], sliced),
        "spmd_flat": train_steps(spec["spmd"], flat, "shard_map"),
        "spmd_sliced": train_steps(spec["spmd"], sliced, "shard_map"),
    }


@case
def shard_noise(rank, spec):
    """Each rank's latents of the same rows under its explicit-step seed,
    and the seeds."""
    mesh = make_mesh()
    model = build_spec_model(spec)
    x = torch.from_numpy(make_data(spec, 1)[0][0][: spec["rows"]])
    step_seed = derive_step_seed(5, 0)
    seed = derive_shard_seed(step_seed, [mesh.coords[a] for a in mesh.axis_names])
    z = model(x, train=True, seed=seed).latents.detach()
    return gather_to_rank0((seed, step_seed, z))


# ------------------------------------------------------------- collectives


@case
def collectives_grads(rank, _):
    """all_reduce_sum, concat_all_gather (values and gradients),
    concat_all_gather_ragged, psum_mean_, and a cross-rank BatchNorm, on
    rank-dependent inputs made from the seed; every rank's values on rank 0."""
    n = dist.get_world_size()
    rng = np.random.default_rng(11)
    xs = torch.from_numpy(rng.normal(size=(n, 3, 4)).astype(np.float32))
    ws = torch.from_numpy(rng.normal(size=(n, 3, 4)).astype(np.float32))
    gw = torch.from_numpy(rng.normal(size=(n, n * 3, 4)).astype(np.float32))
    out = {}
    x = xs[rank].clone().requires_grad_(True)
    y = collectives.all_reduce_sum(x, None)
    (y * ws[rank]).sum().backward()
    out["sum"], out["sum_grad"] = y.detach(), x.grad.clone()
    x = xs[rank].clone().requires_grad_(True)
    g = collectives.concat_all_gather(x, None)
    (g * gw[rank]).sum().backward()
    out["gather"], out["gather_grad"] = g.detach(), x.grad.clone()
    counts = [1, 3][rank % 2]
    vals, masks = collectives.concat_all_gather_ragged(xs[rank], counts, None, 3)
    out["ragged"] = (vals, masks)
    t = xs[rank].clone()
    collectives.psum_mean_([t], None)
    out["mean"] = t
    # BatchNorm over the group on [2, C, 3, 3] per rank against one rank's [2n, ...]
    bx = torch.from_numpy(rng.normal(size=(n, 2, 4, 3, 3)).astype(np.float32))
    bw = torch.from_numpy(rng.normal(size=(n, 2, 4, 3, 3)).astype(np.float32))
    bn = BatchNorm(4)
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, 4))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, 4))
    xb = bx[rank].clone().requires_grad_(True)
    with cross_rank_statistics(bn, None):
        yb = bn(xb, train=True)
    (yb * bw[rank]).sum().backward()
    out["bn"] = (yb.detach(), xb.grad.clone(), bn.running_mean.clone(), bn.running_var.clone())
    out["inputs"] = (xs, ws, gw, bx, bw)
    return gather_to_rank0(out)


@case
def beta_tc_gather(rank, spec):
    """β-TC loss of this rank's rows with the latents gathered over the
    group: the loss and the gradients of (z, mu, log_var)."""
    n = dist.get_world_size()
    b = spec["z"].shape[0] // n
    sl = slice(rank * b, (rank + 1) * b)
    z, mu, lv = (torch.from_numpy(spec[k][sl]).clone().requires_grad_(True) for k in ("z", "mu", "lv"))
    logits, targets = torch.from_numpy(spec["logits"][sl]), torch.from_numpy(spec["targets"][sl])
    out = ModelOutput(output=torch.sigmoid(logits), logits=logits, input=targets,
                      encoded=EncoderOutput(mu=mu, log_var=lv, pre_latents=mu), latents=z)
    lo = beta_tc_elbo_loss(out, gather=CrossRank(None), **spec["kw"])
    lo.loss.backward()
    return gather_to_rank0((float(lo.loss.detach()), z.grad, mu.grad, lv.grad))


# ------------------------------------------------------------- tensor parallel


@case
def tp_step(rank, spec):
    """One step of the TP-sharded model on a (1, n) data × model mesh: loss
    fields, grad norm, and every rank's slice of fc_mu's weight."""
    from midi_vae_tpu_torch.parallel.sharding_rules import shard_state, tp_param_specs

    mesh = make_mesh_2d(1, dist.get_world_size())
    model = build_spec_model(spec)
    specs = tp_param_specs(model)
    shard_state(model, mesh)
    state = create_train_state(model, build_optimizer(model, param_group_label, **spec["opt"]))
    step = make_train_step(kl_weight_schedule("constant", spec["kl"]), mesh=mesh)
    x = torch.from_numpy(make_data(spec, 1)[0][0])
    state, lo, gn = step(state, x, 1)
    weights = gather_to_rank0({k: v.clone() for k, v in model.state_dict().items()})
    return {"loss": float(lo.loss), "grad_norm": float(gn), "weights": weights, "specs": specs}


@case
def spmd_indivisible(rank, spec):
    """The explicit step's error on a local batch that grad_accum does not divide."""
    try:
        train_steps(spec, make_mesh(), "shard_map")
    except ValueError as e:
        return str(e)
    return None


# ------------------------------------------------------------- the CLIs in a group


def run_summary(r: dict) -> dict:
    """A train run's results without the live state, and its parameters as one vector."""
    model = r["state"].model
    out = {k: v for k, v in r.items() if k != "state"}
    out["params"] = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    return out


@case
def cli_runs(rank, spec):
    """The train CLI inside the group (``--num-devices`` = its size): a run,
    its resume, and a prior trained over a VQ checkpoint; every rank's summaries."""
    from midi_vae_tpu_torch.cli import train as train_cli
    from midi_vae_tpu_torch.cli import train_prior

    out = {"run": run_summary(train_cli.cli(spec["argv"]))}
    out["resumed"] = run_summary(train_cli.cli(spec["resume_argv"]))
    out["prior"] = train_prior.cli(spec["prior_argv"])
    return gather_to_rank0(out)

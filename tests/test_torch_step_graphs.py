"""The train step's CUDA graphs (``train/graphs.py``).

On the CPU: the engagement rule. With the device condition met (the
capture itself needs a card, so the eager forward stands in for the
replays and is recorded), the flagship's step and an MLPVAE's engage and
count ``train.graph_steps``; each excluding condition takes the eager path
and leaves the counter at 0.

On a CUDA card (skipped without one; on the card run ``python -m pytest
tests/test_torch_step_graphs.py --noconftest -q -m card``): the graphed
flagship step against the eager one over 5 steps at batch 100 and 2048,
with losses, gradients before the update, parameters, AdamW state and
BatchNorm running statistics equal, bitwise wherever two eager runs are
bitwise; MLPVAE, a conditional model, the unfused VanillaVAE and a
capture under a recording profiler against their eager paths; a half batch
after capture; ``load_state_dict`` between steps; and the graphs' memory
returned once the step and the model are dropped, with the garbage
collector off.
"""

import contextlib
import dataclasses
import gc
import os

import pytest
import torch
from torch.profiler import profile

from midi_vae_tpu_torch.io import tracing
from midi_vae_tpu_torch.losses.schedules import kl_weight_schedule
from midi_vae_tpu_torch.train import graphs
from midi_vae_tpu_torch.train.config import from_yaml
from midi_vae_tpu_torch.train.graphs import StepGraphs
from midi_vae_tpu_torch.train.loop import build_run_model, build_run_optimizer
from midi_vae_tpu_torch.train.state import create_train_state, load_state_dict, make_train_step, state_dict
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED, EPOCH_SEED = 7, 11
NARROW = dict(folded=(8, 8, 16, 16), vq16_fold8=(8, 16, 32))


@pytest.fixture(autouse=True)
def _forget_counters():
    tracing.reset()
    yield
    tracing.reset()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs are captured and replayed there only")
    return torch.device("cuda", 0)


def _config(name="folded", narrow=True, **kw):
    cfg = from_yaml(os.path.join(ROOT, "configs", f"{name}.yaml"))
    extra = dict(fused=True, bce_targets="normalized") if name == "folded" else {}
    if narrow:
        extra["hidden_dims"] = NARROW[name]
    if name == "vq16_fold8" and narrow:
        extra.update(n_features=4, codebook_size=16)
    return dataclasses.replace(cfg, seed=SEED, models_dir=None, **{**extra, **kw})


def _train(config, device, batch, *, mesh=None, model=None):
    """A model, state and step as the train CLI builds them."""
    model = model or build_run_model(config, device, in_channels=1, seed=SEED)
    bundle = build_run_optimizer(config, model, batch, 100)
    kl = kl_weight_schedule(config.kl_schedule, config.kld_weight, warmup_steps=config.kl_warmup_steps,
                            period=config.kl_cycle_steps, ramp_fraction=config.kl_ramp_fraction,
                            growth=config.kl_growth, cap=config.kl_cap)
    step = make_train_step(kl, fused_loss=config.fused, loss_type=config.loss_type, grad_accum=config.grad_accum,
                           mesh=mesh)
    return model, create_train_state(model, bundle), step


def _batch(b, device, seed=3, size=128):
    g = torch.Generator().manual_seed(seed)
    return ((torch.rand(b, size, size, 1, generator=g) > 0.9).float() - 0.5).to(device)


# ------------------------------------------------------------------ the CPU: when the graphs engage

ENGAGES = {"graphed": True, "mlp": True, "cpu": False, "mesh": False, "grad_accum": False, "eps": False,
           "vq": False, "remat": False, "verbose": False, "hooks": False}


@pytest.mark.parametrize("case", list(ENGAGES))
def test_engagement_rule(case, monkeypatch):
    calls = []

    def eager_stand_in(self, model, x, y, seed):
        calls.append(tuple(x.shape))
        return model(x, train=True, seed=seed, y=y)

    monkeypatch.setattr(StepGraphs, "forward", eager_stand_in)
    if case != "cpu":
        monkeypatch.setattr(graphs, "_on_a_card", lambda t: True)
    cpu, b, kw, mesh, own_group = torch.device("cpu"), 4, {}, None, None
    config = {"vq": lambda: _config("vq16_fold8"),
              "mlp": lambda: _config(arch="MLPVAE", hidden_dims=(16, 8)),
              "remat": lambda: _config(remat=True),
              "verbose": lambda: _config(verbose=True),
              "grad_accum": lambda: _config(grad_accum=2)}.get(case, _config)()
    if case == "mesh":
        from midi_vae_tpu_torch.parallel.mesh import ensure_process_group, make_mesh

        own_group = ensure_process_group(cpu)
        mesh = make_mesh(1)
    try:
        model, state, step = _train(config, cpu, b, mesh=mesh)
        if case == "eps":
            kw["eps"] = torch.randn(b, config.n_features)
        if case == "hooks":
            model.encoder.register_forward_hook(lambda *a: None)
        state, lo, _ = step(state, _batch(b, cpu, size=config.image_size), EPOCH_SEED, **kw)
    finally:
        if own_group is not None:
            import shutil

            import torch.distributed as dist

            dist.destroy_process_group()
            shutil.rmtree(own_group, ignore_errors=True)
    assert torch.isfinite(lo.loss) and state.step == 1
    counted = tracing.counters().get("train.graph_steps", 0)
    assert (counted, len(calls)) == ((1, 1) if ENGAGES[case] else (0, 0))


def test_the_stock_forward_is_the_one_that_engages(monkeypatch):
    """A model whose class overrides ``forward`` keeps the eager path."""
    from midi_vae_tpu_torch.models.folded import FoldedVAE

    class Wrapped(FoldedVAE):
        def forward(self, x, train=False, **kw):
            return super().forward(x, train, **kw)

    monkeypatch.setattr(graphs, "_on_a_card", lambda t: True)
    model = build_run_model(_config(), torch.device("cpu"), in_channels=1, seed=SEED)
    assert StepGraphs().engages(model)
    model.__class__ = Wrapped
    assert not StepGraphs().engages(model)


# ------------------------------------------------------------------ the card: graphed against eager

def _run(dev, config, sizes, *, graphed, monkeypatch, between=None, profiled=False):
    """Steps over batches of ``sizes`` through the graphed or the eager
    path; returns what each step fed the optimizer and the state at the end.
    ``between(i, state)`` runs after step ``i`` and returns the state; a
    conditional config's steps take labels; ``profiled`` runs them all
    while ``torch.profiler`` records (the capture included)."""
    with monkeypatch.context() as m, (profile() if profiled else contextlib.nullcontext()):
        if not graphed:
            m.setattr(StepGraphs, "engages", lambda self, model: False)
        model, state, step = _train(config, dev, max(sizes))
        opt = state.optimizer.optimizer
        names = {id(p): k for k, p in model.named_parameters()}
        fed = []
        opt.register_step_pre_hook(lambda o, a, k: fed.append(
            {names[id(p)]: p.grad.clone() for g in o.param_groups for p in g["params"] if p.grad is not None}))
        losses = []
        for i, b in enumerate(sizes):
            y = torch.arange(b, device=dev) % config.num_classes if config.conditional else None
            state, lo, gn = step(state, _batch(b, dev, seed=3 + i, size=config.image_size), EPOCH_SEED, y=y)
            losses.append(torch.stack([lo.loss.float(), lo.kl.float(), gn.float()]))
            if between is not None:
                state = between(i, state)
        torch.cuda.synchronize(dev)
        adam = {f"{names[id(p)]}.{k}": v.clone() for p, st in opt.state.items() for k, v in st.items()
                if torch.is_tensor(v)}
        out = {"losses": {"all": torch.stack(losses)}, "fed": fed, "adam": adam,
               "params": {k: p.detach().clone() for k, p in model.named_parameters()},
               "buffers": {k: b.clone() for k, b in model.named_buffers()}}
    return out


def _flat(run):
    out = {f"losses.{k}": v for k, v in run["losses"].items()}
    for i, g in enumerate(run["fed"]):
        out.update({f"grad{i}.{k}": v for k, v in g.items()})
    for part in ("adam", "params", "buffers"):
        out.update({f"{part}.{k}": v for k, v in run[part].items()})
    return out


def _same_as_eager(graphed, eager, eager2):
    """``graphed`` equals ``eager`` bitwise wherever ``eager2`` (the eager
    path run again) does; elsewhere it lies within four times the eager
    runs' own difference."""
    g, a, b = _flat(graphed), _flat(eager), _flat(eager2)
    assert g.keys() == a.keys() == b.keys() and len(graphed["fed"]) == len(eager["fed"])
    loose = []
    for k in a:
        if torch.equal(a[k], b[k]):
            assert torch.equal(g[k], a[k]), f"{k}: graphed differs from two bitwise-equal eager runs"
        else:
            noise = (a[k].double() - b[k].double()).abs().max()
            assert (g[k].double() - a[k].double()).abs().max() <= 4 * noise, k
            loose.append(k)
    return loose


@pytest.mark.card
@pytest.mark.parametrize("batch", [100, 2048])
def test_graphed_steps_match_eager(card, monkeypatch, batch):
    config = _config(narrow=False)
    eager = _run(card, config, [batch] * 5, graphed=False, monkeypatch=monkeypatch)
    eager2 = _run(card, config, [batch] * 5, graphed=False, monkeypatch=monkeypatch)
    tracing.reset()
    graphed = _run(card, config, [batch] * 5, graphed=True, monkeypatch=monkeypatch)
    assert tracing.counters()["train.graph_steps"] == 5
    loose = _same_as_eager(graphed, eager, eager2)
    print(f"batch {batch}: {len(loose)} of {len(_flat(eager))} tensors not bitwise across eager runs")


OTHER_PATHS = {
    "mlp": lambda: _config(narrow=False, arch="MLPVAE", hidden_dims=(512, 256)),
    "conditional": lambda: _config(narrow=False, conditional=True, num_classes=3),
    "unfused_vanilla": lambda: _config("midi", narrow=False),
    "profiled": lambda: _config(narrow=False),
}


@pytest.mark.card
@pytest.mark.parametrize("variant", list(OTHER_PATHS))
def test_other_engaged_paths_match_eager(card, monkeypatch, variant):
    """MLPVAE, a conditional model (labels copied into the graphs), the
    unfused VanillaVAE (a ``torch.Generator`` draw between the graphs) and
    a step captured while a profiler records, each against the eager path."""
    config, sizes, kw = OTHER_PATHS[variant](), [64] * 4, dict(profiled=variant == "profiled")
    eager = _run(card, config, sizes, graphed=False, monkeypatch=monkeypatch, **kw)
    eager2 = _run(card, config, sizes, graphed=False, monkeypatch=monkeypatch, **kw)
    tracing.reset()
    graphed = _run(card, config, sizes, graphed=True, monkeypatch=monkeypatch, **kw)
    assert tracing.counters()["train.graph_steps"] == len(sizes)
    loose = _same_as_eager(graphed, eager, eager2)
    print(f"{variant}: {len(loose)} of {len(_flat(eager))} tensors not bitwise across eager runs")


def _counting_captures(monkeypatch):
    made = []

    class Counted(graphs._Capture):
        def __init__(self, *a):
            made.append(a[1].shape[0])
            super().__init__(*a)

    monkeypatch.setattr(graphs, "_Capture", Counted)
    return made


@pytest.mark.card
def test_a_half_batch_after_capture(card, monkeypatch):
    config, sizes = _config(narrow=False), [100, 100, 50, 50, 100]
    eager = _run(card, config, sizes, graphed=False, monkeypatch=monkeypatch)
    eager2 = _run(card, config, sizes, graphed=False, monkeypatch=monkeypatch)
    made = _counting_captures(monkeypatch)
    graphed = _run(card, config, sizes, graphed=True, monkeypatch=monkeypatch)
    assert made == [100, 50]
    _same_as_eager(graphed, eager, eager2)


@pytest.mark.card
def test_load_state_dict_between_steps(card, monkeypatch):
    """An in-place restore keeps the capture valid: after step 3 the state
    goes back to where step 2 left it, and steps 4-5 go on from there, as
    on the eager path."""
    config, saved = _config(narrow=False), {}

    def between(i, state):
        if i == 1:
            saved["state"] = _deep_clone(state_dict(state))
        if i == 2:
            return load_state_dict(state, saved["state"])
        return state

    sizes = [100] * 5
    eager = _run(card, config, sizes, graphed=False, monkeypatch=monkeypatch, between=between)
    eager2 = _run(card, config, sizes, graphed=False, monkeypatch=monkeypatch, between=between)
    made = _counting_captures(monkeypatch)
    graphed = _run(card, config, sizes, graphed=True, monkeypatch=monkeypatch, between=between)
    assert made == [100]
    _same_as_eager(graphed, eager, eager2)


def _deep_clone(obj):
    if torch.is_tensor(obj):
        return obj.clone()
    if isinstance(obj, dict):
        return {k: _deep_clone(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_deep_clone(v) for v in obj]
    return obj


@pytest.mark.card
def test_dropping_the_step_frees_the_graphs(card, monkeypatch):
    """With the garbage collector off, dropping the step and the model and
    emptying the cache returns the reserved memory to what the eager path
    leaves: no reference cycle holds a graph or its pool."""
    config, sizes = _config(narrow=False), [2048] * 2

    def reserved_after(graphed):
        with monkeypatch.context() as m:
            if not graphed:
                m.setattr(StepGraphs, "engages", lambda self, model: False)
            model, state, step = _train(config, card, 2048)
            for i, b in enumerate(sizes):
                state, lo, _ = step(state, _batch(b, card, seed=3 + i), EPOCH_SEED)
            torch.cuda.synchronize(card)
            held = torch.cuda.memory_reserved(card)
            del model, state, step, lo
        torch.cuda.empty_cache()
        return held, torch.cuda.memory_reserved(card)

    import torch._dynamo  # noqa: F401  (the first optimizer's import keeps its callers' frames in a cycle)

    gc.collect()
    gc.disable()
    try:
        _, eager_left = reserved_after(False)
        held, graphed_left = reserved_after(True)
    finally:
        gc.enable()
    print(f"reserved: eager leaves {eager_left}, graphed holds {held} and leaves {graphed_left}")
    assert graphed_left <= eager_left < held

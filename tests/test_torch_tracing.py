"""Spans and counters of the port's training step (``io/tracing.py``) on the
CPU: off, they add no autograd node and open no range; on, under
``torch.profiler``, the flagship's folded step stays bitwise the same and
runs the same operations, and the trace holds ``train.step``,
``model.norm`` and the epoch's phase ranges where the work is; the counters are the epochs' own
counts. A VQ step opens the quantizer's two ranges and counts its calls
and vectors. Last, the benchmark's readers of them, and its attribution of
device time to host ranges (``bench_cuda/spans.py``), on hand-made input.
That the spans launch no kernel, and that the quantizer reads nothing back
to the host, is checked on a card."""

import dataclasses
import importlib.util
import json
import os
import sys
from contextlib import nullcontext

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from midi_vae_tpu_torch.data.pipeline import DeviceResidentLoader
from midi_vae_tpu_torch.data.sources import ArrayDataset
from midi_vae_tpu_torch.data.transforms import get_transform
from midi_vae_tpu_torch.io import tracing
from midi_vae_tpu_torch.io.logging import MetricLogger, PhaseTimer
from midi_vae_tpu_torch.losses.schedules import kl_weight_schedule
from midi_vae_tpu_torch.models.vae import apply_norm
from midi_vae_tpu_torch.train.config import from_yaml
from midi_vae_tpu_torch.train.graphs import StepGraphs
from midi_vae_tpu_torch.train.loop import build_run_model, build_run_optimizer, train_one_epoch
from midi_vae_tpu_torch.train.state import create_train_state, make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)  # the benchmark's readers import bench_cuda

from bench_cuda import counts_vq, spans  # noqa: E402
from bench_cuda.trace import Timeline  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402, F401 (autouse)

B, SEED, NORMS = 4, 7, 8  # the flagship's encoder and decoder hold 8 BatchNorms
VQ_NORMS = 6  # the VQ trunk's (fold 8, three widths): three in the encoder, two in the decoder, one in the head


def _config(**kw):
    cfg = from_yaml(os.path.join(ROOT, "configs", "folded.yaml"))
    return dataclasses.replace(cfg, fused=True, bce_targets="normalized", batch_size_per_device=B, seed=SEED,
                               models_dir=None, **kw)


def _train(config, device=torch.device("cpu")):
    """The flagship's model, state and step, as the train CLI builds them."""
    model = build_run_model(config, device, in_channels=1, seed=SEED)
    bundle = build_run_optimizer(config, model, B, 100)
    kl = kl_weight_schedule(config.kl_schedule, config.kld_weight, warmup_steps=config.kl_warmup_steps,
                            period=config.kl_cycle_steps, ramp_fraction=config.kl_ramp_fraction,
                            growth=config.kl_growth, cap=config.kl_cap)
    step = make_train_step(kl, fused_loss=True, grad_accum=config.grad_accum)
    return model, create_train_state(model, bundle), step


def _batch(device=torch.device("cpu")):
    g = torch.Generator().manual_seed(3)
    return ((torch.rand(B, 128, 128, 1, generator=g) > 0.9).float() - 0.5).to(device)


def _events(prof, tmp_path) -> list:
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def _ranges(events, name) -> list:
    return [e for e in events if e.get("name") == name and e.get("cat") == "user_annotation"]


def _nodes(t: torch.Tensor) -> list:
    """Every autograd node ``t`` depends on."""
    seen, todo = [], [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.append(fn)
        todo.extend(f for f, _ in fn.next_functions)
    return seen


@pytest.fixture(autouse=True)
def _forget_counters():
    """No test's counts outlive it."""
    yield
    tracing.reset()


def _a_norm_block(model):
    return next(m for m in model.modules() if getattr(m, "norm_name", None))


def test_off_adds_no_autograd_node_and_opens_no_range(monkeypatch):
    assert not tracing.enabled()
    assert tracing.span("train.step") is tracing.span("model.norm")
    model, state, step = _train(_config())
    block = _a_norm_block(model)
    norm = getattr(block, block.norm_name)
    x = torch.randn(B, norm.weight.shape[0], 16, 16, requires_grad=True)
    plain = _nodes(norm(x, True))
    y = apply_norm(block, x, True)
    assert [type(n).__name__ for n in _nodes(y)] == [type(n).__name__ for n in plain]
    assert not y._backward_hooks and not x._backward_hooks

    def no_range(*a, **k):
        raise AssertionError("a range opened with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    state, lo, _ = step(state, _batch(), 11)
    assert torch.isfinite(lo.loss)
    timer = PhaseTimer()
    timer.mark("dataloader")
    timer.close()


def test_on_the_norm_is_one_forward_range_and_no_node(tmp_path):
    model, _, _ = _train(_config())
    block = _a_norm_block(model)
    norm = getattr(block, block.norm_name)
    x = torch.randn(B, norm.weight.shape[0], 16, 16, requires_grad=True)
    plain = [type(n).__name__ for n in _nodes(norm(x, True))]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y = apply_norm(block, x, True)
        assert [type(n).__name__ for n in _nodes(y)] == plain and not y._backward_hooks
        y.float().sum().backward()
        with torch.no_grad():
            apply_norm(block, x, True)
    events = _events(prof, tmp_path)
    fwd0, fwd1 = _ranges(events, "model.norm")
    backward = [e for e in events if e.get("cat") == "cpu_op" and "Backward" in e["name"]]
    assert backward and all(fwd0["ts"] + fwd0["dur"] <= e["ts"] and e["ts"] + e["dur"] <= fwd1["ts"] for e in backward)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_profiled_step_is_bitwise_and_traced(grad_accum, tmp_path):
    """Two steps with and without a profiler: the same loss, gradients,
    parameters and buffers, bit for bit; the trace holds each step, and
    8 norm ranges per forward, all before the step's backward."""
    steps, x, out = 2, _batch(), {}
    for profiled in (False, True):
        model, state, step = _train(_config(grad_accum=grad_accum))
        prof = profile(activities=[ProfilerActivity.CPU]) if profiled else nullcontext()
        with prof:
            for _ in range(steps):
                state, lo, gn = step(state, x, 11)
        out[profiled] = (lo, gn, {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None},
                         {k: v.clone() for k, v in model.state_dict().items()})
    (lo0, gn0, g0, s0), (lo1, gn1, g1, s1) = out[False], out[True]
    for f in dataclasses.fields(lo0):
        assert torch.equal(getattr(lo0, f.name), getattr(lo1, f.name)), f.name
    assert torch.equal(gn0, gn1) and g0.keys() == g1.keys() and s0.keys() == s1.keys()
    assert all(torch.equal(g0[k], g1[k]) for k in g0) and all(torch.equal(s0[k], s1[k]) for k in s0)

    events = _events(prof, tmp_path)
    step_ranges = _ranges(events, "train.step")
    assert len(step_ranges) == steps
    fwd = _ranges(events, "model.norm")
    assert len(fwd) == NORMS * grad_accum * steps
    for r in fwd:
        assert any(s["ts"] <= r["ts"] and r["ts"] + r["dur"] <= s["ts"] + s["dur"] for s in step_ranges)
    bwd = [e for e in events if e["name"].startswith("autograd::engine::evaluate_function")]
    for s in step_ranges:  # a whole forward before the step's first backward
        first_bwd = min(e["ts"] for e in bwd if s["ts"] <= e["ts"] <= s["ts"] + s["dur"])
        assert sum(s["ts"] <= r["ts"] < first_bwd for r in fwd) == NORMS


def _ops(prof_events) -> list:
    return [e["name"] for e in sorted(prof_events, key=lambda e: e["ts"]) if e.get("cat") == "cpu_op"]


def test_spans_add_no_operation(monkeypatch, tmp_path):
    """A profiled step runs the same operations, in the same order, with
    the spans on as with them forced off: the tracer adds no kernel."""
    ops = {}
    for on in (True, False):
        if not on:
            monkeypatch.setattr(tracing, "enabled", lambda: False)
        model, state, step = _train(_config())
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step(state, _batch(), 11)
        events = _events(prof, tmp_path)
        assert bool(_ranges(events, "model.norm")) == on
        ops[on] = _ops(events)
    assert ops[True] and ops[True] == ops[False]


def test_profiled_remat_step_is_bitwise_and_traces_the_rerun_norms(tmp_path):
    """Under activation checkpointing the backward reruns each forward, and
    the rerun's norms are ranges too."""
    out = {}
    for profiled in (False, True):
        model, state, step = _train(_config(remat=True))
        prof = profile(activities=[ProfilerActivity.CPU]) if profiled else nullcontext()
        with prof:
            state, lo, gn = step(state, _batch(), 11)
        out[profiled] = (lo.loss, gn, {k: v.clone() for k, v in model.state_dict().items()})
    (l0, g0, s0), (l1, g1, s1) = out[False], out[True]
    assert torch.equal(l0, l1) and torch.equal(g0, g1) and all(torch.equal(s0[k], s1[k]) for k in s0)
    events = _events(prof, tmp_path)
    assert len(_ranges(events, "model.norm")) == 2 * NORMS


def _loader(n=12):
    g = np.random.default_rng(5)
    images = ((g.uniform(size=(n, 128, 128, 1)) > 0.9) * 255).astype(np.uint8)
    transform, _ = get_transform("pianoroll", 128, {"normalization": "midi-synthetic"})
    dataset = ArrayDataset(images=images, labels=np.zeros(n, np.int64), name="tracing", transform=transform)
    return DeviceResidentLoader(dataset, B, train=True, seed=SEED, device="cpu")


@pytest.mark.parametrize("scan_steps", [1, 2])
def test_epochs_trace_their_phases_and_count_steps_and_reads(scan_steps, tmp_path, capsys):
    """Two epochs of 3 batches through ``train_one_epoch`` under a profiler
    (per batch, and in chunks of 2): each phase range opened at a mark and
    closed at the next or at the epoch's end, each step inside a
    ``train.device_step``; the counters gain the epochs' steps and reads."""
    config = _config(scan_steps=scan_steps)
    model, state, step = _train(config)
    loader, logger = _loader(), MetricLogger(None)
    tracing.reset()
    stats = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for epoch in (1, 2):
            s, state, _, _ = train_one_epoch(config=config, model=model, state=state, train_step=step,
                                             loader=loader, logger=logger, epoch=epoch, epoch_seed=100 + epoch,
                                             lr_schedules=state.optimizer.lr_schedules)
            stats.append(s)
    assert tracing.counters() == {"train.steps": 2 * len(loader),
                                  "train.host_syncs": sum(s["host_syncs"] for s in stats),
                                  "norm.batch_calls": NORMS * 2 * len(loader)}
    events = _events(prof, tmp_path)
    counts = {p: len(_ranges(events, "train." + p)) for p in ("dataloader", "device_step", "logging")}
    if scan_steps == 1:  # each batch a print point: fetch, step, log, the log block's rest; a last fetch
        assert counts == {"dataloader": 2 * 4, "device_step": 2 * 6, "logging": 2 * 3}
    else:  # a step range before each chunk's read and after it; a log range for each of 2 chunks
        assert counts == {"dataloader": 0, "device_step": 2 * 3, "logging": 2 * 2}
    phases = [e for e in events if e["name"].startswith("train.") and e["name"] != "train.step"]
    phases.sort(key=lambda e: e["ts"])
    for a, b in zip(phases, phases[1:]):  # one phase at a time
        assert a["ts"] + a["dur"] <= b["ts"] + 1e-3
    steps = _ranges(events, "train.step")
    assert len(steps) == 2 * len(loader)
    device_steps = _ranges(events, "train.device_step")
    for s in steps:
        assert any(d["ts"] <= s["ts"] and s["ts"] + s["dur"] <= d["ts"] + d["dur"] for d in device_steps)


def test_counters_count_without_a_profiler(capsys):
    config = _config()
    model, state, step = _train(config)
    loader = _loader(8)
    tracing.reset()
    s, *_ = train_one_epoch(config=config, model=model, state=state, train_step=step, loader=loader,
                            logger=MetricLogger(None), epoch=3, epoch_seed=9,
                            lr_schedules=state.optimizer.lr_schedules)
    assert tracing.counters() == {"train.steps": 2, "train.host_syncs": s["host_syncs"],
                                  "norm.batch_calls": 2 * NORMS}
    tracing.reset()
    assert tracing.counters() == {}


def test_phase_timer_sums_are_unchanged_by_its_ranges():
    with profile(activities=[ProfilerActivity.CPU]):
        timer = PhaseTimer()
        for name in ("dataloader", "device_step", "dataloader", "logging"):
            timer.mark(name)
        timer.reset()  # clears the sums; the open range runs on
        timer.mark("device_step")
        timer.close()
        timer.close()
    assert set(timer.durations()) == set() and timer._open is None


# ------------------------------------------------------------- the readers


def _reader(name):
    spec = importlib.util.spec_from_file_location("reader_" + name.replace(".", "_"),
                                                  os.path.join(ROOT, "bench_cuda", "metrics", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _labelled(host):
    tl = Timeline(window=(0.0, 10.0), host=host)
    tl.device_ops = [("k", 1.0, 2.0), ("k", 3.0, 4.0)]
    tl.kernels = list(tl.device_ops)
    return tl


def test_loop_idle_share_reads_idle_outside_the_steps():
    read = _reader("loop_idle_share.train")
    # idle 0-1, 2-3, 4-10 (8 s); steps cover 0.5-1, 2-3 and 4-4.5 of it (2 s)
    host = [("train.step", 0.5, 2.5), ("aten::mul", 0.6, 0.7), ("train.step", 2.5, 4.5), ("train.logging", 5, 6)]
    assert read({"labelled": _labelled(host)}) == pytest.approx(60.0)
    inside = read({"labelled": _labelled([("train.step", 0.0, 10.0)])})
    assert inside == 0.0
    assert read({"labelled": None}) is None
    assert read({}) is None
    assert read({"labelled": _labelled([("aten::mul", 0.0, 1.0)])}) is None  # a program without the span


def test_host_syncs_per_step(monkeypatch):
    read = _reader("host_syncs_per_step.train")
    tracing.reset()
    assert read({}) is None
    tracing.count("train.steps", 8)
    tracing.count("train.host_syncs", 5)
    assert read({}) == pytest.approx(0.625)
    tracing.reset()
    monkeypatch.setitem(sys.modules, "midi_vae_tpu_torch.io.tracing", None)  # a program without the tracer
    assert read({}) is None


def test_graph_step_share(monkeypatch):
    read = _reader("graph_step_share.train")
    tracing.reset()
    tracing.count("train.steps", 8)
    assert read({}) is None  # a program without the counter
    tracing.count("train.graph_steps", 6)
    assert read({}) == pytest.approx(75.0)
    tracing.reset()
    assert read({}) is None
    monkeypatch.setitem(sys.modules, "midi_vae_tpu_torch.io.tracing", None)
    assert read({}) is None




# ------------------------------------------------------------- the quantizer


def _vq_train():
    """A narrow ``configs/vq16_fold8.yaml`` model (fold 8, a 16×16 grid of
    16 codes of dimension 4), its state and its VQ step."""
    cfg = dataclasses.replace(from_yaml(os.path.join(ROOT, "configs", "vq16_fold8.yaml")), hidden_dims=(8, 16, 32),
                              n_features=4, codebook_size=16, batch_size_per_device=B, seed=SEED, models_dir=None)
    model = build_run_model(cfg, torch.device("cpu"), in_channels=1, seed=SEED)
    step = make_train_step(kl_weight_schedule("constant", cfg.kld_weight), loss_type="vq",
                           target_denorm=((0.5,), (1.0,)))
    return model, create_train_state(model, build_run_optimizer(cfg, model, B, 100)), step


def test_vq_step_opens_the_quantizer_s_ranges_and_counts_its_vectors(monkeypatch, tmp_path):
    """Off, the quantizer's spans are the shared null context and a VQ step
    opens no range; on, it opens ``model.quantize`` and then
    ``model.codebook_update`` once each, inside ``train.step``. Each step
    counts one call of B·16·16 vectors, with a profiler or without, and its
    six BatchNorms (on the CPU, none fused)."""
    assert tracing.span("model.quantize") is tracing.span("model.codebook_update") is tracing._NULL
    model, state, step = _vq_train()
    n = B * 16 * 16
    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", lambda *a, **k: pytest.fail("a range opened off a profiler"))
        state, lo, _ = step(state, _batch(), 11)
    norms = {"norm.batch_calls": VQ_NORMS}
    assert torch.isfinite(lo.loss) and tracing.counters() == {"vq.calls": 1, "vq.vectors": n, **norms}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, _batch(), 11)
    assert tracing.counters() == {"vq.calls": 2, "vq.vectors": 2 * n, **{k: 2 * v for k, v in norms.items()}}
    events = _events(prof, tmp_path)
    (q,), (u,), (s,) = (_ranges(events, name) for name in ("model.quantize", "model.codebook_update", "train.step"))
    assert s["ts"] <= q["ts"] and q["ts"] + q["dur"] <= u["ts"] and u["ts"] + u["dur"] <= s["ts"] + s["dur"]


def _chrome(*events):
    """Chrome-trace events from (cat, name, ts, dur, correlation or None)."""
    out = []
    for cat, name, ts, dur, corr in events:
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1}
        if corr is not None:
            e["args"] = {"correlation": corr}
        out.append(e)
    return out


def _quantizer_trace():
    """The stretch, a step range holding the quantizer's two ranges and a
    second step range; kernels launched through the CUDA runtime and driver
    APIs, a copy and a fill, a launch outside every range and a kernel with
    no launch."""
    return _chrome(
        ("user_annotation", "bench_cuda.stretch", 0.0, 300.0, None),
        ("user_annotation", "train.step", 0.0, 100.0, None),
        ("user_annotation", "model.quantize", 10.0, 20.0, None),
        ("user_annotation", "model.codebook_update", 30.0, 10.0, None),
        ("user_annotation", "train.step", 200.0, 50.0, None),
        ("cuda_runtime", "cudaLaunchKernel", 5.0, 1.0, 1),
        ("cuda_runtime", "cudaLaunchKernel", 12.0, 1.0, 2),
        ("cuda_driver", "cuLaunchKernel", 32.0, 1.0, 3),
        ("cuda_runtime", "cudaMemcpyAsync", 25.0, 1.0, 4),
        ("cuda_runtime", "cudaLaunchKernel", 150.0, 1.0, 5),
        ("cuda_runtime", "cudaLaunchKernel", 210.0, 1.0, 6),
        ("kernel", "k_step", 7.0, 3.0, 1),
        ("kernel", "k_distances", 20.0, 5.0, 2),
        ("kernel", "k_ema", 40.0, 7.0, 3),
        ("gpu_memcpy", "Memcpy DtoD", 41.0, 2.0, 4),
        ("kernel", "k_outside", 150.0, 100.0, 5),
        ("gpu_memset", "Memset", 215.0, 4.0, 6),
        ("kernel", "k_orphan", 60.0, 9.0, 77),
    )


def test_spans_attribute_device_time_to_the_ranges_that_launched_it():
    """Device time goes to every range its launch lies in, by Kineto's
    correlation, whenever the device runs it: nested ranges each, a name's
    ranges once, and nothing to a launch outside them or a kernel without one."""
    got = spans.attribute(_quantizer_trace())
    assert set(got) == {"bench_cuda.stretch", "train.step", "model.quantize", "model.codebook_update"}
    assert got["bench_cuda.stretch"] == (1, pytest.approx((3 + 5 + 7 + 2 + 100 + 4) * 1e-6))
    assert got["train.step"] == (2, pytest.approx((3 + 5 + 7 + 2 + 4) * 1e-6))
    assert got["model.quantize"] == (1, pytest.approx((5 + 2) * 1e-6))
    assert got["model.codebook_update"] == (1, pytest.approx(7e-6))


def test_quantizer_readers():
    share, roofline = _reader("quantizer_device_share.train"), _reader("quantizer_roofline")
    labelled = spans.Labelled(_quantizer_trace())
    vq = {"codes": 512, "dim": 16, "z_bytes": 2}
    assert share({"spans": labelled}) == pytest.approx(100.0 * 14 / 21)
    tracing.reset()
    assert roofline({"spans": labelled, "vq": vq}) is None  # a program without the counters
    tracing.count("vq.calls", 4)
    tracing.count("vq.vectors", 4 * 524_288)
    least = counts_vq.least_seconds(524_288, 512, 16, 2)
    assert least == pytest.approx(2 * 524_288 * 512 * 16 / 67e12)  # f64 cross term, compute-bound: ~0.128 ms
    assert roofline({"spans": labelled, "vq": vq}) == pytest.approx(100.0 * least / 14e-6)
    bare = spans.Labelled(_chrome(("user_annotation", "bench_cuda.stretch", 0.0, 300.0, None),
                                  ("user_annotation", "train.step", 0.0, 100.0, None),
                             ("cuda_runtime", "cudaLaunchKernel", 5.0, 1.0, 1), ("kernel", "k", 7.0, 3.0, 1)))
    for read in (share, roofline):  # a program without the quantizer's spans
        assert read({"spans": bare, "vq": vq}) is None and read({}) is None


@pytest.mark.card
def test_on_a_card_the_training_quantizer_reads_nothing_back():
    """On a card: ``bincount`` of the codes reads their range back to the
    host (a sync), and a train-mode quantizer call makes none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: host syncs are a CUDA stream's")
    from midi_vae_tpu_torch.models.vq import VectorQuantizerEMA

    dev = torch.device("cuda", 0)
    q = VectorQuantizerEMA(512, 16, generator=torch.Generator().manual_seed(0)).to(dev)
    z = torch.randn(64, 16, 16, 16, generator=torch.Generator(device=dev).manual_seed(1), device=dev,
                    dtype=torch.bfloat16)
    idx = q(z, False)[1].reshape(-1)
    cb = q.codebook.clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):
            torch.bincount(idx, minlength=512)
        z_st, _ = q(z, True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(z_st).all() and not torch.equal(q.codebook, cb)


def test_on_a_card_spans_launch_no_kernel(monkeypatch, tmp_path):
    """On a card: the spans are on in a CUDA-only session too; a profiled
    step holds one step range and 8 norm ranges, and launches as many
    kernels with the spans on as with them forced off. The step is the
    eager one: a graphed step's norm ranges open only at its capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernels are counted in a CUDA trace")
    monkeypatch.setattr(StepGraphs, "engages", lambda self, model: False)
    dev = torch.device("cuda", 0)
    model, state, step = _train(_config(), dev)
    x = _batch(dev)
    state, *_ = step(state, x, 11)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, *_ = step(state, x, 11)
    events = _events(prof, tmp_path)
    assert len(_ranges(events, "train.step")) == 1 and len(_ranges(events, "model.norm")) == NORMS
    kernels = []
    for on in (True, False):
        with profile(activities=[ProfilerActivity.CUDA]) as prof, monkeypatch.context() as m:
            assert tracing.enabled()
            if not on:
                m.setattr(tracing, "enabled", lambda: False)
            state, *_ = step(state, x, 11)
            torch.cuda.synchronize()
        kernels.append(sum(e.get("cat") == "kernel" for e in _events(prof, tmp_path)))
    assert kernels[0] == kernels[1] > 0

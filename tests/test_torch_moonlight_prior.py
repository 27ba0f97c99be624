"""The port's Moonlight prior (``models/moe_prior.py``: Moonlight-16B-A3B's
block of latent attention and sigmoid-routed experts as a stage-2 code
prior) against the benchmark's plain reference
(``bench_cuda/reference/moonlight_prior.py``), on the CPU at a tiny size
of the same block: hidden 64, 4 heads (no-RoPE 16, RoPE 8, values 16),
latent 32, dense width 128, 8 routed experts of width 32 with top-2 and
2 shared, 2 layers (one dense, one MoE), a 4×4 grid of 16 codes, from
the reference's seeded weights, in f32. Then the trainer's step and
loop, the CLI, ``load_prior``, ``generate --prior``, the sampler, the
tracing, the benchmark's counts and readers, and the cell's driver with
its faults.

Tolerances, f32 on both sides, and why: the logits within 2e-5 (the
port's attention is ``scaled_dot_product_attention``, the reference's an
explicit softmax; they differ in the order of the f32 sums, a few ulps
at each of the two layers); the NLL and balance loss within 1e-6
relative; every gradient within rtol 1e-4, atol 1e-6 (the same sums, one
pass back), and the parameters after two Adam steps within 2·lr (Adam
steps a value by about lr however small its gradient, so a gradient of
rounding size can step either way); the routing biases after two steps
exactly (each is γ times a sum of signs of integer loads, and the
routing agrees). Causality and the
expert shares are held within 1e-6 (the shares: only the order in which
the experts' f32 parts are summed differs).
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_cuda import counts_prior, run as bench_run  # noqa: E402
from bench_cuda.reference import moonlight_prior as ref  # noqa: E402
from midi_vae_tpu_torch.cli import generate, train_prior  # noqa: E402
from midi_vae_tpu_torch.cli.train import cli as train_cli  # noqa: E402
from midi_vae_tpu_torch.core.sampling import sample_codes_autoregressive  # noqa: E402
from midi_vae_tpu_torch.io import tracing  # noqa: E402
from midi_vae_tpu_torch.models import moe_prior  # noqa: E402
from midi_vae_tpu_torch.models.moe_prior import MoonlightWidths, parse_held  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402, F401 (autouse)

CELL, SEED = "vq16_moonlight_prior.train_b256", 3_000_000_037
TINY = dict(hidden_size=64, num_attention_heads=4, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
            kv_lora_rank=32, intermediate_size=128, moe_intermediate_size=32, n_routed_experts=8,
            num_experts_per_tok=2)
WIDTHS = MoonlightWidths(**TINY)
K, S = 16, 4


def _cfg(held="0:8", layers=2, classes=0, codes=K, grid=S):
    """The cell's configuration file at the tiny size, in f32."""
    cfg = json.load(open(os.path.join(ROOT, "bench_cuda", "configs", "vq16_moonlight_prior.json")))
    cfg.update({k: v for k, v in TINY.items() if k != "n_routed_experts"})
    cfg.update(n_routed_experts_published=TINY["n_routed_experts"], num_hidden_layers=layers, vocab_size=codes)
    cfg["prior"].update(grid=grid, dtype="float32", experts_held=held, num_classes=classes)
    return cfg


def _prior(held="0:8", layers=2, classes=0, seed=SEED):
    """(port prior, its reference configuration, the reference's weights, in the prior)."""
    cfg = _cfg(held, layers, classes)
    prior = train_prior.build_prior("moonlight", num_codes=K, grid=S, features=0, layers=layers,
                                    num_classes=classes, experts_held=held, widths=WIDTHS)
    p0 = ref.make_weights(cfg, seed, torch.device("cpu"))
    with torch.no_grad():
        for name, p in prior.named_parameters():
            p.copy_(p0[name])
    return prior, cfg, p0


def _grids(n=24, seed=0):
    return torch.randint(0, K, (n, S, S), generator=torch.Generator().manual_seed(seed))


def test_spec_names_the_port_s_leaves_and_buffers():
    prior, cfg, _ = _prior("2:6", classes=3)
    params, buffers = ref.spec(cfg)
    assert [n for n, _, _ in params] == [n for n, _ in prior.named_parameters()]
    assert {n: tuple(s) for n, s, _ in params} == {n: tuple(p.shape) for n, p in prior.named_parameters()}
    assert {n: tuple(s) for n, s, _ in buffers} == {n: tuple(b.shape) for n, b in prior.named_buffers()
                                                    if n.endswith("router.bias")}


@pytest.mark.parametrize("held,classes", [("0:8", 0), ("2:6", 0), ("0:8", 3)], ids=["all", "share", "conditional"])
def test_logits_and_loss_match_the_reference(held, classes):
    prior, cfg, p0 = _prior(held, classes=classes)
    idx, y = _grids(6), torch.arange(6) % 3 if classes else None
    logits, aux, loads, _ = prior.forward_train(idx, y)
    r_logits, r_aux, r_loads, _ = ref.Model(cfg).forward(p0, ref.zero_bias(cfg, "cpu"), idx, y)
    torch.testing.assert_close(logits, r_logits, rtol=0.0, atol=2e-5)
    torch.testing.assert_close(aux, r_aux, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(ref.nll(logits, idx), ref.nll(r_logits, idx), rtol=1e-6, atol=0.0)
    assert torch.equal(loads, r_loads)


def _steps(prior, cfg, p0, grids, steps):
    """The trainer's step ``steps`` times on consecutive batches of 8; the
    first gradients and the outputs."""
    opt = torch.optim.Adam(prior.parameters(), lr=float(cfg["prior"]["lr"]))
    step = train_prior.make_prior_step(prior, opt, grids)
    outs, first = [], None
    for t in range(steps):
        outs.append(step(torch.arange(8 * t, 8 * t + 8)))
        if t == 0:
            first = {k: p.grad.clone() for k, p in prior.named_parameters()}
    return outs, first


def test_every_gradient_and_the_bias_after_two_steps_match_the_reference():
    prior, cfg, p0 = _prior()
    grids = _grids()
    outs, first = _steps(prior, cfg, p0, grids, 2)
    r = ref.train_steps(cfg, p0, [grids[0:8], grids[8:16]], steps=2)
    torch.testing.assert_close(torch.tensor([float(o[0]) for o in outs]), torch.tensor(r["losses"]), rtol=1e-6, atol=0)
    for k, g in r["first_grads"].items():
        torch.testing.assert_close(first[k], g, rtol=1e-4, atol=1e-6, msg=k)
    # Adam's first steps are ±lr a value whatever the gradient's size, so a value whose gradient is of
    # rounding size can step either way: the parameters are held within two steps of lr
    lr = float(cfg["prior"]["lr"])
    for k, p in prior.named_parameters():
        torch.testing.assert_close(p.detach(), r["params"][k], rtol=0.0, atol=2 * lr, msg=k)
    for name, m in prior.named_modules():
        if name.endswith("router"):
            assert torch.equal(m.bias, r["bias"][f"{name}.bias"]) and m.bias.abs().sum() > 0


def test_the_step_reports_the_nll_and_the_held_counts():
    prior, cfg, p0 = _prior("2:6")
    grids = _grids(8)
    idx = grids[torch.arange(8)]
    with torch.no_grad():
        logits, _, loads, _ = prior.forward_train(idx)
    out, _ = _steps(prior, cfg, p0, grids, 1)
    held = loads[:, 2:6]
    assert float(out[0][0]) == pytest.approx(float(ref.nll(logits, idx)), rel=1e-6)
    assert out[0][1:].tolist() == [float(held.sum()), float(held.max(1).values.sum())]


@pytest.mark.parametrize("t", [0, 5, 15])
def test_logits_at_t_see_only_codes_before_t(t):
    prior, _, _ = _prior()
    idx = _grids(3)
    changed = idx.clone().reshape(3, -1)
    changed[:, t:] = (changed[:, t:] + 1 + torch.arange(changed.shape[1] - t)) % K
    a = prior(idx).reshape(3, S * S, K)
    b = prior(changed.reshape(3, S, S)).reshape(3, S * S, K)
    torch.testing.assert_close(a[:, : t + 1], b[:, : t + 1], rtol=0.0, atol=1e-6)
    assert not torch.allclose(a[:, t + 1:], b[:, t + 1:]) or t == S * S - 1


@pytest.mark.parametrize("shares", [[(0, 8)], [(0, 4), (4, 8)], [(0, 2), (2, 5), (5, 8)]], ids=["one", "two", "three"])
def test_expert_shares_add_up_to_the_uncut_layer(shares):
    """The held experts' parts of every share, with the shared expert once,
    are the reference's whole layer over all 8 experts."""
    cfg = _cfg("0:8")
    p0 = ref.make_weights(cfg, SEED, torch.device("cpu"))
    x = torch.randn(48, TINY["hidden_size"], generator=torch.Generator().manual_seed(1))
    whole, _, _, _ = ref.Model(cfg)._moe(p0, ref.zero_bias(cfg, "cpu"), "layers.1.ffn.", x, 3)
    total, shared = torch.zeros_like(x), None
    for lo, hi in shares:
        prior = train_prior.build_prior("moonlight", num_codes=K, grid=S, features=0, layers=2,
                                        experts_held=f"{lo}:{hi}", widths=WIDTHS)
        moe = prior.layers[1].ffn
        with torch.no_grad():
            for name, p in moe.named_parameters():
                full = p0[f"layers.1.ffn.{name}"]
                p.copy_(full[lo:hi] if name in ("gate_proj", "up_proj", "down_proj") else full)
            out, _, _, _ = moe(x.reshape(3, 16, -1))
            shared = moe.shared(x)
        total += out.reshape(x.shape) - shared
    torch.testing.assert_close(total + shared, whole, rtol=0.0, atol=1e-6)


def test_rows_past_the_groups_never_reach_a_token(monkeypatch):
    """The grouped GEMM leaves rows past the last group unwritten: filled
    with NaN here, the layer's output and every gradient stay those of a
    clean run."""
    real = moe_prior.grouped_linear

    def poisoned(x, w, ends):
        out = real(x, w, ends).clone()
        out[int(ends[-1]):] = float("nan")
        return out

    def run():
        prior, _, _ = _prior("2:6")
        logits = prior(_grids(4))
        logits.square().mean().backward()
        return logits.detach(), {k: p.grad.clone() for k, p in prior.named_parameters()}

    clean = run()
    monkeypatch.setattr(moe_prior, "grouped_linear", poisoned)
    dirty = run()
    assert torch.equal(clean[0], dirty[0])
    for k, g in clean[1].items():
        assert torch.isfinite(dirty[1][k]).all() and torch.equal(g, dirty[1][k]), k


@pytest.mark.parametrize("text,ok", [("0:8", (0, 8)), ("8:16", (8, 16)), ("0:64", None), ("3:3", None), ("a:b", None)])
def test_parse_held(text, ok):
    if ok:
        assert parse_held(text, 16) == ok
    else:
        with pytest.raises(ValueError):
            parse_held(text, 16)


def test_the_epoch_loop_reads_once_a_chunk_and_is_the_same_for_any_chunk():
    outs = []
    for chunk in (1, 3):
        prior, _, _ = _prior()
        opt = torch.optim.Adam(prior.parameters(), lr=3e-4)
        step = train_prior.make_prior_step(prior, opt, _grids(40))
        tracing.reset()
        nlls = train_prior.train_prior_epoch(step, n=40, bs=8, seed=5, epoch=2, device="cpu", scan_steps=chunk)
        counts = tracing.counters()
        outs.append((nlls, {k: p.detach().clone() for k, p in prior.named_parameters()}))
        assert len(nlls) == 5 and counts["prior.steps"] == 5 and counts["moe.calls"] == 5
        assert counts["moe.assignments"] == 5 * 8 * S * S * TINY["num_experts_per_tok"]
        assert counts["moe.held_assignments"] == counts["moe.assignments"]  # all 8 experts held
        assert 0 < counts["moe.held_max"] <= counts["moe.held_assignments"]
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    for k, p in outs[0][1].items():
        assert torch.equal(p, outs[1][1][k]), k
    tracing.reset()


def test_spans_open_only_under_a_profiler(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    prior, _, _ = _prior()
    opt = torch.optim.Adam(prior.parameters(), lr=3e-4)
    step = train_prior.make_prior_step(prior, opt, _grids(16))
    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", lambda *a, **k: pytest.fail("a range opened off a profiler"))
        step(torch.arange(8))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(torch.arange(8, 16))
    names = [e.name for e in prof.events() if e.name.startswith("prior.")]
    assert names.count("prior.step") == 1 and names.count("prior.attention") == 2
    assert names.count("prior.moe.route") == 1 and names.count("prior.moe.experts") == 1
    tracing.reset()


def test_sampler_draws_code_grids():
    prior, _, _ = _prior()
    prior.eval()
    codes = sample_codes_autoregressive(prior, 0, 2, S, temperature=0.9)
    assert codes.shape == (2, S, S) and codes.dtype == torch.int32 and int(codes.max()) < K


# ------------------------------------------------------------------ the CLI

TRAIN = ["--dataset", "vae-lines-synthetic", "--transform-type", "noaug", "--image-size", "32", "--model",
         "FoldedVQVAE", "--fold", "2", "--hidden-dims", "8", "16", "--n_features", "4", "--codebook-size", "16",
         "--kld-weight", "0.25", "--epochs", "1", "--batch-size", "64", "--seed", "0", "--cpu"]


def test_cli_trains_reloads_and_samples_a_moonlight_prior(tmp_path, monkeypatch):
    """One epoch of ``--prior-arch moonlight`` over a VQ checkpoint (the
    published widths patched to the tiny ones), ``load_prior`` with its
    arch, depth and share, and ``generate --prior``."""
    monkeypatch.setattr(moe_prior, "MOONLIGHT", WIDTHS)
    train_cli(TRAIN + ["--models-dir", str(tmp_path / "m"), "--run-name", "vq", "--run-id", "1"])
    ckpt = str(tmp_path / "m" / "vae-lines-synthetic" / "vq__1" / "checkpoint_latest.pt")
    with pytest.raises(SystemExit, match="--experts-held"):
        train_prior.cli(["--checkpoint", ckpt, "--cpu", "--prior-arch", "moonlight", "--experts-held", "4:2"])
    out = str(tmp_path / "prior.pt")
    with contextlib.redirect_stdout(io.StringIO()):
        p = train_prior.cli(["--checkpoint", ckpt, "--out", out, "--epochs", "1", "--batch-size", "32", "--cpu",
                             "--prior-arch", "moonlight", "--layers", "2", "--experts-held", "2:6"])
    assert np.isfinite(p["history"][0]["nll"]) and p["test_nll"] is not None
    prior, pcfg = train_prior.load_prior(out, device="cpu")
    assert (pcfg["arch"], pcfg["layers"], pcfg["experts_held"]) == ("moonlight", 2, "2:6")
    assert type(prior).__name__ == "MoonlightPrior" and prior.held == (2, 6) and len(prior.layers) == 2
    assert any(m.router.bias.abs().sum() > 0 for m in prior.moe_layers())  # the trained routing bias came back
    sampled = generate.cli(["--checkpoint", ckpt, "--cpu", "-n", "2", "--prior", out, "--out", os.devnull])
    assert sampled.shape == (2, 32, 32, 1) and np.isfinite(sampled).all()


# ------------------------------------------------------------ the benchmark


def test_step_flops_count_the_reference_s_matmuls():
    """``counts_prior`` against ``torch.utils.flop_counter`` over the
    reference's forward and backward: with every held expert counted for
    every token and every key for every query, as the reference computes
    them."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = _cfg("2:6")
    p0 = {k: v.requires_grad_(True) for k, v in ref.make_weights(cfg, SEED, torch.device("cpu")).items()}
    idx = _grids(2)
    with FlopCounterMode(display=False) as counter:
        logits, aux, _, _ = ref.Model(cfg).forward(p0, ref.zero_bias(cfg, "cpu"), idx)
        torch.autograd.grad(ref.nll(logits, idx) + aux, list(p0.values()))
    per_token = counts_prior.forward_flops_per_token(cfg, keys=S * S, held_per_token=4)
    assert counter.get_total_flops() == pytest.approx(3 * 2 * S * S * per_token, rel=1e-9)
    held = TINY["num_experts_per_tok"] * 4 / TINY["n_routed_experts"]
    assert counts_prior.step_flops(cfg, 2) == pytest.approx(
        3 * 2 * S * S * counts_prior.forward_flops_per_token(cfg, keys=(S * S + 1) / 2, held_per_token=held))


class _Spans:
    def __init__(self, by_range):
        self.by_range = by_range

    def ranges(self, name):
        return self.by_range.get(name, (0, 0.0))[0]

    def device_s(self, name):
        return self.by_range.get(name, (0, 0.0))[1]


def _reader(name):
    return bench_run.load_file(f"bench_cuda/metrics/{name}.py", "reader_" + name.replace(".", "_"))


def test_readers_read_the_spans_and_nothing_from_a_program_without_them(monkeypatch):
    spans = _Spans({"prior.step": (4, 0.8), "prior.attention": (20, 0.1), "prior.moe.route": (16, 0.02),
                    "prior.moe.experts": (16, 0.2)})
    assert _reader("mla_device_share.train").read({"spans": spans}) == pytest.approx(12.5)
    assert _reader("moe_device_share.train").read({"spans": spans}) == pytest.approx(27.5)
    traced = {"window": {"seconds": 2.0, "steps": 10}, "flops_per_step": 1e14, "peak_flops": 989e12}
    assert _reader("prior_mfu.train").read(traced) == pytest.approx(100 * 1e15 / 2.0 / 989e12)
    cfg = _cfg()
    monkeypatch.setattr(tracing, "counters", lambda: {"moe.calls": 10, "moe.held_assignments": 500})
    moe = {"config": cfg, "tokens": 256}
    want = 100 * counts_prior.experts_call_least_seconds(cfg, 50, 256) / (0.2 / 16)
    assert _reader("moe_roofline").read({"spans": spans, "moe": moe}) == pytest.approx(want)
    empty = _Spans({"train.step": (4, 0.8)})
    for name in ("mla_device_share.train", "moe_device_share.train", "moe_roofline"):
        assert _reader(name).read({"spans": empty, "moe": moe}) is None
    assert _reader("prior_mfu.train").read({}) is None


def _driver_ctx(fault=None):
    cfg = _cfg("0:8", codes=512, grid=16)
    stage1 = json.load(open(os.path.join(ROOT, "bench_cuda", "configs", "vq16_fold8.json")))
    stage1["train"].update(hidden_dims=[8, 16, 32], dtype="float32")
    cfg["stage1"] = stage1
    wl = json.load(open(os.path.join(ROOT, "bench_cuda", "workloads", f"{CELL}.json")))
    wl["traffic"].update(batch=8, corpus=32, trace_steps=2)
    return SimpleNamespace(config=cfg, workload=wl, device=torch.device("cpu"), seed=SEED, fault=fault, reference=ref,
                           seconds=0.1, trace=False, t_start=0.0, mark=lambda what: None, log=lambda msg: None,
                           sync=lambda: None, memory_peak=lambda: 0)


@pytest.mark.parametrize("fault", [None, "half_batch", "lr_high", "top5", "scale1", "rope_off"])
def test_the_cell_is_correct_only_when_sound(fault):
    """The cell's driver end to end at the tiny size in f32 (the limits are
    the card's, set for bf16 at full width), outside ``run.py``, which
    refuses a process that holds JAX: sound, every number under its limit;
    with each fault planted, at least one over."""
    ctx = _driver_ctx(fault)
    drv = bench_run.load_file("bench_cuda/drivers/train_prior.py", "bench_cuda_driver_train_prior")
    with contextlib.redirect_stderr(io.StringIO()):
        out = drv.run(ctx)
    over = {name for name, value, limit in out["checks"] if not value <= limit}
    assert (not over) == (fault is None), out["checks"]
    assert set(out["e2e"]) == {"setup_s", "train_samples_per_s"} and out["attempted"] > 0 and out["failed"] == 0
    assert [name for name, _, _ in out["checks"]] == list(ctx.workload["limits"])
    tracing.reset()


def test_reference_and_counts_load_neither_jax_nor_the_port():
    code = ("import sys; sys.path.insert(0, {root!r})\n"
            "import bench_cuda.reference.moonlight_prior, bench_cuda.counts_prior\n"
            "print(sorted({{m.split('.')[0] for m in sys.modules}}))").format(root=ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, timeout=300, check=True)
    mods = set(eval(p.stdout.strip().splitlines()[-1]))
    assert "torch" in mods and not mods & {"jax", "jaxlib", "flax", "midi_vae_tpu", "midi_vae_tpu_torch"}

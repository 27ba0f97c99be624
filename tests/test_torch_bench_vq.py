"""The benchmark's plain reference of the VQ-VAE (``bench_cuda/reference/vq.py``)
against the port's FoldedVQVAE, on the CPU at a small size (fold 8, hidden
(8, 16, 32), the configuration's 512 codes of dimension 16, batch 8), from
the benchmark's seeded weights and one seeded codebook; then the cell's
driver end to end, sound and with faults planted, and the reference's
imports.

Tolerances, in f32 on both sides: what is left between the two is the order
of sums (the convolutions' algorithms and padding, BatchNorm's statistics,
the EMA sums: the port's f32 scatter-add, the reference's f64 sums rounded
once), a few f32 ulps a value; the codes must be equal.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_cuda import frozen, run  # noqa: E402
from bench_cuda.reference import vq  # noqa: E402
from midi_vae_tpu_torch.losses.vq import vq_loss  # noqa: E402
from midi_vae_tpu_torch.train.config import TrainConfig  # noqa: E402
from midi_vae_tpu_torch.train.loop import build_run_model  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402, F401 (autouse)

CELL, SEED = "vq16_fold8.train_b2048", 3_000_000_031


def _small(dtype="float32"):
    cfg = json.load(open(os.path.join(ROOT, "bench_cuda", "configs", "vq16_fold8.json")))
    wl = json.load(open(os.path.join(ROOT, "bench_cuda", "workloads", f"{CELL}.json")))
    cfg["train"].update(hidden_dims=[8, 16, 32], dtype=dtype)
    wl["traffic"].update(batch=8, corpus=32, trace_steps=2)
    return cfg, wl


def _driver():
    return run.load_file("bench_cuda/drivers/train_vq.py", "bench_cuda_driver_train_vq")


def _built(fault=None):
    cfg, wl = _small()
    ctx = SimpleNamespace(config=cfg, workload=wl, device=torch.device("cpu"), seed=SEED, fault=fault, reference=vq,
                          mark=lambda what: None)
    drv = _driver()
    return ctx, drv, drv.build(ctx)


def test_spec_names_the_port_model_s_leaves():
    cfg = json.load(open(os.path.join(ROOT, "bench_cuda", "configs", "vq16_fold8.json")))["train"]
    model = build_run_model(TrainConfig.from_dict(cfg), torch.device("cpu"), in_channels=1, seed=0)
    params, buffers = vq.spec(cfg)
    assert [n for n, _, _ in params] == [n for n, _ in model.named_parameters()]
    assert {n: tuple(s) for n, s, _ in params} == {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert {n: tuple(s) for n, s, _ in buffers} == {n: tuple(b.shape) for n, b in model.named_buffers()}


def test_forward_matches_the_port():
    """One train-mode forward from the seeded weights and codebook: logits,
    z_e and the VQ loss within f32 rounding, the codes equal."""
    ctx, drv, r = _built()
    model, cfg = r["model"], drv.train_config(ctx)
    order = frozen.train_order(SEED, 1, len(r["corpus"]), r["B"])
    x = frozen.pianoroll_train_transform(r["corpus"][torch.as_tensor(order[0])], frozen.transform_seed(SEED, 1, 0))
    codes = []
    hook = model.quantizer.register_forward_hook(lambda m, a, out: codes.append(out[1].reshape(-1)))
    out = model(x, train=True)
    hook.remove()
    loss = vq_loss(out, 0.25, target_denorm=((0.5,), (1.0,)))
    logits, z_e, z_st, idx = vq.Model(cfg).forward_train(r["p0"], x, r["b0"]["quantizer.codebook"])
    ref_loss, ref_recon, ref_commit = vq.vq_loss(logits, x, z_e, z_st, 0.25)
    assert torch.equal(codes[0], idx)
    torch.testing.assert_close(out.logits.float(), logits.float(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out.encoded.mu, z_e.reshape(len(x), -1), rtol=1e-5, atol=1e-6)
    for ours, ref in ((loss.loss, ref_loss), (loss.reconstruction_loss, ref_recon), (loss.kl, ref_commit)):
        torch.testing.assert_close(ours, ref, rtol=1e-6, atol=0.0)


def test_three_steps_match_the_port():
    """Three AdamW steps: losses and commitment terms, the first gradients,
    the change of every leaf that moves (the check's numbers), and the
    three buffers."""
    ctx, drv, r = _built()
    with contextlib.redirect_stdout(io.StringIO()):
        drv.epoch(r, 1, r["kept_step"], drv._Head(r["loader"], drv.CHECK_STEPS))
    prog = drv.program_side(r)
    drv.free_program(r)
    ref = drv.reference_side(ctx, r)
    for k in ("losses", "kls"):
        torch.testing.assert_close(torch.tensor(prog[k]), torch.tensor(ref[k]), rtol=1e-6, atol=0.0)
    assert prog["kl_weights"] == ref["kl_weights"] == [0.25] * 3
    for k, g in ref["first_grads"].items():  # atol: the conv biases under BatchNorm get gradients of rounding alone
        torch.testing.assert_close(prog["first_grads"][k], g, rtol=1e-4, atol=1e-7)
    # atol: Adam turns those rounding gradients into steps of up to the learning rate (here under 1e-5)
    for k, p in ref["params"].items():
        torch.testing.assert_close(prog["params"][k], p, rtol=1e-5, atol=1e-5)
    nums = drv.numbers(ctx, r, prog, ref)
    # grad and change: a leaf's norm gap over the larger of its norm and the median leaf's
    assert nums["grad"] < 1e-4 and nums["change"] < 1e-4 and nums["change_median"] < 1e-6, nums
    assert nums["codebook"] < 1e-6 and nums["codes1"] == 0.0, nums
    assert torch.equal(prog["buffers"]["quantizer.cluster_size"], ref["buffers"]["quantizer.cluster_size"])
    # steps 2 and 3 quantize z_e from parameters a step of Adam apart, which turns the rounding of
    # near-zero gradients (conv biases under BatchNorm) into steps of ±lr: sums of ~1 agree to ~2e-6
    for name in ("quantizer.codebook", "quantizer.embed_avg"):
        torch.testing.assert_close(prog["buffers"][name], ref["buffers"][name], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fault", [None, "half_batch", "ema_decay_low"])
def test_the_cell_is_correct_only_when_sound(fault):
    """The cell's driver end to end, in f32 (the limits are the card's, set
    for bf16 at full width; narrow bf16 leaves read ``grad`` higher), and
    outside ``run.py``, which refuses a process that holds JAX, as this one
    does: sound, every number under its limit; with half the batch
    stepped, or the codebook's EMA at decay 0.9, at least one over."""
    cfg, wl = _small()
    ctx = SimpleNamespace(config=cfg, workload=wl, device=torch.device("cpu"), seed=SEED, fault=fault, reference=vq,
                          seconds=0.1, trace=False, t_start=0.0, mark=lambda what: None, log=lambda msg: None,
                          sync=lambda: None, memory_peak=lambda: 0)
    with contextlib.redirect_stderr(io.StringIO()):
        out = _driver().run(ctx)
    over = {name for name, value, limit in out["checks"] if not value <= limit}
    assert (not over) == (fault is None), out["checks"]
    assert set(out["e2e"]) == {"setup_s", "train_samples_per_s"} and out["attempted"] > 0 and out["failed"] == 0
    assert [name for name, _, _ in out["checks"]] == list(wl["limits"])
    if fault == "ema_decay_low":
        assert "codebook" in over


def test_reference_loads_neither_jax_nor_the_port():
    code = ("import sys; sys.path.insert(0, {root!r})\n"
            "import bench_cuda.reference.vq, bench_cuda.counts_vq, bench_cuda.spans\n"
            "print(sorted({{m.split('.')[0] for m in sys.modules}}))").format(root=ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, timeout=300, check=True)
    mods = set(eval(p.stdout.strip().splitlines()[-1]))
    assert "torch" in mods and not mods & {"jax", "jaxlib", "flax", "midi_vae_tpu", "midi_vae_tpu_torch"}

"""The plain reference against the port's first training steps, at narrow
widths on the CPU."""

import contextlib
import io
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench_cuda import check, frozen, run, weights
from bench_cuda.reference import vae

CELLS = ["folded_fold8.train_b2048", "vanilla_midi.train_b2048"]


def _ctx(config, workload, seed, fault=None):
    return SimpleNamespace(config=config, workload=workload, device=torch.device("cpu"), seed=seed, fault=fault,
                           reference=vae, mark=lambda what: None)


def _driver(name):
    return run.load_file(f"bench_cuda/drivers/{name}.py", f"bench_cuda_driver_{name}")


@pytest.mark.parametrize("cell", CELLS)
def test_spec_names_the_port_model_s_leaves(cell, small):
    from midi_vae_tpu_torch.train.config import TrainConfig
    from midi_vae_tpu_torch.train.loop import build_run_model

    cfg, _ = small(cell)
    cfg = {**cfg["train"], "hidden_dims": [48, 64, 128, 256] if cfg["train"]["arch"] == "FoldedVAE" else [32, 64, 128, 256]}
    model = build_run_model(TrainConfig.from_dict(cfg), torch.device("cpu"), in_channels=1, seed=0)
    params, buffers = vae.spec(cfg)
    assert {n: tuple(s) for n, s, _ in params} == {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert {n: tuple(s) for n, s, _ in buffers} == {
        n: tuple(b.shape) for n, b in model.named_buffers() if n.endswith(("running_mean", "running_var"))}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("dtype,tol", [("float32", {"loss": 2e-6, "grad": 2e-4, "change": 2e-3}),
                                       ("bfloat16", {"loss": 1e-4, "grad": 0.1, "change": 0.2})])
def test_reference_steps_hold_the_port_s_first_steps(cell, dtype, tol, small):
    cfg, wl = small(cell, dtype)
    ctx = _ctx(cfg, wl, 3_000_000_019)
    drv = _driver("train")
    r = drv.build(ctx)
    with contextlib.redirect_stdout(io.StringIO()):
        drv.epoch(r, 1, r["kept_step"])
    prog = drv.program_side(r)
    drv.free_program(r)
    nums = drv.numbers(ctx, r, prog, drv.reference_side(ctx, r))
    for k, limit in tol.items():
        assert nums[k] <= limit, (k, nums)



def test_reordered_reference_is_sound_and_not_bitwise(small):
    """The reference computed in another order reads like a sound run:
    not bitwise, far under the fp8 control, and it moves the same leaves."""
    cfg, wl = small("vanilla_midi.train_b2048")
    ctx = _ctx(cfg, wl, 11)
    drv = _driver("train")
    r = drv.build(ctx)
    drv.free_program(r)
    ref = drv.reference_side(ctx, r)
    alt = drv.reference_side(ctx, r, reordered=True)
    assert any(not torch.equal(alt["params"][k], ref["params"][k]) for k in ref["params"])
    alt_n, control = drv.numbers(ctx, r, alt, ref), drv.numbers(ctx, r, drv.reference_side(ctx, r, "fp8"), ref)
    assert alt_n["kl1"] < 1e-3 and alt_n["beta"] == 0.0
    assert control["loss1"] > 10 * max(alt_n["loss1"], 1e-9) and control["grad"] > 10 * alt_n["grad"]

def test_lower_precision_control_is_told_apart(small):
    """The fp8 control, put in the program's place, reads far above the
    program on every number of a bf16 step."""
    cfg, wl = small("folded_fold8.train_b2048")
    ctx = _ctx(cfg, wl, 5)
    drv = _driver("train")
    r = drv.build(ctx)
    with contextlib.redirect_stdout(io.StringIO()):
        drv.epoch(r, 1, r["kept_step"])
    prog = drv.program_side(r)
    drv.free_program(r)
    ref = drv.reference_side(ctx, r)
    ours, control = drv.numbers(ctx, r, prog, ref), drv.numbers(ctx, r, drv.reference_side(ctx, r, "fp8"), ref)
    assert control["loss"] > 10 * ours["loss"] and control["grad"] > 10 * ours["grad"]


def test_weights_are_the_seed_s():
    cfg = {"arch": "VanillaVAE", "hidden_dims": [8, 16], "n_features": 4, "image_size": 16}
    a = weights.make(vae.spec(cfg), 3, "cpu", logit_bias=-2.0)
    b = weights.make(vae.spec(cfg), 3, "cpu", logit_bias=-2.0)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert float(a["final_layer.Conv_0.bias"][0]) == -2.0
    w = a["encoder.ConvBlock_1.Conv_0.weight"]
    assert float(w.abs().max()) <= (6.0 / (8 * 9 + 16 * 9)) ** 0.5
    assert torch.equal(a["encoder.ConvBlock_0.BatchNorm_0.weight"], torch.ones(8))

"""Driver of the VQ training cells: ``drivers/train.py``'s cell (the train
CLI's per-batch path in a timed window; its ``run``, from a private copy
of that module, over this driver's set-up, check and traced stretch),
with the quantizer's state held to the reference as well.

On top of what ``train.py`` builds, the codebook is drawn from the seed on
the card (standard normal, as the model initialises it; ``cluster_size``
ones, ``embed_avg`` the codebook) and both sides start from those
buffers. The kept first steps add the codes of step 1 and the three
buffers after step 3, and the check two numbers:

- ``codebook``: |‖ΔC‖ − ‖ΔC_ref‖| / ‖ΔC_ref‖ of the codebook's change over
  the steps;
- ``codes1``: the share of step 1's codes that differ from the
  reference's (a position one side lacks counts as differing).

A fault of this driver's own, for its tests and calibration:
``ema_decay_low`` runs the program's quantizer at decay 0.9.

With ``--trace 1`` a device-only stretch and a labelled one follow the
window, as in ``train.py``; the labelled one keeps the device time
launched inside each host range (``bench_cuda/spans.py``), which the
quantizer's readers take.

    python3 -m bench_cuda.drivers.train_vq --workload <cell> --seeds 12 --first-seed <n>

calibrates the cell's limits on the card: for each seed, every number of
the check (these two with the rest) of the program, of the reordered
reference and of the fp8 control, and of the program with each fault,
one JSON line a seed; then the largest sound and the smallest faulty
reading of each number.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import math
import os
import sys

import torch

from bench_cuda import check, spans, trace
from bench_cuda.reference import tf32_off


def _train_driver():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "train.py")
    spec = importlib.util.spec_from_file_location("bench_cuda_driver_train", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


train = _train_driver()
_gaussian_build, _gaussian_program_side = train.build, train.program_side
CHECK_STEPS, RULE_ROWS = train.CHECK_STEPS, train.RULE_ROWS
_Head, epoch, free_program, train_config = train._Head, train.epoch, train.free_program, train.train_config
FAULTS = ("half_batch", "lr_high", "unchanged", "ema_decay_low")
SOUND = ("program", "reordered")


def codebook_buffers(seed: int, codes: int, dim: int, device) -> dict:
    """The quantizer's starting buffers, drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    cb = torch.randn((codes, dim), generator=gen, device=device, dtype=torch.float32)
    return {"quantizer.codebook": cb, "quantizer.cluster_size": torch.ones(codes, device=device),
            "quantizer.embed_avg": cb.clone()}


def build(ctx):
    """``train.py``'s training object with the seed's codebook in the
    model, the fault planted, and a step that also keeps step 1's codes
    and the buffers after the last kept step."""
    r = _gaussian_build(ctx)
    q = r["model"].quantizer
    r["b0"] = codebook_buffers(ctx.seed, q.num_codes, q.embed_dim, ctx.device)
    with torch.no_grad():
        for name, value in r["b0"].items():
            getattr(q, name.split(".")[-1]).copy_(value)
    if ctx.fault == "ema_decay_low":
        q.decay = 0.9
    kept, inner = r["kept"], r["kept_step"]

    def keep_codes(module, args, out):
        kept["codes1"] = out[1].detach().reshape(-1).clone()

    def kept_step(state, x, e_seed, *, y=None):
        hook = q.register_forward_hook(keep_codes) if not kept["losses"] else None
        try:
            out = inner(state, x, e_seed, y=y)
        finally:
            if hook is not None:
                hook.remove()
        if len(kept["losses"]) == CHECK_STEPS and "buffers" not in kept:
            kept["buffers"] = {f"quantizer.{k}": getattr(q, k).detach().clone()
                               for k in ("codebook", "cluster_size", "embed_avg")}
        return out

    r["kept_step"] = kept_step
    return r


def program_side(run) -> dict:
    return {**_gaussian_program_side(run), "buffers": run["kept"]["buffers"], "codes1": run["kept"]["codes1"]}


def reference_side(ctx, run, compute=None, steps=CHECK_STEPS, rows=None, reordered=False) -> dict:
    """The plain reference's first steps from the same weights, buffers and corpus, TF32 off."""
    with tf32_off():
        return ctx.reference.train_steps(train_config(ctx), run["p0"], run["corpus"], batch=run["B"], seed=ctx.seed,
                                         steps=steps, compute=compute, rows=rows, reordered=reordered,
                                         buffers=run["b0"])


def quantizer_numbers(prog: dict, ref: dict, b0: dict) -> dict:
    """``codebook`` and ``codes1`` of ``prog`` against ``ref``."""
    c0 = b0["quantizer.codebook"].double()
    d_prog = float(torch.linalg.vector_norm(prog["buffers"]["quantizer.codebook"].double() - c0))
    d_ref = float(torch.linalg.vector_norm(ref["buffers"]["quantizer.codebook"].double() - c0))
    a, b = prog["codes1"], ref["codes1"]
    m = min(len(a), len(b))
    differ = int((a[:m] != b[:m]).sum()) + abs(len(a) - len(b))
    return {"codebook": abs(d_prog - d_ref) / max(d_ref, 1e-30), "codes1": differ / max(len(a), len(b))}


def numbers(ctx, run, prog: dict, ref: dict, moved=None) -> dict:
    """Every number of the check: ``check.py``'s over the leaves that move
    in the reference's first f32 step (as ``train.py`` takes them), and the
    quantizer's."""
    if moved is None:
        moved = check.moved_leaves(reference_side(ctx, run, "float32", steps=1, rows=RULE_ROWS)["first_grads"])
    return {**check.train_numbers(prog, ref, run["p0"], moved), **quantizer_numbers(prog, ref, run["b0"])}


def traced_stretch(ctx, r, e: int, window_steps: int, window_s: float) -> dict:
    """A device-only stretch and a labelled one of ``trace_steps`` steps
    each, from the start of epoch ``e``, over as many epochs as it takes."""
    k = int(ctx.workload["traffic"]["trace_steps"])

    def steps_from(e0: int):
        def go():
            left, e1 = k, e0
            while left > 0:
                n = min(left, len(r["loader"]))
                epoch(r, e1, r["step"], _Head(r["loader"], n))
                left, e1 = left - n, e1 + 1
        return go

    cuda = ctx.device.type == "cuda"
    with contextlib.redirect_stdout(sys.stderr):
        tl = trace.profile(steps_from(e), device_only=cuda)
        labelled = spans.profile(steps_from(e + math.ceil(k / len(r["loader"]))))
    ctx.log(f"traced: {k} steps in a stretch of {tl.window_s:.6f} s ({tl.window_s / k * 1e3:.3f} ms a step, the "
            f"window's {window_s / max(window_steps, 1) * 1e3:.3f}), busy {tl.busy_s():.6f} s")
    q = r["model"].quantizer
    return {
        "timeline": tl,
        "labelled": labelled.timeline,
        "spans": labelled,
        "stretch_steps": k,
        "window": {"seconds": window_s, "steps": window_steps},
        "vq": {"codes": q.num_codes, "dim": q.embed_dim, "z_bytes": r["model"].dtype.itemsize},
    }


# ``train.py``'s ``run`` (set-up, window, traced stretch, check), from this
# driver's private copy of it, over this driver's set-up, check and stretch
train.build, train.program_side, train.reference_side = build, program_side, reference_side
train.numbers, train.traced_stretch = numbers, traced_stretch
run = train.run


def calibrate_seed(run_module, bench: dict, cell: str, seed: int) -> dict:
    """Every number of the check, on one seed, for each side: the program,
    the reordered reference, the fp8 control and the program with each
    of :data:`FAULTS`."""

    def program(fault=None):
        ctx = run_module.make_ctx(bench, cell, seed, 0.0, False, fault=fault)
        with contextlib.redirect_stdout(sys.stderr):
            r = build(ctx)
            epoch(r, 1, r["kept_step"], _Head(r["loader"], CHECK_STEPS))
        side = program_side(r)
        free_program(r)
        return ctx, r, side

    ctx, r, prog = program()
    ref = reference_side(ctx, r)
    moved = check.moved_leaves(reference_side(ctx, r, "float32", steps=1, rows=RULE_ROWS)["first_grads"])
    out = {"program": numbers(ctx, r, prog, ref, moved),
           "reordered": numbers(ctx, r, reference_side(ctx, r, reordered=True), ref, moved),
           "control": numbers(ctx, r, reference_side(ctx, r, "fp8"), ref, moved)}
    for fault in FAULTS:
        out[fault] = numbers(ctx, r, program(fault)[2], ref, moved)
    return out


def main() -> None:
    p = argparse.ArgumentParser(description="Calibrate a VQ training cell's limits on the card.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first-seed", type=int, default=2_200_000_001)
    args = p.parse_args()
    from bench_cuda import run as run_module

    bench = run_module.load_json("BENCHMARK.json")
    rows = []
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        row = {**calibrate_seed(run_module, bench, args.workload, seed), "seed": seed}
        rows.append(row)
        print(json.dumps(row), flush=True)
    sides = [s for s in rows[0] if s != "seed"]
    summary = {s: {k: (max if s in SOUND else min)(row[s][k] for row in rows) for k in rows[0][s]} for s in sides}
    print(json.dumps({"workload": args.workload, "seeds": len(rows), "summary": summary}), flush=True)


if __name__ == "__main__":
    main()

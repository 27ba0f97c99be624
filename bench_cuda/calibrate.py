#!/usr/bin/env python3
"""Readings the check's limits are set from, for one training cell, on the card.

    python3 bench_cuda/calibrate.py --workload <cell> --seeds 12 --first-seed <n>

For each seed, the check's numbers (``bench_cuda/check.py``) of:

- ``program``: the port's first steps, from the run's own set-up;
- ``reordered``: the plain reference computed in another order
  (``reordered=True``) put in the program's place: a sound computation
  that rounds differently, as a sound change to the port's kernels would;
- ``control``: the plain reference in the next lower precision put in the
  program's place (fp8 operands for a bf16 configuration);
- the port with a planted fault: ``half_batch`` (the step on half the
  batch), ``beta_ahead`` (the KL weight read one step ahead), ``lr_high``
  (every learning rate 10 % high). A step that returns its state
  unchanged reads 1 on ``grad`` and ``change`` by their definition and
  needs no run.

One JSON line a seed on standard output, then the summary: the largest
sound reading of each number (``program``, ``reordered``: the lower end of
its limit) and the smallest of the control's and of each fault's (the
upper end). Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAULTS = ("half_batch", "beta_ahead", "lr_high")
SOUND = ("program", "reordered")


def train_seed(run, bench, cell, seed) -> dict:
    from bench_cuda import check

    def program(fault=None):
        ctx = run.make_ctx(bench, cell, seed, 0.0, False, fault=fault)
        drv = run.load_driver(ctx)
        with contextlib.redirect_stdout(sys.stderr):
            r = drv.build(ctx)
            drv.epoch(r, 1, r["kept_step"], drv._Head(r["loader"], drv.CHECK_STEPS))
        side = drv.program_side(r)
        drv.free_program(r)
        return ctx, drv, r, side

    ctx, drv, r, prog = program()
    ref = drv.reference_side(ctx, r)
    moved = check.moved_leaves(drv.reference_side(ctx, r, "float32", steps=1, rows=drv.RULE_ROWS)["first_grads"])

    def numbers(side):
        return check.train_numbers(side, ref, r["p0"], moved)

    out = {"program": numbers(prog), "reordered": numbers(drv.reference_side(ctx, r, reordered=True)),
           "control": numbers(drv.reference_side(ctx, r, "fp8"))}
    for fault in FAULTS:
        out[fault] = numbers(program(fault)[3])
    return out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first-seed", type=int, default=2_200_000_001)
    args = p.parse_args()
    here = os.path.join(ROOT, "bench_cuda")
    sys.path[:] = [ROOT] + [d for d in sys.path if os.path.abspath(d or ".") != here]
    from bench_cuda import run

    bench = run.load_json("BENCHMARK.json")
    rows = []
    for k in range(args.seeds):
        seed = args.first_seed + 7919 * k
        row = train_seed(run, bench, args.workload, seed)
        row["seed"] = seed
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {side: {k: (max if side in SOUND else min)(r[side][k] for r in rows) for k in rows[0][side]}
               for side in SOUND + ("control",) + FAULTS}
    print(json.dumps({"workload": args.workload, "seeds": len(rows), "summary": summary}), flush=True)


if __name__ == "__main__":
    main()

"""Driver of the stage-2 prior cells: the prior trainer's step and epoch
loop (``cli/train_prior.py`` ``make_prior_step``, ``train_prior_epoch``)
in a timed window.

Set-up builds what the trainer builds for a run, from the seed: the code
corpus (the configuration's ``stage1`` model, ``bench_cuda/configs/
vq16_fold8.json``'s FoldedVQVAE with the benchmark's weights and
codebook drawn from the seed, encoded over a device corpus of
``corpus`` rolls made by ``bench_cuda/frozen.py``, through the trainer's
``encode_corpus``), the prior (``build_prior`` on the meta device, so
that no weights are drawn there, then the reference's weights drawn from
the seed on the card), Adam and the step. It then runs epoch 1, which
warms every shape and keeps the first three steps: their batches,
NLLs and balance losses, the first gradients, step 1's routing and the
parameters and routing biases after step 3. The window runs epochs 2,
3, ... until ``--seconds`` have passed, each ending on the loop's host
read and the window on a ``torch.cuda.synchronize()``; the rate is the
grids stepped over the window's seconds.

With ``--trace 1`` a device-only stretch and a labelled one of
``trace_steps`` steps follow the window, as in ``train_vq.py``. After all
of it the program's state is freed and the plain reference replays the
three steps. It computes these numbers and compares those that the
workload's ``limits`` name (``loss1`` and ``bias`` have no limit: no
precision fault moves them clear of the sound readings; the calibration
still reports them):

- ``loss1``, ``aux1``: step 1's NLL and balance loss, relative;
- ``grad``, ``change``, ``change_median``: as ``check.py`` defines them,
  over the leaves the reference's first gradient moves;
- ``routes1``: the (token, expert) selections of step 1, over every MoE
  layer, that one side makes and the other does not, over the
  reference's selections;
- ``bias``: ‖b − b_ref‖ over the larger of ‖b_ref‖ and γ, the routing
  biases of every MoE layer after the three steps.

Faults, for the tests and the calibration: ``half_batch`` (the step on the
first half of each batch), ``lr_high`` (Adam's lr 10 % high), ``top5``
(5 experts a token), ``scale1`` (``routed_scaling_factor`` 1.0),
``rope_off`` (RoPE's tables set to angle 0, so nothing turns).

    python3 -m bench_cuda.drivers.train_prior --workload <cell> --seeds 12 --first-seed <n>

calibrates the cell's limits on the card: for each seed every number of
the program, of the reordered reference, of the fp8 control and of the
program with each fault (one set-up a seed, the prior re-armed for each),
one JSON line a seed; then the largest sound and the smallest faulty
reading of each number.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time

import numpy as np
import torch

from bench_cuda import check, counts_prior, frozen, peaks, spans, trace, weights
from bench_cuda.reference import tf32_off

CHECK_STEPS = 3
STAGE1_PASSES = 2  # train-mode passes of the stage-1 model over the corpus before it encodes
FAULTS = ("half_batch", "lr_high", "top5", "scale1", "rope_off")
SOUND = ("program", "reordered")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _json(path: str) -> dict:
    with open(os.path.join(ROOT, path)) as f:
        return json.load(f)


def widths(cfg: dict):
    """The port's widths dataclass filled from the configuration's keys
    (the router's published expert count in place of the held one)."""
    from midi_vae_tpu_torch.models.moe_prior import MoonlightWidths

    keys = set(MoonlightWidths.__dataclass_fields__) - {"n_routed_experts"}
    return MoonlightWidths(n_routed_experts=int(cfg["n_routed_experts_published"]), **{k: cfg[k] for k in keys})


def code_corpus(ctx, stage1: dict) -> np.ndarray:
    """[corpus, s, s] int32 code grids: ``stage1``'s model drawn from the
    seed (weights as ``weights.py`` draws them, the codebook as
    ``train_vq.py`` does) over a device corpus of rolls from the seed,
    through the trainer's ``encode_corpus``, eval transforms as it takes them."""
    from midi_vae_tpu_torch.cli.train_prior import encode_corpus
    from midi_vae_tpu_torch.data.pipeline import DeviceResidentLoader
    from midi_vae_tpu_torch.data.sources import ArrayDataset
    from midi_vae_tpu_torch.data.transforms import VALID_TRANSFORMS, get_transform
    from midi_vae_tpu_torch.train.config import TrainConfig
    from midi_vae_tpu_torch.train.loop import build_run_model
    from bench_cuda.reference import vq

    cfg, dev, seed = stage1["train"], ctx.device, ctx.seed
    tr = ctx.workload["traffic"]
    n = int(tr["corpus"])
    rolls = frozen.make_corpus(seed, n, dev)
    config = TrainConfig.from_dict({**cfg, "seed": seed, "models_dir": None})
    bias = weights.output_bias(cfg, rolls)
    model = build_run_model(config, dev, in_channels=int(cfg.get("in_channels", 1)), seed=seed, output_bias=bias)
    p0 = weights.make(vq.spec(cfg), seed, dev, logit_bias=bias)
    gen = torch.Generator(device=dev).manual_seed(int(seed) + 1)
    cb = torch.randn((int(cfg["codebook_size"]), int(cfg["n_features"])), generator=gen, device=dev)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(p0[name])
        q = model.quantizer
        q.codebook.copy_(cb)
        q.cluster_size.fill_(1.0)
        q.embed_avg.copy_(cb)
    args = {"normalization": config.dataset_name} if config.dataset_name in VALID_TRANSFORMS else {}
    _, transform_eval = get_transform(config.transform_type, config.image_size, args)
    dataset = ArrayDataset(images=rolls.cpu().numpy(), labels=np.zeros(n, np.int64), name="bench_cuda",
                           transform=transform_eval)
    loader = DeviceResidentLoader(dataset, int(tr["batch"]), train=False, seed=seed, device=dev)
    with torch.no_grad():  # BatchNorm's running statistics and the codebook's EMA from the corpus, as stage 1 leaves them
        for e in range(STAGE1_PASSES):
            for batch in loader.epoch(e + 1):
                model(batch.x, train=True)
    ctx.mark(f"stage-1 model's {STAGE1_PASSES} train-mode passes")
    model.eval()
    grids = encode_corpus(model, loader)
    loader.release()
    return grids


def build(ctx):
    """The stage-1 corpus, the prior and Adam, armed with ``ctx.fault``."""
    from midi_vae_tpu_torch.cli.train_prior import build_prior, make_prior_step, train_prior_epoch  # noqa: F401

    cfg, tr, dev, seed = ctx.config, ctx.workload["traffic"], ctx.device, ctx.seed
    stage1 = cfg["stage1"] if isinstance(cfg["stage1"], dict) else _json(cfg["stage1"])
    grids = code_corpus(ctx, stage1)
    _, uses = np.unique(grids, return_counts=True)
    ctx.log(f"code corpus: {len(grids)} grids, {len({g.tobytes() for g in grids})} distinct, {len(uses)} distinct "
            f"codes, the commonest {uses.max() / grids.size:.4f} of the positions")
    ctx.mark("code corpus encoded")
    p = cfg["prior"]
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[p["dtype"]]
    with torch.device("meta"):  # no weights drawn: arm() fills every parameter and buffer
        prior = build_prior("moonlight", num_codes=int(cfg["vocab_size"]), grid=int(p["grid"]), features=0,
                            layers=int(cfg["num_hidden_layers"]), num_classes=int(p.get("num_classes", 0)),
                            dtype=dtype, seed=seed, experts_held=p["experts_held"], widths=widths(cfg))
    prior = prior.to_empty(device=dev)
    p0 = ctx.reference.make_weights(cfg, seed, dev)
    own = dict(prior.named_parameters())
    if set(own) != set(p0):
        raise RuntimeError(f"the prior's parameters are not the reference's: {sorted(set(own) ^ set(p0))[:6]}")
    r = dict(prior=prior, p0=p0, grids_dev=torch.from_numpy(grids).long().to(dev), n=len(grids), B=int(tr["batch"]),
             seed=seed, dev=dev, cfg=cfg)
    arm(r, ctx.fault)
    ctx.mark("prior built")
    return r


def arm(r: dict, fault=None) -> None:
    """(Re)start the prior from the seed's weights with zero routing biases,
    its RoPE tables, a fresh Adam and ``fault`` planted (``rope_off``: the
    tables of angle 0, which turn nothing); the step keeps the first steps."""
    from midi_vae_tpu_torch.cli.train_prior import make_prior_step
    from midi_vae_tpu_torch.models.moe_prior import rope_tables

    prior, cfg = r["prior"], r["cfg"]
    cos, sin = rope_tables(prior.rope_cos.shape[0], int(cfg["qk_rope_head_dim"]), float(cfg["rope_theta"]))
    if fault == "rope_off":
        cos, sin = torch.ones_like(cos), torch.zeros_like(sin)
    with torch.no_grad():
        for name, q in prior.named_parameters():
            q.copy_(r["p0"][name])
        prior.rope_cos.copy_(cos)
        prior.rope_sin.copy_(sin)
        for moe in prior.moe_layers():
            moe.router.bias.zero_()
            moe.router.top_k = 5 if fault == "top5" else int(cfg["num_experts_per_tok"])
            moe.scale = 1.0 if fault == "scale1" else float(cfg["routed_scaling_factor"])
    lr = float(cfg["prior"]["lr"]) * (1.1 if fault == "lr_high" else 1.0)
    r["optimizer"] = optimizer = torch.optim.Adam(prior.parameters(), lr=lr)
    step = make_prior_step(prior, optimizer, r["grids_dev"])
    if fault == "half_batch":
        step = (lambda inner: lambda sel: inner(sel[: sel.shape[0] // 2]))(step)
    elif fault not in (None, "lr_high", "top5", "scale1", "rope_off"):
        raise ValueError(f"unknown fault {fault!r}")
    r["step"] = step
    kept = r["kept"] = {"batches": [], "losses": [], "kls": [], "routes1": None, "first_grads": None}
    forward_train = type(prior).forward_train

    def keep_aux(idx, y=None):
        out = forward_train(prior, idx, y)
        if len(kept["kls"]) < CHECK_STEPS:
            kept["kls"].append(out[1].detach().clone())
        return out

    prior.forward_train = keep_aux

    def kept_step(sel):
        i = len(kept["losses"])
        if i >= CHECK_STEPS:
            return step(sel)
        kept["batches"].append(r["grids_dev"][sel].clone())
        tops, hooks = [], []
        if i == 0:
            hooks = [m.router.register_forward_hook(lambda mod, a, out: tops.append(out[1].detach().clone()))
                     for m in prior.moe_layers()]
        try:
            out = step(sel)
        finally:
            for h in hooks:
                h.remove()
        kept["losses"].append(out[0].detach().clone())
        if i == 0:
            kept["routes1"] = tops
            kept["first_grads"] = {k: q.grad.detach().clone() for k, q in prior.named_parameters()}
        if i == CHECK_STEPS - 1:
            kept["params"] = {k: q.detach().clone() for k, q in prior.named_parameters()}
            kept["bias"] = {f"{name}.bias": m.bias.detach().clone() for name, m in prior.named_modules()
                            if name.endswith("router")}
        return out

    r["kept_step"] = kept_step


def epoch(r: dict, e: int, step, max_steps=None) -> np.ndarray:
    """One epoch of the trainer's loop; returns its NLLs."""
    from midi_vae_tpu_torch.cli.train_prior import train_prior_epoch

    return train_prior_epoch(step, n=r["n"], bs=r["B"], seed=r["seed"], epoch=e, device=r["dev"],
                             max_steps=max_steps)


def program_side(r: dict) -> dict:
    kept = r["kept"]
    alpha = float(r["cfg"]["prior"]["balance_alpha"])
    return {"losses": [float(v) for v in kept["losses"]], "kls": [float(v) for v in kept["kls"]],
            "kl_weights": [alpha] * len(kept["losses"]), "first_grads": kept["first_grads"],
            "params": kept["params"], "bias": kept["bias"], "routes1": kept["routes1"]}


def free_program(r: dict) -> None:
    for key in ("prior", "optimizer", "step", "kept_step", "grids_dev"):
        r.pop(key, None)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference_side(ctx, r: dict, compute=None, reordered: bool = False) -> dict:
    """The plain reference's first steps on the kept batches, TF32 off."""
    with tf32_off():
        return ctx.reference.train_steps(ctx.config, r["p0"], r["kept"]["batches"], steps=CHECK_STEPS,
                                         compute=compute, reordered=reordered)


def routes_differ(prog: list, ref: list, experts: int) -> float:
    """Selections of step 1 that one side makes and the other does not, over
    the reference's (a token one side lacks counts all its selections)."""
    differ, total = 0, 0
    for a, b in zip(prog, ref):
        ha = torch.zeros(a.shape[0], experts, device=a.device).scatter_(1, a, 1.0)
        hb = torch.zeros(b.shape[0], experts, device=a.device).scatter_(1, b.to(a.device), 1.0)
        m = min(len(ha), len(hb))
        differ += int((ha[:m] != hb[:m]).sum()) + int(ha[m:].sum()) + int(hb[m:].sum())
        total += int(hb.sum())
    return differ / max(total, 1)


def numbers(ctx, prog: dict, ref: dict, p0: dict, moved=None) -> dict:
    """Every number of the check, ``prog`` against ``ref``."""
    if moved is None:
        moved = check.moved_leaves(ref["first_grads"])
    base = check.train_numbers(prog, ref, p0, moved)
    gamma = float(ctx.config["prior"]["bias_gamma"])
    bp = torch.cat([prog["bias"][k].double().flatten() for k in sorted(ref["bias"])])
    br = torch.cat([ref["bias"][k].double().flatten().to(bp.device) for k in sorted(ref["bias"])])
    bias = float(torch.linalg.vector_norm(bp - br)) / max(float(torch.linalg.vector_norm(br)), gamma)
    return {"loss1": base["loss1"], "aux1": base["kl1"], "grad": base["grad"], "change": base["change"],
            "change_median": base["change_median"],
            "routes1": routes_differ(prog["routes1"], ref["routes1"], int(ctx.config["n_routed_experts_published"])),
            "bias": bias}


def traced_stretch(ctx, r: dict, e: int, window_steps: int, window_s: float) -> dict:
    """A device-only stretch and a labelled one of ``trace_steps`` steps, each from the start of an epoch."""
    k = int(ctx.workload["traffic"]["trace_steps"])
    per_epoch = max(r["n"] // r["B"], 1)

    def steps_from(e0: int):
        def go():
            left, e1 = k, e0
            while left > 0:
                done = len(epoch(r, e1, r["step"], max_steps=left))
                left, e1 = left - done, e1 + 1
        return go

    cuda = ctx.device.type == "cuda"
    with contextlib.redirect_stdout(sys.stderr):
        tl = trace.profile(steps_from(e), device_only=cuda)
        labelled = spans.profile(steps_from(e + math.ceil(k / per_epoch)))
    ctx.log(f"traced: {k} steps in a stretch of {tl.window_s:.6f} s ({tl.window_s / k * 1e3:.3f} ms a step, the "
            f"window's {window_s / max(window_steps, 1) * 1e3:.3f}), busy {tl.busy_s():.6f} s")
    return {
        "timeline": tl,
        "labelled": labelled.timeline,
        "spans": labelled,
        "stretch_steps": k,
        "window": {"seconds": window_s, "steps": window_steps},
        "flops_per_step": counts_prior.step_flops(ctx.config, r["B"]),
        "peak_flops": peaks.PEAK_FLOPS[ctx.config["prior"]["dtype"]],
        "moe": {"config": ctx.config, "tokens": r["B"] * int(ctx.config["prior"]["grid"]) ** 2},
    }


def run(ctx) -> dict:
    with contextlib.redirect_stdout(sys.stderr):
        r = build(ctx)
        epoch(r, 1, r["kept_step"])  # set-up: every shape warmed, the first steps kept
        ctx.mark("epoch 1")
        if len(r["kept"]["losses"]) < CHECK_STEPS:
            raise RuntimeError(f"an epoch has fewer than {CHECK_STEPS} steps")
        ctx.sync()
        t_first = time.time()
        e, steps, bad = 2, 0, 0
        t0 = time.perf_counter()
        while True:
            nlls = epoch(r, e, r["step"])
            steps, bad, e = steps + len(nlls), bad + int((~np.isfinite(nlls)).sum()), e + 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        ctx.sync()
        window_s = time.perf_counter() - t0
    result = {"e2e": {"setup_s": t_first - ctx.t_start, "train_samples_per_s": steps * r["B"] / window_s},
              "attempted": steps, "failed": bad}
    ctx.log(f"window: {steps} steps of {r['B']} grids in {window_s:.3f} s over {e - 2} epochs")
    if ctx.trace:
        result["trace"] = traced_stretch(ctx, r, e, steps, window_s)
    result["memory_peak_bytes"] = ctx.memory_peak()
    prog = program_side(r)
    free_program(r)
    nums = numbers(ctx, prog, reference_side(ctx, r), r["p0"])
    result["checks"] = [(k, nums[k], limit) for k, limit in ctx.workload["limits"].items()]
    return result


def _moved(side: dict, device) -> dict:
    """A program side with its tensors on ``device``."""
    out = dict(side)
    for key in ("first_grads", "params", "bias"):
        out[key] = {k: v.to(device) for k, v in side[key].items()}
    out["routes1"] = [t.to(device) for t in side["routes1"]]
    return out


def calibrate_seed(run_module, bench: dict, cell: str, seed: int) -> dict:
    """Every number of the check on one seed, for each side: the program,
    the reordered reference, the fp8 control and the program with each of
    :data:`FAULTS`."""
    ctx = run_module.make_ctx(bench, cell, seed, 0.0, False)
    sides = {}
    with contextlib.redirect_stdout(sys.stderr):
        r = build(ctx)
        for fault in (None,) + FAULTS:
            arm(r, fault)
            epoch(r, 1, r["kept_step"], max_steps=CHECK_STEPS)
            sides[fault or "program"] = _moved(program_side(r), "cpu")  # six sides would not fit beside the program
    free_program(r)
    ref = reference_side(ctx, r)
    moved = check.moved_leaves(ref["first_grads"])
    out = {side: numbers(ctx, _moved(prog, ctx.device), ref, r["p0"], moved) for side, prog in sides.items()}
    out["reordered"] = numbers(ctx, reference_side(ctx, r, reordered=True), ref, r["p0"], moved)
    out["control"] = numbers(ctx, reference_side(ctx, r, "fp8"), ref, r["p0"], moved)
    return out


def main() -> None:
    p = argparse.ArgumentParser(description="Calibrate a prior cell's limits on the card.")
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

#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 bench_cuda/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``,
``bench_cuda/`` and the port (``midi_vae_tpu_torch/``). Everything is
found by name from ``BENCHMARK.json``: the cell's configuration file, its
workload file ``bench_cuda/workloads/<cell>.json`` (driver, traffic,
limits), the driver ``bench_cuda/drivers/<driver>.py``, the
configuration's plain reference, and for ``--trace 1`` one reader
``bench_cuda/metrics/<metric>.py`` per per-layer metric. Nothing here is
particular to a configuration, a traffic mix or a metric.

The run needs a CUDA card (as many as the cell asks for) and exits with 2
without one. It warms every shape the cell uses, measures for
``--seconds``, checks what the timed path produced against the plain
reference, and prints on standard error the card's name and power limit
first and each number compared beside its limit last; on standard output
its last line is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and, traced, ``breakdown``; ``checks`` comes
last. It exits with 3, printing no result, if JAX or the JAX package is
loaded in this process once every reader has run, just before the result
would be printed.

An end-to-end metric named ``<name>.<part>`` that the driver does not
report reads the driver's ``<name>``: the same quantity held to a bound
of its own in the cells it lists.

Kernel builds go to fixed directories inside the checkout: ``build/triton``
(``TRITON_CACHE_DIR``) and ``build/kernels``
(``MIDI_VAE_TORCH_KERNEL_DIR``), so only a checkout's first run builds.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace


def _process_start() -> float:
    """The wall-clock time this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_START = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "bench_cuda")
FORBIDDEN = ("jax", "jaxlib", "flax", "midi_vae_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_file(path: str, name: str):
    """The Python file at ``path`` (relative to the checkout) as a module."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_json(path: str) -> dict:
    with open(os.path.join(ROOT, path)) as f:
        return json.load(f)


def reference_module(path: str):
    """A configuration's reference, ``bench_cuda/reference/<x>.py``, imported as a module of the package."""
    return importlib.import_module(path[: -len(".py")].replace("/", "."))


def applies(metric: dict, cell: str, e2e_names) -> bool:
    """A metric with ``workloads`` is the listed cells'; one without is every
    cell's (an end-to-end metric) or every cell that reports what it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "nvidia-smi: none"
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi: none"


def forbidden_modules() -> list:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def make_ctx(bench: dict, name: str, seed: int, seconds: float, trace: bool, *, device=None, config=None,
             workload=None, fault=None) -> SimpleNamespace:
    """What a driver is given for one run of cell ``name``: its files read,
    the kernel caches pointed into the checkout, the card looked for
    (exit 2 without enough of them) unless ``device`` is given."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = config or load_json(configs[cell["config"]]["file"])
    workload = workload or load_json(f"bench_cuda/workloads/{cell['name']}.json")

    build = os.path.join(ROOT, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["MIDI_VAE_TORCH_KERNEL_DIR"] = os.path.join(build, "kernels")

    import torch

    if device is None:
        log(f"card: {card_line()}")
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            log(f"{name} needs {cell['chips']} CUDA device(s); "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
            sys.exit(2)
        device = torch.device("cuda", 0)
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(device)}")
    cuda = device.type == "cuda"
    log(f"set-up, torch and the card: {time.time() - T_START:.3f} s")
    return SimpleNamespace(
        root=ROOT, cell=cell, seed=seed, seconds=seconds, trace=trace, config=config,
        workload=workload, device=device, t_start=T_START, fault=fault, log=log,
        mark=lambda what: log(f"set-up, {what}: {time.time() - T_START:.3f} s"),
        reference=reference_module(config["reference"]),
        sync=(lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None),
        memory_peak=(lambda: int(torch.cuda.max_memory_allocated(device))) if cuda else (lambda: 0),
    )


def load_driver(ctx):
    name = ctx.workload["driver"]
    return load_file(f"bench_cuda/drivers/{name}.py", f"bench_cuda_driver_{name}")


def main(argv=None, *, device=None, config=None, workload=None, fault=None) -> dict:
    """Run one cell; returns the result line's object. ``device``,
    ``config``, ``workload`` and ``fault`` are for the harness's own tests:
    they skip the look for a card, replace the cell's files and break the
    timed path underneath."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = load_json("BENCHMARK.json")
    ctx = make_ctx(bench, args.workload, args.seed, args.seconds, bool(args.trace), device=device, config=config,
                   workload=workload, fault=fault)
    import torch

    cell, device = ctx.cell, ctx.device
    cuda = device.type == "cuda"
    result = load_driver(ctx).run(ctx)

    e2e = [m for m in bench["end_to_end"] if applies(m, cell["name"], ())]
    e2e_names = {m["name"] for m in e2e}
    metrics = {}
    out_device = {"platform": "gpu" if cuda else device.type,
                  "kind": torch.cuda.get_device_name(device) if cuda else device.type,
                  "count": int(cell["chips"]), "memory_peak_bytes": int(result["memory_peak_bytes"])}
    line = {}
    if args.trace:
        traced = result["trace"]
        for m in bench["per_layer"]:
            if applies(m, cell["name"], e2e_names):
                reader = load_file(f"bench_cuda/metrics/{m['name']}.py", "bench_cuda_metric_" + m["name"].replace(".", "_"))
                value = reader.read(traced)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        tl = traced["timeline"]
        out_device.update(busy_s=tl.busy_s(), window_s=tl.window_s)
        from bench_cuda.trace import breakdown

        line["breakdown"] = breakdown(tl, traced.get("labelled"))
    else:
        for m in e2e:
            name = m["name"] if m["name"] in result["e2e"] else m["name"].split(".")[0]
            metrics[m["name"]] = {"value": result["e2e"][name], "unit": m["unit"]}

    problems = list(result.get("problems", []))
    checks = {}
    for name, value, limit in result["checks"]:
        checks[name] = {"value": value, "limit": limit}
        if not value <= limit:
            problems.append(f"{name} {value!r} over its limit {limit!r}")
    for text in problems:
        log(f"not correct: {text}")
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    out = {"correct": not problems, "attempted": int(result["attempted"]), "failed": int(result["failed"]),
           "metrics": metrics, "device": out_device, **line, "checks": checks}
    found = forbidden_modules()
    if found:
        log(f"loaded in this process once the window had closed: {', '.join(found)}")
        sys.exit(3)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    if sys.path and os.path.abspath(sys.path[0]) == HERE:
        sys.path.pop(0)  # this folder's modules are reached as the package bench_cuda
    sys.path.insert(0, ROOT)
    main()

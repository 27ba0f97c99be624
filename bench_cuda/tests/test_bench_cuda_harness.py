"""The harness end to end on the CPU at small sizes: what it loads, how it
refuses to run without a card, and that ``correct`` comes out false when
the timed path is broken underneath."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from bench_cuda import run
from bench_cuda.tests.conftest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "midi_vae_tpu")


def _fresh_modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", f"import sys; sys.path.insert(0, {ROOT!r})\n{code}\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300, check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_harness_and_port_path_load_no_jax():
    """The harness, every driver, reader and reference, and the port's
    modules the drivers call, in a fresh interpreter."""
    code = ("import glob, os\nfrom bench_cuda import run, calibrate\n"
            "for p in sorted(glob.glob('bench_cuda/drivers/*.py') + glob.glob('bench_cuda/metrics/*.py')):\n"
            "    run.load_file(p, 'x_' + os.path.basename(p).replace('.', '_'))\n"
            "import bench_cuda.reference.vae\n"
            "import midi_vae_tpu_torch.train.loop, midi_vae_tpu_torch.ops.fused_elbo")
    mods = _fresh_modules(code)
    assert "midi_vae_tpu_torch" in mods and "torch" in mods
    assert not mods.intersection(FORBIDDEN), mods.intersection(FORBIDDEN)


def test_reference_loads_nothing_of_the_port():
    mods = _fresh_modules("import bench_cuda.reference.vae, bench_cuda.frozen, bench_cuda.weights, bench_cuda.check")
    assert "midi_vae_tpu_torch" not in mods and not mods.intersection(FORBIDDEN)


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "midi_vae_tpu_torch_extra", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "midi_vae_tpu.models", sys)
    assert run.forbidden_modules() == ["midi_vae_tpu"]


def test_without_a_card_the_run_exits_non_zero():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "bench_cuda/run.py", "--workload", "folded_fold8.train_b2048", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_benchmark_files_alone_do_not_run(tmp_path):
    """A checkout holding only BENCHMARK.json and bench_cuda/ fails, printing no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "bench_cuda"), tmp_path / "bench_cuda",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "bench_cuda/run.py", "--workload", "folded_fold8.train_b2048",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                       cwd=tmp_path, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_every_cell_finds_its_files():
    bench = run.load_json("BENCHMARK.json")
    for cell in bench["workloads"]:
        wl = run.load_json(f"bench_cuda/workloads/{cell['name']}.json")
        assert wl["config"] == cell["config"] and wl["chips"] == cell["chips"]
        assert os.path.isfile(os.path.join(ROOT, f"bench_cuda/drivers/{wl['driver']}.py"))
    for m in bench["per_layer"]:
        assert os.path.isfile(os.path.join(ROOT, f"bench_cuda/metrics/{m['name']}.py"))
        e2e = {x["name"]: x for x in bench["end_to_end"]}
        for w in m["workloads"]:  # each listed cell reports the metric it moves
            assert w in e2e[m["moves"]]["workloads"]


def _run(cell, small, fault=None, trace=0, dtype=None):
    cfg, wl = small(cell, dtype)
    return run.main(["--workload", cell, "--seed", "3000000023", "--seconds", "1", "--trace", str(trace)],
                    device=torch.device("cpu"), config=cfg, workload=wl, fault=fault)


@pytest.mark.parametrize("cell,e2e", [("folded_fold8.train_b2048", {"setup_s", "train_samples_per_s"}),
                                      ("vanilla_midi.train_b2048",
                                       {"setup_s", "train_samples_per_s", "train_samples_per_s.device_bound"})])
def test_sound_training_run_is_correct(cell, e2e, small, capsys):
    out = _run(cell, small)
    assert out["correct"] and out["attempted"] > 0 and set(out["metrics"]) == e2e
    rates = {out["metrics"][k]["value"] for k in e2e - {"setup_s"}}
    assert len(rates) == 1  # the device-bound rate is the same quantity under a bound of its own
    assert list(out)[-1] == "checks" and set(out["checks"]) == set(small(cell)[1]["limits"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == json.loads(json.dumps(out))


# vanilla's KL weight is constant, so reading it a step ahead changes nothing there
@pytest.mark.parametrize("cell,fault", [(c, f) for c in ("folded_fold8.train_b2048", "vanilla_midi.train_b2048")
                                        for f in ("unchanged", "half_batch", "beta_ahead", "lr_high")
                                        if not (c.startswith("vanilla") and f == "beta_ahead")])
def test_broken_training_step_is_not_correct(cell, fault, small):
    assert not _run(cell, small, fault)["correct"]


def test_traced_runs_report_their_per_layer_metrics(small):
    out = _run("folded_fold8.train_b2048", small, trace=1)
    assert out["correct"] and "mfu.train" in out["metrics"] and "breakdown" in out
    assert "train_samples_per_s" not in out["metrics"] and out["device"]["window_s"] > 0


def test_a_reader_that_loads_the_jax_package_stops_the_result(small, monkeypatch, tmp_path, capsys):
    """A per-layer reader is loaded after the window; if it brings the JAX
    package (here a stub of it) into the process, the run exits 3 and
    prints no result."""
    reader = tmp_path / "stub_reader.py"
    reader.write_text("import sys, types\nsys.modules['midi_vae_tpu'] = types.ModuleType('midi_vae_tpu')\n\n\n"
                      "def read(traced):\n    return 1.0\n")
    load_json, load_file = run.load_json, run.load_file
    extra = {"name": "stub_reader.train", "unit": "%", "better": "higher", "source": "device_trace", "layer": "device",
             "moves": "train_samples_per_s", "workloads": ["folded_fold8.train_b2048"]}

    def with_stub(path):
        data = load_json(path)
        return {**data, "per_layer": data["per_layer"] + [extra]} if path == "BENCHMARK.json" else data

    monkeypatch.setattr(run, "load_json", with_stub)
    monkeypatch.setattr(run, "load_file", lambda path, name: load_file(
        str(reader) if path.endswith("stub_reader.train.py") else path, name))
    try:
        with pytest.raises(SystemExit) as stop:
            _run("folded_fold8.train_b2048", small, trace=1)
    finally:
        sys.modules.pop("midi_vae_tpu", None)
    assert stop.value.code == 3 and capsys.readouterr().out.strip() == ""


def test_traced_stretch_runs_its_steps_over_as_many_epochs_as_it_takes(small):
    """A stretch longer than an epoch (4 batches here) steps on into the
    next ones; K1 is recorded once a step."""
    import contextlib
    import io
    from types import SimpleNamespace

    from bench_cuda.reference import vae

    cfg, wl = small("folded_fold8.train_b2048")
    wl["traffic"]["trace_steps"] = 6
    ctx = SimpleNamespace(config=cfg, workload=wl, device=torch.device("cpu"), seed=5, fault=None, reference=vae,
                          mark=lambda what: None, log=lambda msg: None)
    drv = run.load_file("bench_cuda/drivers/train.py", "bench_cuda_driver_train")
    r = drv.build(ctx)
    with contextlib.redirect_stdout(io.StringIO()):
        drv.epoch(r, 1, r["kept_step"])
    before = r["state"].step
    traced = drv.traced_stretch(ctx, r, 2, 4, 1.0)
    assert len(r["loader"]) == 4 and r["state"].step - before == 6
    assert len(traced["kernel_calls"]["K1"]) == 6 and traced["stretch_steps"] == 6

"""The PyTorch port's example twins run end to end on the CPU (``--cpu``),
each in a process of its own, at a small size:

- ``examples/torch_end_to_end.py --n-files 32 --epochs 1``: corpus → train
  → generate (samples and ``.mid`` export) → slerp interpolation → serve and
  client. 32 files are the fewest whose training split fills one batch of
  the example's 32 (the loader drops a ragged last batch);
- ``examples/torch_migrate_from_reference.py --image-size 32 --steps 5``:
  a reference ``state_dict`` imported, forward parity with the reference
  model within 1e-4, and the loss falling under the port's train step (the
  script asserts both).
"""

import os
import subprocess
import sys

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(tmp_path, script, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="2", MIDI_VAE_TORCH_KERNEL_DIR=str(tmp_path / "kernels"))
    out = subprocess.run([sys.executable, os.path.join(_REPO, "examples", script), "--cpu", *args], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out.stdout


def test_end_to_end_twin_runs_on_the_cpu(tmp_path):
    workdir = tmp_path / "e2e"
    out = _run(tmp_path, "torch_end_to_end.py", "--workdir", str(workdir), "--n-files", "32", "--epochs", "1")
    for step in ("[1] wrote 32 .mid files", "[2] trained 1 epochs on cpu", "[3] samples:", "[4] interpolation path:",
                 "[5] served 2 samples + 2 reconstructions"):
        assert step in out, step
    assert (workdir / "samples.png").is_file() and (workdir / "interpolation.png").is_file()
    assert len(list((workdir / "generated_midi").glob("*.mid"))) == 8


def test_migration_twin_runs_on_the_cpu(tmp_path):
    out = _run(tmp_path, "torch_migrate_from_reference.py", "--image-size", "32", "--steps", "5")
    assert "forward parity on cpu" in out and "continued training 5 steps" in out and "migration OK" in out

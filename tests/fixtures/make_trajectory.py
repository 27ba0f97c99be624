"""Regenerate ``trajectory_folded_fold8.npz`` and ``.json``: the JAX
package's training run of the flagship, recorded on the CPU for
``chip_smoke.py`` ``trajectory_phase`` to replay through the port on the
card (which has no JAX) and for ``tests/test_torch_trajectory_fixture.py``.

The run is the JAX train CLI on ``configs/folded.yaml``'s model and
optimizer, written out as flags (``ARGV``): FoldedVAE fold 8, hidden
(48, 64, 128, 256), latent 10, 128×128 ``midi-synthetic`` rolls with the
pianoroll augmentation, ``--fused --bce-targets normalized`` (as
``chip_smoke.py`` ``cli_phase`` runs it), batch 100, AdamW under OneCycle,
the linear KL warm-up, seed 0, ``--log-interval 1``, 3 epochs of 4 steps
on a corpus of ``SYNTHETIC_FILES`` files (456 train windows, 115 test);
once in float32 and once with ``--bf16``. It starts from the seeded numpy
init of ``trajectory_replay.py`` (seed ``INIT_SEED``) through
``--pretrained``. The learning rate is a tenth of the config's: at
``--lr 0.00128`` and β ≈ 0 (the warm-up's first steps) the latent means
grow by ~4 a step and the KL reaches thousands of nats by step 6, and
the reference's own f32 rounding (1e-4 in a step's gradient on these
sparse rolls) grows into an O(1) difference in loss by step 7, so no
second run could be held to it; at ``--lr 0.000128`` the port's run on
the CPU stays within 2e-5 of it in loss over all 12 steps.

The ``.npz`` holds the draws the card must replay: each step's
reparameterization draw (recovered from the JAX step's own forward),
each eval batch's, and each train batch's augmentation (pitch shift, time
shift, velocity scale per roll). The ``.json`` holds the argv, the init's
seed and checksum, and per dtype every ``metrics.jsonl`` row, the
counters, the final sweeps, the run directory's files and a sum and an L2
norm of every final leaf. Rerun it only when the JAX package changes:

    JAX_PLATFORMS=cpu python tests/fixtures/make_trajectory.py
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "trajectory_folded_fold8")
SYNTHETIC_FILES = 300
INIT_SEED = 0
ARGV = [
    "--dataset", "midi-synthetic", "--transform-type", "pianoroll", "--image-size", "128", "--model", "FoldedVAE",
    "--fold", "8", "--n_features", "10", "--hidden-dims", "48", "64", "128", "256", "--kld-weight", "0.00025",
    "--kl-schedule", "linear", "--kl-warmup-steps", "2000", "--bce-targets", "normalized", "--output-bias-init", "auto",
    "--epochs", "3", "--lr", "0.000128", "--weight-decay", "0.00001", "--optimizer", "AdamW", "--scheduler", "OneCycle",
    "--batch-size", "100", "--save-best-model", "--seed", "0", "--fused", "--log-interval", "1", "--num-devices", "1",
    "--run-name", "trajectory",
]
DTYPES = {"float32": [], "bfloat16": ["--bf16"]}


def model_config() -> dict:
    """The fixture model's fields, for building it."""
    return dict(arch="FoldedVAE", image_size=128, n_features=10, hidden_dims=[48, 64, 128, 256], fold=8)


def main() -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    repo = os.path.dirname(os.path.dirname(HERE))
    sys.path[:0] = [repo, os.path.join(repo, "tests")]
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_threefry_partitionable", True)
    import numpy as np
    from flax import traverse_util

    import midi_vae_tpu.cli.train as jax_cli
    import torch_trajectory as tt
    from midi_vae_tpu.data.transforms import get_transform
    from trajectory_replay import checksum

    t0 = time.time()
    tmp = tempfile.mkdtemp()
    tempfile.tempdir = tmp  # the corpus is generated here
    try:
        init = os.path.join(tmp, "init.msgpack")
        leaves = tt.write_init_checkpoint(model_config(), init, INIT_SEED)
        drawn = {k: v for k, v in leaves.items() if k.rsplit("/", 1)[-1] in ("kernel", "bias", "scale", "mean", "var")}
        meta = {"argv": ARGV, "dtypes": DTYPES, "synthetic_files": SYNTHETIC_FILES, "init_seed": INIT_SEED,
                "init_checksum": checksum(drawn), "jax": jax.__version__, "runs": {}}
        arrays = {}
        for dtype, flags in DTYPES.items():
            draws = tt.Draws()
            models = os.path.join(tmp, "models")
            recorders = tt.jax_recorders(draws)
            with tt.synthetic_sizes({"midi-synthetic": SYNTHETIC_FILES}), \
                    tt.patched(tt.jax_loop, "make_train_step", recorders[0]), \
                    tt.patched(tt.jax_loop, "make_eval_step", recorders[1]), \
                    tt.patched(tt.jax_loop, "evaluate", recorders[2]):
                results = jax_cli.cli(ARGV + flags + ["--pretrained", init, "--models-dir", models, "--run-id", dtype])
            run = tt.collect_run(results, models)
            shutil.rmtree(models)
            state = results["state"]
            tree = {"params": jax.device_get(state.params), "batch_stats": jax.device_get(state.batch_stats)}
            flat = traverse_util.flatten_dict(tree, sep="/")
            stats = {k: [float(np.asarray(v, np.float64).sum()), float(np.sqrt((np.asarray(v, np.float64) ** 2).sum()))]
                     for k, v in sorted(flat.items())}
            steps = results["total_step"]
            meta["runs"][dtype] = {
                "rows": run.rows, "files": run.files, "total_step": steps,
                "n_samples_seen": results["n_samples_seen"], "best_epoch": results["best_epoch"],
                "steps_per_epoch": steps // 3, "final_test": results["final_test"],
                "final_train": results["final_train"], "eval_sweeps": [len(s) for s in draws.eval], "leaves": stats,
            }
            arrays[f"{dtype}_train_eps"] = np.stack([d[0] for d in draws.train])
            arrays[f"{dtype}_eval_eps"] = np.concatenate([np.stack(s) for s in draws.eval])
            print(f"{dtype}: {steps} steps, best epoch {results['best_epoch']}, "
                  f"final test cross-entropy {results['final_test']['cross-entropy']:.6f}")
        nb = meta["runs"]["float32"]["steps_per_epoch"]
        spec = get_transform("pianoroll", 128)[0]
        aug = [tt.jax_aug_draws(0, 1 + k // nb, k % nb, 100, spec) for k in range(3 * nb)]
        arrays["aug_dp"] = np.array([a[0] for a in aug], np.int8)
        arrays["aug_dt"] = np.array([a[1] for a in aug], np.int8)
        arrays["aug_scale"] = np.array([a[2] for a in aug], np.float32)
        meta["seconds"] = time.time() - t0
        np.savez_compressed(FIXTURE + ".npz", **arrays)
        with open(FIXTURE + ".json", "w") as f:
            json.dump(meta, f, indent=1, sort_keys=True)
            f.write("\n")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"wrote {FIXTURE}.npz ({os.path.getsize(FIXTURE + '.npz')} bytes) and .json "
          f"({os.path.getsize(FIXTURE + '.json')} bytes) in {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()

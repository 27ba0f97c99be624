"""Regenerate ``jax_folded_lines28.msgpack``: a narrow FoldedVAE checkpoint
written by the JAX package's train CLI on the CPU (one epoch of
``vae-lines-synthetic`` at 28 px, fold 4, hidden dims 8 16, latent 4, EMA
0.9, seed 0). The PyTorch port's tests and ``chip_smoke.py`` load it to
hold the port's ``.msgpack`` reader, ``--pretrained`` and the inference
CLIs against what the JAX package wrote.

    JAX_PLATFORMS=cpu python tests/fixtures/make_jax_checkpoint.py
"""

import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "jax_folded_lines28.msgpack")
ARGV = [
    "--dataset", "vae-lines-synthetic", "--transform-type", "noaug", "--image-size", "28", "--model", "FoldedVAE",
    "--fold", "4", "--hidden-dims", "8", "16", "--n_features", "4", "--epochs", "1", "--batch-size", "128",
    "--ema-decay", "0.9", "--seed", "0", "--run-name", "fixture", "--run-id", "jax", "--cpu",
]


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    from midi_vae_tpu.cli.train import cli

    tmp = tempfile.mkdtemp()
    try:
        cli(ARGV + ["--models-dir", tmp])
        shutil.copyfile(os.path.join(tmp, "vae-lines-synthetic", "fixture__jax", "checkpoint_latest.msgpack"), FIXTURE)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"wrote {FIXTURE} ({os.path.getsize(FIXTURE)} bytes)")


if __name__ == "__main__":
    main()

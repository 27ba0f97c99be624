"""Regenerate ``jax_folded_lines28.orbax/``: the state and metadata of
``jax_folded_lines28.msgpack`` (see ``make_jax_checkpoint.py``), saved again
by the JAX package's Orbax backend (``save_checkpoint(..., backend="orbax")``:
an OCDBT key-value store of zarr v2 arrays, every chunk and node
zstd-compressed). Both fixtures hold one state, so the PyTorch port's
Orbax reader is held leaf by leaf against its ``.msgpack`` reader, on the
CPU and on a machine without JAX.

    JAX_PLATFORMS=cpu python tests/fixtures/make_jax_orbax.py
"""

import os
import shutil
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "jax_folded_lines28.msgpack")
FIXTURE = os.path.join(HERE, "jax_folded_lines28.orbax")


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    import jax

    jax.config.update("jax_platforms", "cpu")
    from midi_vae_tpu.io.checkpoint import load_checkpoint, save_checkpoint

    payload = load_checkpoint(SOURCE)
    state = payload.pop("state")
    shutil.rmtree(FIXTURE, ignore_errors=True)
    save_checkpoint(FIXTURE, state, backend="orbax", **payload)
    files = [os.path.join(d, f) for d, _, names in os.walk(FIXTURE) for f in names]
    print(f"wrote {FIXTURE} ({len(files)} files, {sum(map(os.path.getsize, files))} bytes)")


if __name__ == "__main__":
    main()

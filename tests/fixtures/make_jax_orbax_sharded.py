"""Regenerate ``jax_sharded_2proc.orbax/`` and ``jax_sharded_2proc.npz``: a
state saved by the JAX package's Orbax backend
(``midi_vae_tpu/io/orbax_io.py`` ``save_checkpoint_orbax``) from two
``jax.distributed`` CPU processes of two devices each, so the directory holds
one OCDBT store per process (``ocdbt.process_0/``, ``ocdbt.process_1/``) under
a manifest that joins them. The ``.npz`` holds the arrays that were saved,
keyed by their path in the state joined with ``/`` (the bf16 leaf as its
uint16 bits), so a reader without JAX is held against them bitwise.

The state, on a mesh of the four devices (axis ``d``):

- ``params/Dense.0/kernel``: f32 [8, 6], rows sharded (a dotted flax name);
- ``params/Dense.0/bias``: f32 [6], replicated;
- ``params/cols``: f32 [5, 8], columns sharded;
- ``params/half``: bf16 [8, 3], rows sharded;
- ``stats/mean``: f32 0-d array, replicated;
- ``step``: a Python int (an Orbax scalar).

    JAX_PLATFORMS=cpu python tests/fixtures/make_jax_orbax_sharded.py
"""

import os
import shutil
import socket
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
FIXTURE = os.path.join(HERE, "jax_sharded_2proc.orbax")
ARRAYS = os.path.join(HERE, "jax_sharded_2proc.npz")
STEP = 7


def arrays() -> dict:
    """The saved arrays, from a seed (bf16 leaves as f32 values bf16 holds exactly)."""
    rng = np.random.default_rng(11)
    half = rng.standard_normal((8, 3)).astype(np.float32)
    half = (half.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)  # bf16-exact
    return {
        "params/Dense.0/kernel": rng.standard_normal((8, 6)).astype(np.float32),
        "params/Dense.0/bias": rng.standard_normal(6).astype(np.float32),
        "params/cols": rng.standard_normal((5, 8)).astype(np.float32),
        "params/half": half,
        "stats/mean": np.asarray(rng.standard_normal(), np.float32),
    }


def worker(process_id: int, coordinator: str) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=coordinator, num_processes=2, process_id=process_id)
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    sys.path.insert(0, REPO)
    from midi_vae_tpu.io.orbax_io import save_checkpoint_orbax

    assert jax.process_count() == 2 and len(jax.devices()) == 4 and len(jax.local_devices()) == 2
    mesh = Mesh(np.array(jax.devices()), ("d",))
    a = arrays()

    def put(value, spec, dtype=None):
        value = value if dtype is None else np.asarray(jnp.asarray(value, dtype))
        return jax.make_array_from_callback(value.shape, NamedSharding(mesh, spec), lambda idx: value[idx])

    state = {
        "params": {
            "Dense.0": {"kernel": put(a["params/Dense.0/kernel"], P("d", None)),
                        "bias": put(a["params/Dense.0/bias"], P())},
            "cols": put(a["params/cols"], P(None, "d")),
            "half": put(a["params/half"], P("d", None), jnp.bfloat16),
        },
        "stats": {"mean": put(a["stats/mean"], P())},
        "step": STEP,
    }
    save_checkpoint_orbax(FIXTURE, state, total_step=STEP, epoch=1)


def main() -> None:
    if len(sys.argv) == 3:
        worker(int(sys.argv[1]), sys.argv[2])
        return
    shutil.rmtree(FIXTURE, ignore_errors=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coordinator = f"127.0.0.1:{s.getsockname()[1]}"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2")
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen([sys.executable, __file__, str(i), coordinator], env=env) for i in range(2)]
    codes = [p.wait(timeout=600) for p in procs]
    if codes != [0, 0]:
        raise SystemExit(f"workers exited {codes}")
    saved = arrays()
    saved["params/half"] = (saved["params/half"].view(np.uint32) >> 16).astype(np.uint16)  # bf16 bits
    np.savez(ARRAYS, step=np.asarray(STEP), **saved)
    files = [os.path.join(d, f) for d, _, names in os.walk(FIXTURE) for f in names]
    print(f"wrote {FIXTURE} ({len(files)} files, {sum(map(os.path.getsize, files))} bytes) and {ARRAYS}")


if __name__ == "__main__":
    main()

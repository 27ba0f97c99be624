"""JAX package Orbax checkpoint directories in the PyTorch port, on the CPU.

The port reads them with its own zstd decoder, OCDBT store and zarr v2
reader (``native/zstd.cc``, ``io/ocdbt.py``, ``io/zarr2.py``,
``io/orbax_read.py``); the JAX package's ``load_checkpoint`` (Orbax and
tensorstore) is the reference, leaf by leaf and bitwise:

- (a) the three checkpoints of ``test_torch_jax_checkpoints.py``
  (Gaussian with EMA, VQ, conditional) saved with ``backend="orbax"``;
- (b) a full-width ``configs/folded.yaml`` FoldedVAE train state, whose
  weights in the port's model give the JAX forward (f32, z = mu);
- (c) arrays of many chunks: an 8-way batch-sharded array and a
  tensor-parallel state on a 4 × 2 mesh;
- (d) the directory the JAX train CLI writes with ``--checkpoint-backend
  orbax --async-checkpoint``;
- (e) a bf16 leaf, 0-d leaves, the ``.old`` fallback and a leftover
  ``.staging``;
- (f) corrupted or unsupported files raise and return nothing;
- (g) a directory two ``jax.distributed`` processes of two devices each
  saved (``ocdbt.process_0/``, ``ocdbt.process_1/``; the committed
  ``fixtures/jax_sharded_2proc.orbax``, see ``make_jax_orbax_sharded.py``):
  every leaf bitwise the arrays its script saved (``jax_sharded_2proc.npz``).

The OCDBT store is also held against tensorstore's own listing, and the
zarr reader against tensorstore on edge and missing chunks of every
dtype. On the committed fixture (``fixtures/jax_folded_lines28.orbax``,
see ``make_jax_orbax.py``): its leaves equal those of the ``.msgpack``
fixture of the same run; ``evaluate`` and ``generate --mode reconstruct``
match the JAX CLIs (f32, rtol 1e-5, z = mu); ``--pretrained`` warm-starts
from it; a resume from it is refused.
"""

import functools
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from midi_vae_tpu.cli import evaluate as jax_evaluate
from midi_vae_tpu.cli import generate as jax_generate
from midi_vae_tpu.cli import train as jax_train
from midi_vae_tpu.io.checkpoint import load_checkpoint as jax_load_checkpoint
from midi_vae_tpu.io.checkpoint import save_checkpoint as jax_save_checkpoint
from midi_vae_tpu.models.registry import build_model as jax_build_model
from midi_vae_tpu.parallel.mesh import batch_sharding, make_mesh, make_mesh_2d
from midi_vae_tpu.parallel.sharding_rules import shard_state, tp_param_specs
from midi_vae_tpu.train.state import create_train_state as jax_create_train_state
from midi_vae_tpu_torch.cli import evaluate, generate
from midi_vae_tpu_torch.interop.from_jax import load_flax_variables
from midi_vae_tpu_torch.io.checkpoint import FLAX_STATE, load_checkpoint
from midi_vae_tpu_torch.io.ocdbt import OcdbtStore
from midi_vae_tpu_torch.io.zarr2 import read_array
from midi_vae_tpu_torch.models.registry import build_model
from midi_vae_tpu_torch.train.loop import run
from test_torch_jax_checkpoints import CASES, _fixture_config, _jax_checkpoint, no_noise  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ts = pytest.importorskip("tensorstore")

_HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(_HERE, "fixtures", "jax_folded_lines28.orbax")
MSGPACK_FIXTURE = os.path.join(_HERE, "fixtures", "jax_folded_lines28.msgpack")
SHARDED_FIXTURE = os.path.join(_HERE, "fixtures", "jax_sharded_2proc.orbax")
SHARDED_ARRAYS = os.path.join(_HERE, "fixtures", "jax_sharded_2proc.npz")
FLAGSHIP = dict(hidden_dims=(48, 64, 128, 256), fold=8)  # configs/folded.yaml


def _assert_leaves_bitwise(got, want, path=""):
    """``got`` (the port's payload) equals ``want`` (the JAX package's):
    the same nesting, numpy leaves of the same dtype, shape and bytes (a
    bf16 leaf as a torch.bfloat16 tensor of the same bits)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, sorted(set(got) ^ set(want)))
        for k in want:
            _assert_leaves_bitwise(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (np.ndarray, np.generic, jax.Array)):
        want = np.asarray(want)
        if want.dtype == jnp.bfloat16:
            assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
            got, want = got.view(torch.int16).numpy(), want.view(np.int16)
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path
    else:
        assert type(got) is type(want) and got == want, path


def _jax_train_state(jmodel, input_dim: int, seed: int, ema: bool = False):
    """A JAX ``create_train_state`` state, its init traced once under jit
    (eager flax init takes ~4× as long at full width)."""
    tx = optax.adamw(1e-3)
    return jax.jit(lambda key: jax_create_train_state(jmodel, tx, key, jnp.zeros((2, input_dim, input_dim, 1)),
                                                      ema=ema))(jax.random.PRNGKey(seed))


def _assert_port_reads_as_jax(path):
    got = load_checkpoint(path)
    assert got.pop("state_format") == FLAX_STATE
    _assert_leaves_bitwise(got, jax_load_checkpoint(path))
    return got


# ------------------------------------------------------------------ (a)


@pytest.mark.parametrize("name", list(CASES))
def test_jax_orbax_checkpoints_read_bitwise(tmp_path, name):
    path, _ = _jax_checkpoint(tmp_path, name, backend="orbax")
    got = _assert_port_reads_as_jax(path)
    assert set(got["state"]) == {"params", "batch_stats", "opt_state", "step", "ema_params"}
    assert got["epoch"] == 3 and got["config"]["arch"] == CASES[name][0]


# ------------------------------------------------------------------ (b)


def test_full_width_folded_state_reads_bitwise_and_drives_the_port(tmp_path):
    jmodel = jax_build_model("FoldedVAE", in_channels=1, latent_dim=10, input_dim=128, **FLAGSHIP)
    state = _jax_train_state(jmodel, 128, seed=0, ema=True)
    rng = np.random.default_rng(1)
    state = state.replace(ema_params=jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.01, np.shape(a)).astype(np.float32), state.params))
    path = str(tmp_path / "checkpoint_latest.orbax")
    jax_save_checkpoint(path, state, config={"arch": "FoldedVAE"}, epoch=1, backend="orbax")
    got = _assert_port_reads_as_jax(path)["state"]
    n_params = sum(np.asarray(v).size for v in jax.tree_util.tree_leaves(got["params"]))
    assert n_params == 1_378_948

    model = build_model("FoldedVAE", in_channels=1, latent_dim=10, input_dim=128, device="cpu", **FLAGSHIP)
    load_flax_variables(model, got["ema_params"], got["batch_stats"])
    model.eval()
    x = rng.uniform(0, 1, (2, 128, 128, 1)).astype(np.float32)
    variables = {"params": state.ema_params, "batch_stats": state.batch_stats}

    def posterior_mean_logits(mdl, x):
        enc = mdl.encode(x, train=False)
        return enc.mu, mdl.decode_logits(enc.mu, train=False)

    mu, logits = jax.jit(functools.partial(jmodel.apply, method=posterior_mean_logits))(variables, jnp.asarray(x))
    with torch.no_grad():
        enc = model.encode(torch.from_numpy(x), train=False)
        out = model.decode_logits(enc.mu, train=False)
    np.testing.assert_allclose(enc.mu.numpy(), np.asarray(mu), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(logits), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ (c)


def test_batch_sharded_array_reads_bitwise(tmp_path, eight_devices):
    mesh = make_mesh(8)
    w = jax.device_put(jnp.arange(64, dtype=jnp.float32).reshape(16, 4), batch_sharding(mesh))
    path = str(tmp_path / "ckpt_sharded")
    jax_save_checkpoint(path, {"w": w, "step": jnp.int32(1)}, backend="orbax", epoch=1)
    store = OcdbtStore(os.path.join(path, "state"))
    assert [k for k in store.list() if k.startswith("w/")] == ["w/.zarray"] + [
        f"w/{i}.0" for i in range(8)]
    _assert_port_reads_as_jax(path)


def test_tensor_parallel_state_reads_bitwise(tmp_path, eight_devices):
    jmodel = jax_build_model("FoldedVAE", in_channels=1, latent_dim=4, input_dim=32, hidden_dims=(8, 16), fold=4)
    state = _jax_train_state(jmodel, 32, seed=2)
    mesh = make_mesh_2d(4, 2)
    state = shard_state(state, mesh, tp_param_specs(state.params))
    assert len(state.params["fc_mu"]["kernel"].sharding.device_set) == 8
    path = str(tmp_path / "tp.orbax")
    jax_save_checkpoint(path, state, config={"arch": "FoldedVAE"}, epoch=1, backend="orbax")
    store = OcdbtStore(os.path.join(path, "state"))
    assert {"params.fc_mu.kernel/0.0", "params.fc_mu.kernel/0.1", "params.decoder_input.kernel/1.0"} <= set(store.list())
    _assert_port_reads_as_jax(path)


# ------------------------------------------------------------------ (d)


def test_the_jax_train_cli_async_orbax_directory_reads_bitwise(tmp_path):
    jax_train.cli(["--dataset", "vae-lines-synthetic", "--transform-type", "noaug", "--image-size", "28", "--model",
                   "FoldedVAE", "--fold", "4", "--hidden-dims", "8", "16", "--n_features", "4", "--epochs", "1",
                   "--batch-size", "128", "--ema-decay", "0.9", "--seed", "0", "--run-name", "orbax", "--run-id",
                   "async", "--checkpoint-backend", "orbax", "--async-checkpoint", "--num-devices", "1",
                   "--models-dir", str(tmp_path),
                   "--cpu"])
    path = str(tmp_path / "vae-lines-synthetic" / "orbax__async" / "checkpoint_latest.orbax")
    got = _assert_port_reads_as_jax(path)
    assert got["epoch"] == 1 and got["config"]["checkpoint_backend"] == "orbax"


# ------------------------------------------------------------------ (e)


def test_bf16_and_0d_leaves_the_old_fallback_and_a_leftover_staging(tmp_path, capsys):
    state = {"params": {"w": jnp.linspace(-3, 3, 10, dtype=jnp.bfloat16).reshape(2, 5),
                        "dot.name": {"kernel": np.arange(6, dtype=np.float32)}},
             "step": jnp.int32(7), "count": np.int64(-3), "flag": np.array(True), "scale": np.float64(0.25),
             "ids": np.arange(5, dtype=np.uint8), "empty": {}}
    path = str(tmp_path / "ck.orbax")
    jax_save_checkpoint(path, state, backend="orbax", epoch=4)
    got = _assert_port_reads_as_jax(path)["state"]
    assert got["params"]["w"].dtype == torch.bfloat16 and got["step"].shape == () and got["empty"] == {}
    assert set(got["params"]) == {"w", "dot.name"}  # the dotted flax name stays one key

    os.rename(path, path + ".old")  # the crash between the two renames of the swap
    shutil.copytree(path + ".old", path + ".staging")  # and an async write that never finished
    shutil.rmtree(os.path.join(path + ".staging", "state", "d"))
    got_old = load_checkpoint(path)
    assert "Recovering checkpoint from swap-window fallback" in capsys.readouterr().out
    _assert_leaves_bitwise(got_old["state"], jax_load_checkpoint(path)["state"])


# ------------------------------------------------------------------ (f)


def _copy_fixture(tmp_path):
    path = str(tmp_path / "fixture.orbax")
    shutil.copytree(FIXTURE, path)
    return path


def _node_files(path):
    state = os.path.join(path, "state")
    return [os.path.join(state, "d", f) for f in sorted(os.listdir(os.path.join(state, "d")))]


@pytest.mark.parametrize("where", ["node", "manifest", "chunk"])
def test_a_corrupted_byte_raises(tmp_path, where):
    path = _copy_fixture(tmp_path)
    state = os.path.join(path, "state")
    if where == "node":
        target, at = _node_files(path)[0], 40
    elif where == "manifest":
        target, at = os.path.join(state, "manifest.ocdbt"), 20
    else:  # the largest data file: zarr chunks, which carry no checksum of their own
        data = os.path.join(state, "ocdbt.process_0", "d")
        target = max((os.path.join(data, f) for f in os.listdir(data)), key=os.path.getsize)
        at = os.path.getsize(target) // 2
    blob = bytearray(open(target, "rb").read())
    blob[at] ^= 0x10
    open(target, "wb").write(bytes(blob))
    if where == "chunk":
        # a flipped bit inside a compressed chunk either breaks the frame or changes a value;
        # the reader never returns the fixture's bytes for it
        try:
            got = load_checkpoint(path)
        except ValueError:
            return
        with pytest.raises(AssertionError):
            _assert_leaves_bitwise(got["state"], load_checkpoint(FIXTURE)["state"])
        return
    with pytest.raises(ValueError, match="CRC32C mismatch"):
        load_checkpoint(path)


def test_unsupported_layouts_raise(tmp_path):
    path = _copy_fixture(tmp_path)
    meta_path = os.path.join(path, "state", "_METADATA")
    meta = json.load(open(meta_path))
    json.dump({**meta, "use_zarr3": True}, open(meta_path, "w"))
    with pytest.raises(ValueError, match="zarr v3"):
        load_checkpoint(path)
    json.dump({**meta, "use_ocdbt": False}, open(meta_path, "w"))
    with pytest.raises(ValueError, match="not an OCDBT checkpoint"):
        load_checkpoint(path)
    json.dump(meta, open(meta_path, "w"))
    node = _node_files(path)[0]
    blob = open(node, "rb").read()
    open(node, "wb").write(blob[:-9])  # truncated: the manifest's reference runs past its end
    with pytest.raises(ValueError, match="run past the file's end"):
        load_checkpoint(path)


# ------------------------------------------------------- tensorstore as oracle


def test_ocdbt_store_lists_and_reads_what_tensorstore_does(tmp_path):
    """A store of 300 keys in a tree of several levels (small nodes), with
    inline and out-of-line values and no compression, and the fixture's."""
    directory = str(tmp_path / "kv")
    config = {"compression": None, "max_decoded_node_bytes": 256, "max_inline_value_bytes": 16}
    kv = ts.KvStore.open({**ts.KvStore.Spec(f"file://{directory}/|ocdbt:").to_json(), "config": config}).result()
    rng = np.random.default_rng(3)
    txn = ts.Transaction()
    for i in range(300):
        kv.with_transaction(txn)[f"layer.{i % 7}.w{i:04d}/{i % 3}.0".encode()] = rng.bytes(int(rng.integers(0, 40)))
    txn.commit_async().result()
    kv.write(b"layer.0.w0000/0.0", b"rewritten in a later generation").result()
    for d in (directory, os.path.join(FIXTURE, "state")):
        store = OcdbtStore(d)
        oracle = ts.KvStore.open(f"file://{d}/|ocdbt:").result()
        keys = [k.decode() for k in oracle.list().result()]
        assert store.list() == sorted(keys)
        for k in keys:
            assert store.read(k) == oracle.read(k.encode()).result().value, k
    assert OcdbtStore(directory).manifest.root_height >= 2


@pytest.mark.parametrize("dtype,fill", [("float32", 1.5), ("float64", None), ("int64", -7), ("uint8", 3),
                                        ("bool", True), ("bfloat16", 0.5)])
def test_zarr_edge_and_missing_chunks_match_tensorstore(tmp_path, dtype, fill):
    spec = ts.Spec(f"file://{tmp_path}/kv/|ocdbt:arr/|zarr2:").to_json()
    spec.update(create=True, metadata={
        "shape": [5, 7], "chunks": [2, 3], "fill_value": fill, "compressor": {"id": "zstd", "level": 1},
        "dtype": {"bfloat16": "bfloat16", "bool": "|b1"}.get(dtype, np.dtype(dtype).str)})
    arr = ts.open(spec).result()
    values = np.random.default_rng(4).normal(size=(5, 7)) * 10
    region = np.asarray(values[:3, 2:7]).astype(np.dtype(jnp.bfloat16) if dtype == "bfloat16" else dtype)
    arr[:3, 2:7].write(region).result()  # chunks (0, 0) and the bottom row stay unwritten
    want = np.asarray(arr.read().result())
    got = read_array(OcdbtStore(str(tmp_path / "kv")), "arr")
    if dtype == "bfloat16":
        got, want = got.view(torch.int16).numpy(), want.view(np.int16)
    assert got.dtype == want.dtype and got.shape == want.shape and got.tobytes() == want.tobytes()


# ------------------------------------------------------------------ (g)


def _leaf_paths(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_two_process_sharded_directory_reads_bitwise():
    """Row- and column-sharded f32, a row-sharded bf16, replicated, 0-d,
    scalar and dotted-name leaves, written as one OCDBT store per process.
    The JAX package's own loader cannot restore this directory without a
    template on another device count, so the saved arrays are the reference."""
    assert {d for d in os.listdir(os.path.join(SHARDED_FIXTURE, "state")) if d.startswith("ocdbt.")} == {
        "ocdbt.process_0", "ocdbt.process_1"}
    got = load_checkpoint(SHARDED_FIXTURE)
    assert got["state_format"] == FLAX_STATE and got["total_step"] == 7 and got["epoch"] == 1
    want = np.load(SHARDED_ARRAYS)
    leaves = dict(_leaf_paths(got["state"]))
    assert set(leaves) == set(want.files)
    assert type(leaves["step"]) is int and leaves["step"] == int(want["step"])
    bits = leaves.pop("params/half")
    assert isinstance(bits, torch.Tensor) and bits.dtype == torch.bfloat16
    assert bits.view(torch.int16).numpy().view(np.uint16).tobytes() == want["params/half"].tobytes()
    for path in set(leaves) - {"step"}:
        a, b = leaves[path], want[path]
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path


# ---------------------------------------------------------- the committed fixture


def test_fixture_leaves_equal_the_msgpack_fixture():
    got, want = load_checkpoint(FIXTURE), load_checkpoint(MSGPACK_FIXTURE)
    _assert_leaves_bitwise(got["state"], want["state"])
    assert {k: v for k, v in got.items() if k != "state"} == {k: v for k, v in want.items() if k != "state"}
    _assert_leaves_bitwise(got["state"], jax_load_checkpoint(FIXTURE)["state"])


def test_evaluate_of_the_orbax_fixture_matches_the_jax_cli(tmp_path, no_noise):  # noqa: F811
    """At ``--batch-size 8``, as for the ``.msgpack`` fixture (the JAX
    package's f32 sums drift ~1e-5 at 128 on the CPU)."""
    want_path, got_path = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    argv = ["--checkpoint", FIXTURE, "--cpu", "--partition", "all", "--batch-size", "8"]
    jax_evaluate.cli(argv + ["--json", want_path])
    evaluate.cli(argv + ["--json", got_path])
    want, got = json.load(open(want_path)), json.load(open(got_path))
    assert set(got) == set(want) == {"train", "test"}
    for part in want:
        assert set(got[part]) == set(want[part])
        for k, v in want[part].items():
            np.testing.assert_allclose(got[part][k], v, rtol=1e-5, atol=1e-7, err_msg=f"{part}/{k}")


def test_generate_reconstruct_of_the_orbax_fixture_matches_the_jax_cli(tmp_path, no_noise, monkeypatch):  # noqa: F811
    captured = []
    real = jax_generate._to_grid
    monkeypatch.setattr(jax_generate, "_to_grid", lambda images, *a, **k: captured.append(np.asarray(images))
                        or real(images, *a, **k))
    argv = ["--checkpoint", FIXTURE, "--cpu", "--mode", "reconstruct", "-n", "6"]
    jax_generate.cli(argv + ["--out", str(tmp_path / "jax.png")])
    got = generate.cli(argv + ["--out", str(tmp_path / "port.png")])
    assert got.shape == captured[0].shape == (12, 28, 28, 1)
    np.testing.assert_allclose(got, captured[0], rtol=1e-5, atol=1e-6)
    from_msgpack = generate.cli(["--checkpoint", MSGPACK_FIXTURE, "--cpu", "--mode", "reconstruct", "-n", "6",
                                 "--out", str(tmp_path / "msgpack.png")])
    np.testing.assert_array_equal(got, from_msgpack)


def test_pretrained_orbax_warm_starts_as_the_msgpack_does(tmp_path, monkeypatch):
    import midi_vae_tpu_torch.data.fetch as fetch
    import midi_vae_tpu_torch.train.loop as loop_mod

    monkeypatch.setitem(fetch.SYNTHETIC_SIZES, "vae-lines-synthetic", 256)
    seen = []
    real = loop_mod._warm_start

    def spy(state, path):
        real(state, path)
        seen.append({k: v.detach().clone() for k, v in state.model.state_dict().items()})

    monkeypatch.setattr(loop_mod, "_warm_start", spy)
    results = [run(_fixture_config(tmp_path, pretrained=p, ema_decay=0.5), device="cpu")
               for p in (FIXTURE, MSGPACK_FIXTURE)]
    assert len(seen) == 2 and seen[0].keys() == seen[1].keys()
    for k in seen[0]:
        assert torch.equal(seen[0][k], seen[1][k]), k
    assert results[0]["train"]["loss"] == results[1]["train"]["loss"]


def test_resuming_an_orbax_jax_checkpoint_is_refused(tmp_path):
    with pytest.raises(ValueError, match="cannot resume its optimizer state.*--pretrained"):
        run(_fixture_config(tmp_path, checkpoint_path=FIXTURE), device="cpu")

"""The port's remaining data and utility modules against the JAX package on
the CPU: ``make_lines_batch`` with the JAX draws injected (bitwise), the
``data.stats`` pre-flight CLI (same output) on an array corpus and an
``rrd:`` one, ``rrd:`` names through the registry and fetch (the same
lazy splits), the ``--compilation-cache`` directory, and the backend probe.
"""

import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import midi_vae_tpu.data.fetch as jax_fetch
from midi_vae_tpu.data import stats as jax_stats
from midi_vae_tpu.data.registry import image_dataset_sizes as jax_image_dataset_sizes
from midi_vae_tpu.data.synthetic import make_lines_batch as jax_make_lines_batch
from midi_vae_tpu_torch.core import backend_check, compile_cache
from midi_vae_tpu_torch.data import fetch, stats
from midi_vae_tpu_torch.data.registry import image_dataset_sizes
from midi_vae_tpu_torch.data.sources import RRDStreamDataset, write_rrd
from midi_vae_tpu_torch.data.synthetic import lines_draws, make_lines_batch, rasterize_lines
from midi_vae_tpu_torch.ops import cuda_lib
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CACHE_ENVS = (cuda_lib.BUILD_DIR_ENV, "TRITON_CACHE_DIR", "TORCHINDUCTOR_CACHE_DIR")


def _jax_lines_draws(key, batch, height=128, width=128, max_lines=20, line_width=0, full_length=False):
    """The draws of the JAX package's ``make_lines_batch`` (its key splits and calls)."""
    k_count, k_vert, k_pos, k_width, k_a, k_b = jax.random.split(key, 6)
    shape = (batch, max_lines)
    d = dict(
        num_lines=jax.random.randint(k_count, (batch, 1), 1, max_lines + 1),
        vertical=jax.random.bernoulli(k_vert, 0.5, shape),
        pos_v=jax.random.randint(k_pos, shape, 0, width),
        pos_h=jax.random.randint(jax.random.fold_in(k_pos, 1), shape, 0, height),
        w=jax.random.randint(k_width, shape, 1, 6) if line_width == 0 else jnp.full(shape, line_width, jnp.int32),
    )
    if full_length:
        z = jnp.zeros(shape, jnp.int32)
        d.update(start_v=z, end_v=z + height, start_h=z, end_h=z + width)
    else:
        sv = jax.random.randint(k_a, shape, 0, height)
        sh = jax.random.randint(jax.random.fold_in(k_a, 1), shape, 0, width)
        d.update(
            start_v=sv, end_v=sv + jax.random.randint(k_b, shape, 0, height) % jnp.maximum(height - sv, 1),
            start_h=sh, end_h=sh + jax.random.randint(jax.random.fold_in(k_b, 1), shape, 0, width)
            % jnp.maximum(width - sh, 1),
        )
    return {k: torch.from_numpy(np.array(v)) if v.dtype == jnp.bool_ else torch.from_numpy(np.array(v)).long()
            for k, v in d.items()}


@pytest.mark.parametrize("kw", [
    dict(),
    dict(height=32, width=24, max_lines=3, line_width=2, full_length=True),
    dict(height=20, width=40, max_lines=6, line_width=3),
], ids=["defaults", "full_length", "narrow"])
def test_make_lines_batch_matches_jax_with_its_draws(kw):
    key = jax.random.PRNGKey(7)
    want_img, want_n = jax_make_lines_batch(key, 12, **kw)
    size = (kw.get("height", 128), kw.get("width", 128))
    img, n = rasterize_lines(_jax_lines_draws(key, 12, **kw), *size)
    assert img.dtype == torch.float32 and img.shape == (12, *size, 1)
    np.testing.assert_array_equal(img.numpy(), np.asarray(want_img))
    np.testing.assert_array_equal(n.numpy(), np.asarray(want_n))
    assert 0 < float(img.mean()) < 1


def test_make_lines_batch_draws_the_jax_ranges():
    gen = torch.Generator().manual_seed(0)
    d = lines_draws(gen, 256, height=30, width=50, max_lines=5, device="cpu")
    assert int(d["num_lines"].min()) == 1 and int(d["num_lines"].max()) == 5
    assert int(d["w"].min()) == 1 and int(d["w"].max()) == 5
    assert int(d["pos_v"].max()) < 50 and int(d["pos_h"].max()) < 30
    assert bool((d["end_v"] >= d["start_v"]).all() and (d["end_v"] <= 30).all() and (d["end_h"] <= 50).all())
    img, n = make_lines_batch(torch.Generator().manual_seed(0), 256, height=30, width=50, max_lines=5, device="cpu")
    assert torch.equal(img, rasterize_lines(d, 30, 50)[0]) and torch.equal(n, d["num_lines"][:, 0])


@pytest.fixture(scope="module")
def rrd_corpus(tmp_path_factory):
    rng = np.random.default_rng(2)
    images = (rng.random((90, 16, 16, 1)) < 0.03).astype(np.uint8) * 255
    path = str(tmp_path_factory.mktemp("stream") / "rolls.rrd")
    write_rrd(images, rng.integers(0, 3, 90), path)
    return path


@pytest.mark.parametrize("dataset", ["vae-lines-synthetic", "rrd"], ids=["array", "rrd"])
def test_stats_cli_prints_what_jax_prints(dataset, rrd_corpus, capsys):
    name = "rrd:" + rrd_corpus if dataset == "rrd" else dataset
    argv = ["--dataset", name, "--cpu", "--max-samples", "64"]
    jax_stats.cli(argv)
    want = capsys.readouterr().out
    stats.cli(argv)
    got = capsys.readouterr().out
    assert got == want and "fill rate p = " in got
    assert ("SPARSE corpus" in got) == (dataset == "rrd")


def test_rrd_names_split_as_jax_does(rrd_corpus):
    name = "rrd:" + rrd_corpus
    assert image_dataset_sizes(name) == jax_image_dataset_sizes(name) == (-1, 16, 1)
    got = fetch.fetch_dataset(name, prototyping=True, protoval_split_rate="auto", device="cpu")
    want = jax_fetch.fetch_dataset(name, prototyping=True, protoval_split_rate="auto")
    assert got[3] is want[3] is True
    for a, b in zip(got[:3], want[:3]):
        assert isinstance(a, RRDStreamDataset) and a.path == b.path
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.labels, b.labels)
    assert stats.estimate_base_rate(got[0], max_samples=32) == jax_stats.estimate_base_rate(want[0], max_samples=32)


def test_compilation_cache_directory_receives_the_builds(tmp_path, monkeypatch):
    """Every build directory points into DIR; a fresh process given the same
    DIR finds the host libraries built and builds nothing."""
    for env in _CACHE_ENVS:
        monkeypatch.delenv(env, raising=False)
    cache = compile_cache.enable_compilation_cache(str(tmp_path / "cache"))
    assert cuda_lib.build_dir() == tmp_path / "cache" / "kernels"
    assert os.environ["TRITON_CACHE_DIR"] == str(tmp_path / "cache" / "triton")
    assert os.environ["TORCHINDUCTOR_CACHE_DIR"] == str(tmp_path / "cache" / "inductor")
    code = (
        "import sys; from midi_vae_tpu_torch.core.compile_cache import enable_compilation_cache; "
        "enable_compilation_cache(sys.argv[1]); from midi_vae_tpu_torch.native import _build; "
        "print(sorted((n, b.seconds is None) for n, b in _build.build().items()))"
    )
    env = {**os.environ, "PYTHONPATH": _REPO}
    runs = [subprocess.run([sys.executable, "-c", code, cache], capture_output=True, text=True, env=env, check=True)
            for _ in range(2)]
    assert "built host library" in runs[0].stdout and "built host library" not in runs[1].stdout
    assert runs[1].stdout.strip().endswith("[('midiparse', True), ('png', True), ('rollloader', True), ('zstd', True)]")
    assert len(list((tmp_path / "cache" / "kernels" / "host").rglob("*.so"))) == 4


def test_backend_probe_gives_up_within_its_deadline(monkeypatch):
    monkeypatch.setattr(backend_check, "_PROBE", "import time; time.sleep(60)")
    t0 = time.perf_counter()
    assert backend_check.backend_alive(timeout_s=1.0, attempts=2, verbose=False) is False
    assert time.perf_counter() - t0 < 10
    monkeypatch.setattr(backend_check, "_PROBE", "raise SystemExit(3)")
    assert backend_check.backend_alive(timeout_s=30.0, attempts=1, verbose=False) is False
    monkeypatch.setattr(backend_check, "_PROBE", "print('ok')")
    assert backend_check.backend_alive(timeout_s=30.0, attempts=1) is True

"""K3 of the port (reparameterization + KL) on the CPU: its plain Philox
draw, its plain backward against the JAX package's custom VJP, the
wrapper's checks, and the loader that builds its CUDA C++ source.

The kernel itself runs only on the card (``chip_smoke.py`` holds it
against these plain versions there). Here the draw is held by Random123's
known-answer vectors and by its statistics, since ``log`` and ``cos`` may
round differently on the CPU and the card. Gradient tolerances as in
``tests/test_torch_ops.py``: f32 rtol 1e-4 / atol 1e-6, bf16 1e-2.
"""

import math
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midi_vae_tpu.ops import fused_elbo as jax_ops
from midi_vae_tpu_torch.ops import cuda_lib
from midi_vae_tpu_torch.ops import fused_elbo as ops
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# Random123's kat_vectors for philox4x32_10: (counter, key) → output words
PHILOX_KAT = {
    "zeros": ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    "ones": ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
}


def _box_muller_f64(w0: int, w1: int) -> float:
    u1 = (w0 >> 8) * 2.0**-24 + 2.0**-25
    u2 = (w1 >> 8) * 2.0**-24
    return math.sqrt(-2.0 * math.log(u1)) * math.cos(2.0 * math.pi * u2)


@pytest.mark.parametrize("case", list(PHILOX_KAT))
def test_philox_known_answers(case):
    ctr, key, want = PHILOX_KAT[case]
    words = ops.philox4x32_10(*(torch.tensor([c], dtype=torch.int64) for c in ctr), *key)
    assert [int(w) for w in words] == list(want)


def test_k3_eps_plain_keys_counter_by_flat_index_and_key_by_seed():
    """eps[i] is Box-Muller of words 0, 1 of Philox(counter (i, 0, 0, 0), key (seed, 0));
    index 0 under seed 0 is the known-answer counter, so its words are known."""
    eps0 = ops.k3_eps_plain((1, 1), 0)
    np.testing.assert_allclose(float(eps0), _box_muller_f64(0x6627E8D5, 0xE169C58D), rtol=1e-6)
    eps = ops.k3_eps_plain((3, 7), 5)
    assert eps.shape == (3, 7) and eps.dtype == torch.float32
    for i in (0, 4, 20):
        w0, w1, _, _ = ops.philox4x32_10(torch.tensor([i]), 0, 0, 0, 5, 0)
        np.testing.assert_allclose(float(eps.reshape(-1)[i]), _box_muller_f64(int(w0), int(w1)), rtol=1e-6)


def test_k3_eps_plain_is_standard_normal():
    u1, u2 = ops.k3_uniforms_plain((65536,), 11)
    assert float(u1.min()) > 0.0 and float(u1.max()) <= 1.0
    assert float(u2.min()) >= 0.0 and float(u2.max()) < 1.0
    eps = ops.k3_eps_plain((256, 256), 11)
    assert bool(torch.isfinite(eps).all())
    assert abs(float(eps.mean())) < 0.01 and abs(float(eps.std()) - 1.0) < 0.01
    assert not torch.equal(ops.k3_eps_plain((256, 256), 12), eps)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_reparam_kl_cpu_is_plain_version_with_k3_draw(dtype):
    rng = np.random.default_rng(3)
    mu = torch.from_numpy(rng.normal(size=(33, 10)).astype(np.float32)).to(dtype)
    lv = torch.from_numpy((rng.normal(size=(33, 10)) * 0.3).astype(np.float32)).to(dtype)
    z, kl = ops.reparam_kl(mu, lv, 1234)
    z_plain, kl_plain = ops.reparam_kl_plain(mu, lv, ops.k3_eps_plain(mu.shape, 1234))
    assert z.dtype == dtype
    assert torch.equal(z, z_plain) and torch.equal(kl, kl_plain)


def _bwd_case(dtype):
    rng = np.random.default_rng(4)
    arrays = [rng.normal(size=(8, 4)) for _ in range(4)]
    arrays[1] *= 0.3
    # values representable in dtype, so both sides start from the same numbers
    return [torch.from_numpy(a.astype(np.float32)).to(dtype) for a in arrays]


@pytest.mark.parametrize("with_g_kl", [False, True], ids=["no_g_kl", "g_kl"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reparam_kl_bwd_plain_matches_pallas_vjp(dtype, with_g_kl):
    """reparam_kl_bwd_plain is _reparam_kl_bwd; no g_kl is the VJP with g_kl = 0."""
    mu, lv, z, g_z = _bwd_case(dtype)
    g_kl = torch.tensor(5.0) if with_g_kl else None
    d_mu, d_lv = ops.reparam_kl_bwd_plain(mu, lv, z, g_z, g_kl)
    assert d_mu.dtype == dtype and d_lv.dtype == dtype
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    res = tuple(jnp.asarray(t.float().numpy()).astype(jdt) for t in (mu, lv, z))
    j_mu, j_lv, _ = jax_ops._reparam_kl_bwd(
        res, (jnp.asarray(g_z.float().numpy()).astype(jdt), jnp.float32(5.0 if with_g_kl else 0.0))
    )
    tol = dict(rtol=1e-4, atol=1e-6) if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(d_mu.float().numpy(), np.asarray(j_mu.astype(jnp.float32)), **tol)
    np.testing.assert_allclose(d_lv.float().numpy(), np.asarray(j_lv.astype(jnp.float32)), **tol)


def test_fused_reparam_kl_z_only_backward_passes_no_g_kl():
    """The model uses z alone: the backward gets no kl gradient and gives the
    plain backward without its KL terms."""
    mu, lv, _, g_z = _bwd_case(torch.float32)
    mu.requires_grad_(True)
    lv.requires_grad_(True)
    z, _ = ops.fused_reparam_kl(mu, lv, 9)
    z.backward(g_z)
    d_mu, d_lv = ops.reparam_kl_bwd_plain(mu.detach(), lv.detach(), z.detach(), g_z, None)
    assert torch.equal(mu.grad, d_mu) and torch.equal(lv.grad, d_lv)


def _grad_args():
    t = torch.zeros(2, 3)
    return dict(mu=t, log_var=t, z=t, g_z=torch.ones(2, 3), g_kl=torch.tensor(1.0))


GRAD_CHECKS = {
    "shape": (dict(g_z=torch.ones(3, 2)), ValueError, "shape mismatch"),
    "dtype": (dict(z=torch.zeros(2, 3, dtype=torch.int32)), TypeError, "float32/bfloat16/float16"),
    "g_kl_not_scalar": (dict(g_kl=torch.ones(2)), ValueError, "g_kl must be a float scalar"),
    "device": (dict(mu=torch.zeros(2, 3, device="meta")), ValueError, "different devices"),
    "no_plain_path": ({k: torch.zeros(2, 3, device="meta") for k in ("mu", "log_var", "z", "g_z")} | {"g_kl": None},
                      ValueError, "no kernel and no plain path"),
}


@pytest.mark.parametrize("case", list(GRAD_CHECKS))
def test_reparam_kl_grad_checks_its_inputs(case):
    override, error, match = GRAD_CHECKS[case]
    with pytest.raises(error, match=match):
        ops.reparam_kl_grad(**(_grad_args() | override))


def _fake_nvcc(tmp_path, body: str):
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return home


def test_cuda_lib_builds_into_a_directory_keyed_by_sources_and_flags(tmp_path, monkeypatch):
    body = 'out=""\nwhile [ $# -gt 0 ]; do [ "$1" = "-o" ] && out="$2"; shift; done\n'
    body += 'echo "ptxas info    : Used 40 registers"\n: > "$out"\n'
    monkeypatch.setenv("CUDA_HOME", str(_fake_nvcc(tmp_path, body)))
    monkeypatch.setenv(cuda_lib.BUILD_DIR_ENV, str(tmp_path / "kernels"))
    assert "reparam_kl" in cuda_lib.sources()
    first = cuda_lib.build(["reparam_kl"])["reparam_kl"]
    key = cuda_lib.build_key(cuda_lib.sources()["reparam_kl"])
    assert first.path == tmp_path / "kernels" / key / "libreparam_kl.so" and first.path.is_file()
    assert first.seconds is not None and "Used 40 registers" in first.ptxas
    again = cuda_lib.build(["reparam_kl"])["reparam_kl"]
    assert again.path == first.path and again.seconds is None and again.ptxas == first.ptxas
    monkeypatch.setattr(cuda_lib, "NVCC_FLAGS", cuda_lib.NVCC_FLAGS + ("-lineinfo",))
    assert cuda_lib.build_key(cuda_lib.sources()["reparam_kl"]) != key


def test_cuda_lib_raises_on_a_failed_build_and_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(_fake_nvcc(tmp_path, 'echo "error: no sm_90a here"\nexit 1\n')))
    monkeypatch.setenv(cuda_lib.BUILD_DIR_ENV, str(tmp_path / "kernels"))
    with pytest.raises(RuntimeError, match="nvcc exited 1(.|\n)*no sm_90a here"):
        cuda_lib.build()
    assert not list((tmp_path / "kernels").rglob("*.so*"))
    monkeypatch.delenv("CUDA_HOME")
    monkeypatch.setattr(cuda_lib, "_CUDA_HOME_DEFAULT", str(tmp_path / "absent"))
    monkeypatch.setenv("PATH", str(tmp_path / "absent"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_lib.build()

"""The port's fused-ELBO ops vs the JAX package's Pallas kernels.

On the CPU each wrapper in ``midi_vae_tpu_torch.ops.fused_elbo`` runs its
kernel's plain PyTorch version; the JAX side runs the Pallas kernels in
interpret mode, as ``tests/test_ops.py`` does. Inputs come from numpy and
go to both sides. Tolerances: values rtol 1e-5 (f32 sums in different
orders), gradients rtol 1e-4 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midi_vae_tpu.ops import fused_elbo as jax_ops
from midi_vae_tpu_torch.ops import fused_elbo as ops
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _bce_case(shape, seed):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=shape) * 3).astype(np.float32)
    targets = rng.uniform(-0.5, 0.5, size=shape).astype(np.float32)
    return logits, targets


def _saturated():
    logits = np.asarray([[150.0, -150.0, 0.5, -0.5]] * 32, np.float32)
    targets = np.asarray([[0.0, 1.0, 0.3, 0.7]] * 32, np.float32)
    return logits, targets


# the shapes of tests/test_ops.py:76-116: small, ragged (105 elements), multi-block, 1-D
BCE_CASES = {
    "small": lambda: _bce_case((4, 8, 8, 1), 0),
    "ragged": lambda: _bce_case((3, 5, 7, 1), 0),
    "multiblock": lambda: _bce_case((8, 128, 128, 1), 2),
    "flat17": lambda: _bce_case((17,), 0),
    "saturated": _saturated,
}


@pytest.mark.parametrize("case", list(BCE_CASES))
def test_bce_mean_matches_pallas(case):
    logits, targets = BCE_CASES[case]()
    want = float(jax_ops.fused_bce_mean(jnp.asarray(logits), jnp.asarray(targets)))
    got = ops.fused_bce_mean(torch.from_numpy(logits), torch.from_numpy(targets))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


@pytest.mark.parametrize("case", list(BCE_CASES))
def test_bce_grad_matches_pallas_vjp(case):
    logits, targets = BCE_CASES[case]()
    want = jax.grad(lambda l: jax_ops.fused_bce_mean(l, jnp.asarray(targets)) * 2.5)(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_(True)
    (ops.fused_bce_mean(lt, torch.from_numpy(targets)) * 2.5).backward()
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)


def test_bce_bf16_logits_match_pallas():
    """bf16 logits: both sides read them exactly and compute in f32; the
    gradient comes back in bf16."""
    logits, targets = _bce_case((4, 32, 32, 1), 4)
    logits = np.asarray(jnp.asarray(logits, jnp.bfloat16).astype(jnp.float32))  # bf16-representable
    jl = jnp.asarray(logits, jnp.bfloat16)
    tl = torch.tensor(logits, dtype=torch.bfloat16, requires_grad=True)
    want = float(jax_ops.fused_bce_mean(jl, jnp.asarray(targets)))
    got = ops.fused_bce_mean(tl, torch.from_numpy(targets))
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)
    got.backward()
    assert tl.grad.dtype == torch.bfloat16
    want_g = jax.grad(lambda l: jax_ops.fused_bce_mean(l, jnp.asarray(targets)))(jl)
    np.testing.assert_allclose(tl.grad.float().numpy(), np.asarray(want_g.astype(jnp.float32)), rtol=1e-2, atol=1e-9)


def _reparam_case(seed, shape=(32, 10)):
    rng = np.random.default_rng(seed)
    mu = rng.normal(size=shape).astype(np.float32)
    lv = (rng.normal(size=shape) * 0.3).astype(np.float32)
    return mu, lv


def test_reparam_kl_plain_matches_pallas_with_its_eps():
    """The plain K3 function, fed the eps the Pallas kernel drew, gives its z and KL."""
    mu, lv = _reparam_case(0)
    jz, jkl = jax_ops.fused_reparam_kl(jnp.asarray(mu), jnp.asarray(lv), jnp.int32(0))
    eps = (np.asarray(jz, np.float64) - mu) / np.exp(0.5 * lv.astype(np.float64))
    z, kl = ops.reparam_kl_plain(torch.from_numpy(mu), torch.from_numpy(lv), torch.from_numpy(eps))
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(kl), float(jkl), rtol=1e-5)


def test_reparam_kl_cpu_draws_standard_normal_eps():
    """The CPU path draws K3's Philox noise (k3_eps_plain) keyed by the seed:
    z ~ N(mu, exp(lv)), the same seed repeats, another seed differs; KL does
    not depend on the draw."""
    mu = torch.full((4096, 16), 2.0)
    lv = torch.full((4096, 16), float(np.log(0.25)))
    z, kl = ops.reparam_kl(mu, lv, 7)
    assert abs(float(z.mean()) - 2.0) < 0.01
    assert abs(float(z.std()) - 0.5) < 0.01
    torch.testing.assert_close(ops.reparam_kl(mu, lv, 7)[0], z, rtol=0, atol=0)
    assert not torch.equal(ops.reparam_kl(mu, lv, 8)[0], z)
    _, jkl = jax_ops.fused_reparam_kl(jnp.asarray(mu.numpy()), jnp.asarray(lv.numpy()), jnp.int32(7))
    np.testing.assert_allclose(float(kl), float(jkl), rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reparam_kl_grad_matches_pallas_vjp(dtype):
    """The autograd.Function's backward is the JAX custom VJP (_reparam_kl_bwd)
    on the same residuals (mu, log_var, z) and cotangents."""
    mu, lv = _reparam_case(1, shape=(8, 4))
    g_z = np.random.default_rng(2).normal(size=mu.shape).astype(np.float32)
    mu_t = torch.from_numpy(mu).to(dtype).requires_grad_(True)
    lv_t = torch.from_numpy(lv).to(dtype).requires_grad_(True)
    z, kl = ops.fused_reparam_kl(mu_t, lv_t, 3)
    assert z.dtype == dtype and kl.dtype == torch.float32
    ((z.float() * torch.from_numpy(g_z)).sum() + 5.0 * kl).backward()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    res = tuple(jnp.asarray(t.detach().float().numpy()).astype(jdt) for t in (mu_t, lv_t, z))
    d_mu, d_lv, _ = jax_ops._reparam_kl_bwd(res, (jnp.asarray(g_z).astype(jdt), jnp.float32(5.0)))
    tol = dict(rtol=1e-4, atol=1e-6) if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(mu_t.grad.float().numpy(), np.asarray(d_mu.astype(jnp.float32)), **tol)
    np.testing.assert_allclose(lv_t.grad.float().numpy(), np.asarray(d_lv.astype(jnp.float32)), **tol)


def test_fused_elbo_terms_matches_pallas():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(4, 16, 16, 1)).astype(np.float32)
    targets = rng.uniform(0, 1, size=(4, 16, 16, 1)).astype(np.float32)
    mu = rng.normal(size=(4, 10)).astype(np.float32)
    lv = rng.normal(size=(4, 10)).astype(np.float32)
    want = jax_ops.fused_elbo_terms(*(jnp.asarray(a) for a in (logits, targets, mu, lv)), 0.00025)
    got = ops.fused_elbo_terms(*(torch.from_numpy(a) for a in (logits, targets, mu, lv)), 0.00025)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)


def test_cpu_path_launches_no_kernel_and_other_devices_raise():
    ops.reset_launch_counts()
    logits, targets = (torch.from_numpy(a) for a in _bce_case((2, 4, 4, 1), 0))
    ops.bce_mean(logits, targets)
    ops.bce_mean_grad(logits, targets, torch.tensor(1.0))
    z, _ = ops.reparam_kl(torch.zeros(2, 3), torch.zeros(2, 3), 1)
    ops.reparam_kl_grad(torch.zeros(2, 3), torch.zeros(2, 3), z, torch.ones(2, 3), torch.tensor(1.0))
    assert ops.launch_counts() == {"K1": 0, "K2": 0, "K3": 0, "K3-bwd": 0}
    meta = torch.empty((2, 4, 4, 1), device="meta")
    with pytest.raises(ValueError, match="no kernel and no plain path"):
        ops.bce_mean(meta, meta)
    with pytest.raises(ValueError, match="different devices"):
        ops.bce_mean(logits, meta)

"""The inference side of the PyTorch port against the JAX package on the CPU:
``evaluation/{inference,iwae,disentanglement}.py``, the latent collection
of the eval sweep, and ``midi/{derasterize,stats,calibrate}.py``.

Small widths (input 32, hidden (8, 16, 16), latent 4; FoldedVAE fold 4 and
VanillaVAE), weights moved from flax with ``interop/from_jax.py``, inputs
from a seed with numpy, f32. Tolerances: decoded probabilities and
latents 1e-5 absolute against the JAX functions given the same z or eps
(the JAX draw, injected); the per-step decode against one [steps·B, D]
decode 1e-6; IWAE 1e-5 relative against the JAX step and bound given the
JAX draws, chunkings of one K within 1e-6 relative; the numpy code (MIG,
MIDI statistics, calibration, export) bitwise.
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midi_vae_tpu.evaluation import disentanglement as jax_dis
from midi_vae_tpu.evaluation import inference as jax_inf
from midi_vae_tpu.evaluation.evaluate import make_eval_step as jax_make_eval_step
from midi_vae_tpu.evaluation.iwae import iwae_bound as jax_iwae_bound
from midi_vae_tpu.evaluation.iwae import make_iwae_step as jax_make_iwae_step
from midi_vae_tpu.midi import calibrate as jax_calibrate
from midi_vae_tpu.midi import derasterize as jax_derasterize
from midi_vae_tpu.midi import stats as jax_stats
from midi_vae_tpu.models.registry import build_model as jax_build_model
from midi_vae_tpu_torch.core.rng import derive_step_seed
from midi_vae_tpu_torch.data.pipeline import Batch
from midi_vae_tpu_torch.evaluation import disentanglement, inference, iwae
from midi_vae_tpu_torch.evaluation.evaluate import evaluate, make_eval_step
from midi_vae_tpu_torch.interop.from_jax import load_flax_variables
from midi_vae_tpu_torch.midi import calibrate, derasterize, stats
from midi_vae_tpu_torch.models.registry import build_model
from midi_vae_tpu_torch.serving.server import InferenceService
from test_torch_models import _randomize
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

MODEL_KW = dict(in_channels=1, latent_dim=4, input_dim=32, hidden_dims=(8, 16, 16), fold=4)
ARCHS = ["FoldedVAE", "VanillaVAE"]
ATOL = 1e-5
DENORM = ((0.5,), (1.0,))


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(JAX model, its randomised variables, the port's model with the same weights)."""
    jmodel = jax_build_model(arch, **MODEL_KW)
    variables = jmodel.init({"params": jax.random.PRNGKey(0), "reparam": jax.random.PRNGKey(1)},
                            jnp.zeros((2, 32, 32, 1)), train=True)
    variables = _randomize(variables, np.random.default_rng(5))
    model = build_model(arch, device="cpu", **MODEL_KW)
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    return jmodel, variables, model


def _images(n, seed=3):
    return (np.random.default_rng(seed).uniform(size=(n, 32, 32, 1)) > 0.7).astype(np.float32) - 0.5


def _jax_eps_of_forward(jmodel, variables, x, key):
    """The JAX eval forward's own reparameterization noise, recovered from its z."""
    out = jax.jit(functools.partial(jmodel.apply, train=False))(variables, jnp.asarray(x), rngs={"reparam": key})
    return (np.asarray(out.latents, np.float64) - np.asarray(out.encoded.mu)) / np.exp(
        0.5 * np.asarray(out.encoded.log_var, np.float64)
    )


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


# ------------------------------------------------------------ inference


@pytest.mark.parametrize("arch", ARCHS)
def test_sample_prior_matches_jax_given_its_z(arch):
    jmodel, v, model = _pair(arch)
    key = jax.random.PRNGKey(7)
    want = jax_inf.sample_prior(jmodel, v["params"], v["batch_stats"], key, 6)
    z = np.array(jax.random.normal(key, (6, 4), dtype=jnp.float32))
    _close(inference.sample_prior(model, 6, z=torch.from_numpy(z)), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_reconstruct_matches_jax_given_its_eps(arch):
    jmodel, v, model = _pair(arch)
    x, key = _images(5), jax.random.PRNGKey(9)
    want = jax_inf.reconstruct(jmodel, v["params"], v["batch_stats"], jnp.asarray(x), key)
    eps = torch.from_numpy(_jax_eps_of_forward(jmodel, v, x, key)).float()
    _close(inference.reconstruct(model, torch.from_numpy(x), eps=eps), want)


@pytest.mark.parametrize("mode", ["lerp", "slerp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_interpolate_matches_jax(arch, mode):
    jmodel, v, model = _pair(arch)
    x = _images(4)
    want = jax_inf.interpolate(jmodel, v["params"], v["batch_stats"], jnp.asarray(x[:2]), jnp.asarray(x[2:]),
                               steps=5, mode=mode)
    got = inference.interpolate(model, torch.from_numpy(x[:2]), torch.from_numpy(x[2:]), steps=5, mode=mode)
    assert got.shape == (5, 2, 32, 32, 1)
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_traverse_matches_jax(arch):
    jmodel, v, model = _pair(arch)
    x = _images(2)
    want = jax_inf.traverse(jmodel, v["params"], v["batch_stats"], jnp.asarray(x), steps=5, span=2.0)
    got = inference.traverse(model, torch.from_numpy(x), steps=5, span=2.0)
    assert got.shape == (4, 5, 32, 32, 1)
    _close(got, want)


def test_slerp_matches_jax():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(3, 4)).astype(np.float32), rng.normal(size=(3, 4)).astype(np.float32)
    t = np.linspace(0, 1, 5, dtype=np.float32).reshape(5, 1, 1)
    want = jax.vmap(lambda tt: jax_inf._slerp(jnp.asarray(a), jnp.asarray(b), tt))(jnp.asarray(t[:, 0]))
    got = inference._slerp(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", [(5, 2, 4), (4, 3, 4)], ids=["interpolation", "traversal"])
def test_one_decode_of_all_steps_equals_a_decode_per_step(arch, shape):
    """What JAX's vmap over steps computes (a decode per step) equals the
    port's single decode of [steps·B, D]: eval BatchNorm acts per sample."""
    _, _, model = _pair(arch)
    zs = torch.from_numpy(np.random.default_rng(1).normal(size=shape).astype(np.float32))
    with torch.inference_mode():
        per_step = torch.stack([model.decode(z, train=False) for z in zs])
        once = inference._decode_steps(model, zs)
    torch.testing.assert_close(once, per_step, rtol=0, atol=1e-6)


def test_draws_are_keyed_by_the_seed_alone():
    a = inference.normal_draw((4, 3), 11, "cpu")
    assert torch.equal(a, inference.normal_draw((4, 3), 11, torch.device("cpu")))
    assert not torch.equal(a, inference.normal_draw((4, 3), 12, "cpu"))
    _, _, model = _pair("FoldedVAE")
    assert torch.equal(inference.sample_prior(model, 4, 3), inference.sample_prior(model, 4, 3))
    x = torch.from_numpy(_images(2))
    assert torch.equal(inference.reconstruct(model, x, 5), inference.reconstruct(model, x, 5))


def test_served_sample_keeps_the_bucket_prefix():
    """/sample draws bucket(n) rows and returns the first n, as the JAX
    server does: sample(3, s) is the first 3 rows of sample(4, s)."""
    _, _, model = _pair("FoldedVAE")
    service = InferenceService.from_parts(model, 32, 1)
    try:
        four = service.sample(4, seed=2)
        assert np.array_equal(service.sample(3, seed=2), four[:3])
        assert np.array_equal(service.sample(1, seed=2), service.sample(1, seed=2))
        assert not np.array_equal(service.sample(4, seed=3), four)
        assert four.shape == (4, 32, 32, 1) and four.dtype == np.float32
    finally:
        service.close()


def test_reconstruction_grid_matches_jax():
    rng = np.random.default_rng(2)
    a, b = rng.uniform(size=(6, 4, 5, 1)).astype(np.float32), rng.uniform(size=(6, 4, 5, 1)).astype(np.float32)
    want = jax_inf.reconstruction_grid(jnp.asarray(a), jnp.asarray(b))
    got = inference.reconstruction_grid(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------------- IWAE


def _jax_draws(key, offset, chunk, b, d):
    return np.asarray(jax.vmap(lambda j: jax.random.normal(jax.random.fold_in(key, j), (b, d), jnp.float32))(
        offset + jnp.arange(chunk)))


@pytest.mark.parametrize("denorm", [None, DENORM], ids=["normalized", "denormalized"])
@pytest.mark.parametrize("arch", ARCHS)
def test_iwae_step_matches_jax_given_its_draws(arch, denorm):
    jmodel, v, model = _pair(arch)
    x, key = _images(5), jax.random.PRNGKey(4)
    want = jax_make_iwae_step(jmodel, 3, denorm)(v["params"], v["batch_stats"], jnp.asarray(x), None, key, jnp.int32(2))
    eps = torch.from_numpy(_jax_draws(key, 2, 3, 5, 4))
    got = iwae.make_iwae_step(model, 3, denorm)(torch.from_numpy(x), 0, 2, eps=eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


class _Loader:
    def __init__(self, batches):
        self.batches = batches

    def epoch(self, epoch):
        return iter(self.batches)


def _loaders(n_batches=2, b=4):
    """The same padded batches for both packages (the last one half padding)."""
    xs = [_images(b, seed=20 + i) for i in range(n_batches)]
    ys = [np.arange(b) % 3 + i for i in range(n_batches)]
    masks = [np.ones(b, np.float32)] * (n_batches - 1) + [(np.arange(b) < b // 2).astype(np.float32)]
    port = _Loader([Batch(x=torch.from_numpy(x), y=torch.from_numpy(y), mask=torch.from_numpy(m))
                    for x, y, m in zip(xs, ys, masks)])
    jaxl = _Loader([SimpleNamespace(x=jnp.asarray(x), y=jnp.asarray(y), mask=jnp.asarray(m))
                    for x, y, m in zip(xs, ys, masks)])
    return port, jaxl


@pytest.mark.parametrize("arch", ARCHS)
def test_iwae_bound_matches_jax_given_its_draws(arch, monkeypatch):
    jmodel, v, model = _pair(arch)
    port, jaxl = _loaders()
    seed, k, chunk = 3, 5, 2
    batch_of = {derive_step_seed(seed, i): i for i in range(2)}

    def jax_draws(batch_seed, offset, size, b, d, device):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), batch_of[batch_seed])
        return torch.from_numpy(_jax_draws(key, offset, size, b, d)).to(device)

    monkeypatch.setattr(iwae, "iwae_draws", jax_draws)
    got = iwae.iwae_bound(port, model, k=k, chunk=chunk, seed=seed, target_denorm=DENORM)
    want = jax_iwae_bound(jaxl, jmodel, SimpleNamespace(params=v["params"], batch_stats=v["batch_stats"]),
                          k=k, chunk=chunk, seed=seed, target_denorm=DENORM)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_iwae_draws_do_not_depend_on_the_chunking():
    _, _, model = _pair("FoldedVAE")
    port, _ = _loaders()
    whole = iwae.iwae_bound(port, model, k=8, chunk=8, seed=1, target_denorm=DENORM)
    parts = iwae.iwae_bound(port, model, k=8, chunk=3, seed=1, target_denorm=DENORM)  # 3 + 3 + 2
    np.testing.assert_allclose(parts, whole, rtol=1e-6)
    a = iwae.iwae_draws(7, 0, 8, 4, 4, "cpu")
    assert torch.equal(torch.cat([iwae.iwae_draws(7, 0, 3, 4, 4, "cpu"), iwae.iwae_draws(7, 3, 5, 4, 4, "cpu")]), a)


def test_iwae_refuses_bad_k_and_vq_models():
    _, _, model = _pair("FoldedVAE")
    port, _ = _loaders()
    with pytest.raises(ValueError, match="k must be"):
        iwae.iwae_bound(port, model, k=0)
    with pytest.raises(ValueError, match="Gaussian posterior"):
        iwae.iwae_bound(port, SimpleNamespace(latent_kind="vq"), k=2)
    with pytest.raises(ValueError, match="empty"):
        iwae.iwae_bound(_Loader([]), model, k=2)


# ------------------------------------------------------------------ MIG


@pytest.mark.parametrize("arch", ARCHS)
def test_encode_means_and_mig_from_loader_match_jax(arch):
    jmodel, v, model = _pair(arch)
    port, jaxl = _loaders()
    state = SimpleNamespace(params=v["params"], batch_stats=v["batch_stats"])
    mu, y = disentanglement.encode_means(port, model)
    jmu, jy = jax_dis.encode_means(jaxl, jmodel, state)
    assert mu.shape == (6, 4) and mu.dtype == np.float32
    np.testing.assert_allclose(mu, jmu, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(y, jy)
    # MIG from the JAX means, bitwise (the estimator is the same numpy code)
    got, want = disentanglement.mig_score(jmu, jy, bins=4), jax_dis.mig_score(jmu, jy, bins=4)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    assert np.isfinite(disentanglement.mig_from_loader(port, model, bins=4)["mig"])


@pytest.mark.parametrize("case", ["one_factor", "two_factors", "constant_dim", "single_class"])
def test_mig_numpy_is_the_jax_code(case):
    rng = np.random.default_rng(4)
    mu = rng.normal(size=(200, 5))
    factors = {
        "one_factor": rng.integers(0, 4, 200),
        "two_factors": rng.integers(0, 3, (200, 2)),
        "constant_dim": rng.integers(0, 4, 200),
        "single_class": np.zeros(200, np.int64),
    }[case]
    if case == "constant_dim":
        mu[:, 2] = 1.5
        mu[:, 0] = factors + 0.01 * rng.normal(size=200)
    np.testing.assert_array_equal(disentanglement.discretize(mu, 7), jax_dis.discretize(mu, 7))
    first = factors.reshape(200, -1)[:, 0]
    assert disentanglement.discrete_entropy(first) == jax_dis.discrete_entropy(first)
    assert disentanglement.discrete_mutual_information(mu[:, 0] > 0, first) == \
        jax_dis.discrete_mutual_information(mu[:, 0] > 0, first)
    got, want = disentanglement.mig_score(mu, factors, bins=7), jax_dis.mig_score(mu, factors, bins=7)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    assert np.isnan(got["mig"]) == (case == "single_class")


def test_mig_refuses_mismatched_and_empty_inputs():
    with pytest.raises(ValueError, match="factors has"):
        disentanglement.mig_score(np.zeros((3, 2)), np.zeros(4))
    with pytest.raises(ValueError, match="empty"):
        disentanglement.mig_score(np.zeros((0, 2)), np.zeros(0))


# ------------------------------------------------- eval sweep latents


def test_eval_step_latents_match_jax():
    jmodel, v, model = _pair("FoldedVAE")
    x, key = _images(4), jax.random.PRNGKey(11)
    mask = np.asarray([1, 1, 1, 0], np.float32)
    want = jax_make_eval_step(jmodel, collect_latents=True, occupancy_denorm=DENORM)(
        v["params"], v["batch_stats"], jnp.asarray(x), jnp.asarray(mask), key)
    eps = torch.from_numpy(_jax_eps_of_forward(jmodel, v, x, key)).float()
    step = make_eval_step(model, collect_latents=True, occupancy_denorm=DENORM)
    got = step(torch.from_numpy(x), torch.from_numpy(mask), 0, eps=eps)
    assert step.collect_latents and set(got) == set(want)
    _close(got["latents"], want["latents"])


def test_evaluate_collects_the_real_samples_latents():
    _, _, model = _pair("FoldedVAE")
    port, _ = _loaders()
    plain = make_eval_step(model, occupancy_denorm=DENORM)  # rebuilt with latents, its options kept
    res = evaluate(port, model, seed=4, collect_latents=True, eval_step=plain, verbosity=0)
    assert res["latents"].shape == (6, 4) and "precision" in res
    want = [model(b.x, train=False, seed=derive_step_seed(4, i)).latents[b.mask > 0] for i, b in enumerate(port.batches)]
    np.testing.assert_array_equal(res["latents"], torch.cat(want).detach().numpy())
    without = evaluate(port, model, seed=4, eval_step=plain, verbosity=0)
    assert "latents" not in without and without["cross-entropy"] == res["cross-entropy"]


# --------------------------------------------------------- MIDI export


def _rolls(n=12, seed=0):
    rng = np.random.default_rng(seed)
    probs = rng.uniform(size=(n, 32, 48)) ** 6
    probs[:, 5:7, 10:30] = 0.6  # long notes with a mid-note sag
    probs[:, 5, 18:20] = 0.08
    return probs.astype(np.float32)


@pytest.mark.parametrize("threshold", [0.1, 0.3])
def test_roll_to_notes_is_the_jax_code(threshold):
    for roll in (_rolls(2)[0], (_rolls(2)[1] * 255).astype(np.uint8), _rolls(2)[0][..., None]):
        got = derasterize.roll_to_notes(roll, threshold=threshold)
        want = jax_derasterize.roll_to_notes(roll, threshold=threshold)
        for field in ("onset", "duration", "pitch", "velocity"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
        assert len(got) > 0


def test_roll_statistics_and_js_are_the_jax_code():
    a = (_rolls(8, 1) > 0.1).astype(np.uint8)
    b = (_rolls(8, 2) > 0.3).astype(np.uint8)
    sa, sb = stats.roll_statistics(a), stats.roll_statistics(b)
    ja, jb = jax_stats.roll_statistics(a), jax_stats.roll_statistics(b)
    assert set(sa) == set(ja)
    for key in ja:
        np.testing.assert_array_equal(sa[key], ja[key])
    assert stats.js_profile(sa, sb) == jax_stats.js_profile(ja, jb)
    assert stats.js_divergence(sa["duration"], sb["duration"]) == jax_stats.js_divergence(ja["duration"], jb["duration"])
    np.testing.assert_array_equal(stats.run_lengths(a), jax_stats.run_lengths(a))


def test_calibration_is_the_jax_code():
    probs = _rolls(16, 3)
    targets = (_rolls(16, 3) > 0.1).astype(np.float32) * 0.8
    got = calibrate.calibrate_export_threshold(probs[..., None], targets)
    assert got == jax_calibrate.calibrate_export_threshold(probs[..., None], targets)
    assert got[0] in calibrate.DEFAULT_GRID and len(got[1]) == len(calibrate.DEFAULT_GRID)

"""The code priors of the PyTorch port against the JAX package's, on the
CPU: PixelCNN (features 16, 3 layers, kernel 5) and transformer (features
16, 2 layers, 2 heads) over K = 16 codes on a 4×4 grid, each also
class-conditional, with weights carried from flax.

Tolerances: logits within f32 1e-5 (absolute); ``nucleus_mask`` exact;
greedy ancestral sampling (``top_p`` 1e-6 keeps only the top code) gives
the same grids as the JAX sampler, with and without forced positions
(two cases each);
one Adam step: the loss within 1e-6 relative and the updated weights
within rtol 1e-4 / atol 1e-6, except the attention's key biases: adding
a constant to every key shifts a query's scores uniformly, which the
softmax cancels, so their exact gradient is zero and each side's is
rounding noise that Adam turns into a step of up to ±lr (held to
|difference| ≤ 2·lr); the held-out NLL within 1e-6 relative. The
draw itself comes from another generator than JAX's threefry, so it is
held statistically: the frequencies of 20,000 draws at one position
within 5 standard errors of the softmax.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from midi_vae_tpu.cli.train_prior import held_out_nll as jax_held_out_nll
from midi_vae_tpu.models import prior as jax_prior
from midi_vae_tpu_torch.cli.train_prior import build_prior, held_out_nll
from midi_vae_tpu_torch.interop.from_jax import flax_name_map, load_flax_variables
from midi_vae_tpu_torch.models.prior import (
    causal_mask,
    grid_log_likelihood,
    nucleus_mask,
    prior_nll,
    sample_codes_autoregressive,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

K, S, C = 16, 4, 3
ARCHS = {
    "pixelcnn": dict(features=16, layers=3, kernel_size=5),
    "transformer": dict(features=16, layers=2, heads=2),
}
CASES = [(arch, classes) for arch in ARCHS for classes in (0, C)]
CASE_IDS = [f"{a}{'_conditional' if c else ''}" for a, c in CASES]


def _jax_module(arch, classes):
    kw = ARCHS[arch]
    if arch == "pixelcnn":
        return jax_prior.CodePrior(num_codes=K, features=kw["features"], num_layers=kw["layers"],
                                   kernel_size=kw["kernel_size"], num_classes=classes)
    return jax_prior.TransformerCodePrior(num_codes=K, features=kw["features"], num_layers=kw["layers"],
                                          num_heads=kw["heads"], num_classes=classes)


@functools.lru_cache(maxsize=None)
def _pair(arch, classes):
    """(JAX module, its params with perturbed biases and scales, the port's prior carrying them)."""
    jp = _jax_module(arch, classes)
    y0 = jnp.zeros((1,), jnp.int32) if classes else None
    params = jax.jit(jp.init)(jax.random.PRNGKey(0), jnp.zeros((1, S, S), jnp.int32), y0)["params"]
    rng = np.random.default_rng(1)

    def leaf(path, v):
        v = np.asarray(v, np.float32)
        name = path[-1].key
        if name == "bias":
            return (0.1 * rng.normal(size=v.shape)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.normal(size=v.shape)).astype(np.float32)
        return v

    params = jax.tree_util.tree_map_with_path(leaf, params)
    prior = build_prior(arch, num_codes=K, grid=S, num_classes=classes, **ARCHS[arch])
    load_flax_variables(prior, params, {})
    return jp, params, prior


def _grids(n, seed):
    return np.random.default_rng(seed).integers(0, K, size=(n, S, S)).astype(np.int32)


def _labels(n, classes, seed=9):
    return np.random.default_rng(seed).integers(0, classes, size=n).astype(np.int32) if classes else None


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def test_causal_mask_matches_jax():
    for center in (False, True):
        np.testing.assert_array_equal(causal_mask(5, 5, center).numpy(),
                                      np.asarray(jax_prior.causal_mask(5, 5, center))[:, :, 0, 0])


@pytest.mark.parametrize("arch,classes", CASES, ids=CASE_IDS)
def test_prior_logits_match_jax(arch, classes):
    jp, params, prior = _pair(arch, classes)
    idx, y = _grids(5, 2), _labels(5, classes)
    want = jax.jit(jp.apply)({"params": params}, _j(idx), _j(y))
    with torch.no_grad():
        got = prior(_t(idx), _t(y))
    assert got.shape == (5, S, S, K)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert sorted(p for _, p in flax_name_map(prior).values()) == sorted(
        tuple(k.key for k in path) for path, _ in jax.tree_util.tree_flatten_with_path(params)[0])


@pytest.mark.parametrize("arch", list(ARCHS))
def test_prior_is_causal(arch):
    """Changing the code at raster position t moves no logits at positions ≤ t."""
    _, _, prior = _pair(arch, 0)
    base = _t(_grids(1, 3)).long()
    with torch.no_grad():
        ref = prior(base).reshape(S * S, K)
        for t in (0, 5, S * S - 1):
            moved = base.clone()
            moved.view(-1)[t] = (moved.view(-1)[t] + 1) % K
            out = prior(moved).reshape(S * S, K)
            assert torch.equal(out[: t + 1], ref[: t + 1]), t
            if t < S * S - 1:
                assert not torch.equal(out[t + 1:], ref[t + 1:]), t


@pytest.mark.parametrize("top_p", [0.1, 0.5, 0.9, 0.999, 1.0])
def test_nucleus_mask_matches_jax_exactly(top_p):
    rng = np.random.default_rng(4)
    logits = (2.0 * rng.normal(size=(32, K))).astype(np.float32)
    logits[0, :4] = logits[0, 4]  # ties keep index order, as jnp.argsort's stable sort
    got = nucleus_mask(torch.from_numpy(logits), top_p).numpy()
    want = np.asarray(jax_prior.nucleus_mask(jnp.asarray(logits), top_p))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch,classes", CASES, ids=CASE_IDS)
def test_greedy_sampler_grids_equal_jax(arch, classes):
    """top_p 1e-6 keeps the top code only: the draw is the argmax, whatever
    the generator, so the port and JAX give the same grids: free for one
    case of each architecture, with the first two time columns forced to
    known codes for the other (one compiled JAX sampler per case)."""
    jp, params, prior = _pair(arch, classes)
    n = 6
    y = _labels(n, classes)
    kw = {}
    if (arch == "pixelcnn") == bool(classes):
        mask = np.zeros((S, S), bool)
        mask[:, :2] = True
        kw = {"known": _grids(n, 5), "known_mask": mask}
    want = jax_prior.sample_codes_autoregressive(
        jp, params, jax.random.PRNGKey(0), n, S, y=_j(y), top_p=1e-6, **{k: jnp.asarray(v) for k, v in kw.items()})
    got = sample_codes_autoregressive(prior, 11, n, S, y=_t(y), top_p=1e-6, **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if kw:
        np.testing.assert_array_equal(got.numpy()[:, :, :2], kw["known"][:, :, :2])


def test_forced_positions_do_not_perturb_the_draws():
    """A full mask reproduces the known grid; forcing row 1 leaves row 0's
    free draws equal to an unconstrained run with the same seed; the
    inputs are validated as the JAX sampler validates them."""
    _, _, prior = _pair("pixelcnn", 0)
    known = _t(_grids(4, 6))
    full = sample_codes_autoregressive(prior, 7, 4, S, known=known, known_mask=np.ones((S, S), bool))
    assert torch.equal(full, known)
    mask = np.zeros((S, S), bool)
    mask[1, :] = True
    forced = sample_codes_autoregressive(prior, 7, 4, S, known=known, known_mask=mask)
    plain = sample_codes_autoregressive(prior, 7, 4, S)
    assert torch.equal(forced[:, 1], known[:, 1]) and torch.equal(forced[:, 0], plain[:, 0])
    assert torch.equal(plain, sample_codes_autoregressive(prior, 7, 4, S))
    assert int(plain.min()) >= 0 and int(plain.max()) < K
    for kw, match in (({"known": known}, "together"), ({"known_mask": mask}, "together"),
                      ({"known": known[:2], "known_mask": mask}, "known must be"),
                      ({"known": known, "known_mask": np.ones((S, S + 1), bool)}, "known_mask must be"),
                      ({"top_p": 0.0}, "top_p")):
        with pytest.raises(ValueError, match=match):
            sample_codes_autoregressive(prior, 7, 4, S, **kw)


def test_draw_frequencies_follow_the_softmax():
    """The first position's draws (temperature 2) against softmax(logits / 2);
    every other position is forced, so the sampler runs one forward."""
    _, _, prior = _pair("transformer", 0)
    n = 20000
    with torch.no_grad():
        p = torch.softmax(prior(torch.zeros(1, S, S, dtype=torch.long))[0, 0, 0] / 2.0, -1).numpy()
    mask = np.ones((S, S), bool)
    mask[0, 0] = False
    draws = sample_codes_autoregressive(prior, 3, n, S, temperature=2.0, known=torch.zeros(n, S, S, dtype=torch.long),
                                        known_mask=mask)
    freq = np.bincount(draws[:, 0, 0].numpy(), minlength=K) / n
    assert np.all(np.abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / n) + 1e-4), (freq, p)


def test_one_adam_step_matches_jax():
    """The conditional transformer: attention, MLP, LayerNorm, class bias."""
    arch, classes = "transformer", C
    jp, params, prior = _pair(arch, classes)
    prior = build_prior(arch, num_codes=K, grid=S, num_classes=classes, **ARCHS[arch])
    load_flax_variables(prior, params, {})
    idx, y = _grids(8, 7), _labels(8, classes)
    tx = optax.adam(1e-3)
    new_params, _, jnll = jax_prior.make_prior_train_step(jp, tx)(params, tx.init(params), _j(idx), _j(y))
    opt = torch.optim.Adam(prior.parameters(), lr=1e-3)
    nll = prior_nll(prior, _t(idx), _t(y))
    nll.backward()
    opt.step()
    np.testing.assert_allclose(float(nll.detach()), float(jnll), rtol=1e-6)
    want = build_prior(arch, num_codes=K, grid=S, num_classes=classes, **ARCHS[arch])
    load_flax_variables(want, jax.device_get(new_params), {})
    for name, t in prior.state_dict().items():
        w = want.state_dict()[name].numpy()
        if name.endswith("key.bias"):  # softmax-cancelled: see the module docstring
            assert np.abs(t.numpy() - w).max() <= 2e-3, name
        else:
            np.testing.assert_allclose(t.numpy(), w, rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("classes", [0, C], ids=["unconditional", "conditional"])
def test_held_out_nll_matches_jax_on_a_ragged_corpus(classes):
    """23 grids at batch 8: the ragged tail counts once, as in JAX."""
    jp, params, prior = _pair("pixelcnn", classes)
    grids, labels = _grids(23, 8), _labels(23, classes)
    want = jax_held_out_nll(jp, params, grids, labels, bs=8)
    np.testing.assert_allclose(held_out_nll(prior, grids, labels, bs=8), want, rtol=1e-6)
    with torch.no_grad():
        whole = -float(grid_log_likelihood(prior(_t(grids), _t(labels)), _t(grids))) / (S * S)
    np.testing.assert_allclose(held_out_nll(prior, grids, labels, bs=8), whole, rtol=1e-5)


def test_conditional_prior_needs_labels():
    _, _, prior = _pair("transformer", C)
    with pytest.raises(ValueError, match="class-conditional"):
        prior(_t(_grids(1, 0)))

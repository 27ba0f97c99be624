"""The VQ-VAE of the PyTorch port against the JAX package's, on the CPU:
the quantizer (indices, EMA update, eval mode, straight-through
gradient), FoldedVQVAE (fold 2, 32 px, hidden (8, 16), D = 4, K = 16) and
VQVAE with weights carried from flax, the VQ loss, one VQ train step,
codebook metrics, the marginal sampler and the registry guards.

Tolerances: forward outputs within f32 1e-5 (absolute), ``vq_loss``
within 1e-6 relative; the train step as the Gaussian one
(``tests/test_torch_train_step.py``): loss rtol 1e-5, grad norm rtol 1e-4,
updated parameters and every buffer (BatchNorm statistics and the
quantizer's codebook, cluster sizes and sums) rtol 1e-4 / atol 1e-6, with
the biases of convs that feed a BatchNorm held to 2·lr. Code indices must
be equal; a differing index is allowed only at a near-tie (the two codes'
distances within 1e-5 relative), which the seeds here do not produce.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midi_vae_tpu.core.types import EncoderOutput as JaxEncoderOutput
from midi_vae_tpu.core.types import ModelOutput as JaxModelOutput
from midi_vae_tpu.losses import schedules as jax_kl_schedules
from midi_vae_tpu.losses.vq import vq_loss as jax_vq_loss
from midi_vae_tpu.models.registry import build_model as jax_build_model
from midi_vae_tpu.models.vae import param_group_label as jax_param_group_label
from midi_vae_tpu.models.vq import VQVAE as JaxVQVAE
from midi_vae_tpu.models.vq import VectorQuantizerEMA as JaxQuantizer
from midi_vae_tpu.models.vq import codebook_metrics as jax_codebook_metrics
from midi_vae_tpu.train.optim import build_optimizer as jax_build_optimizer
from midi_vae_tpu.train.state import TrainState as JaxTrainState
from midi_vae_tpu.train.state import make_train_step as jax_make_train_step
from midi_vae_tpu_torch.core.types import EncoderOutput, ModelOutput
from midi_vae_tpu_torch.evaluation.inference import sample_prior
from midi_vae_tpu_torch.interop.from_jax import flax_name_map, load_flax_variables, to_flax_layout
from midi_vae_tpu_torch.losses import schedules as kl_schedules
from midi_vae_tpu_torch.losses.vq import vq_loss
from midi_vae_tpu_torch.models.registry import build_model
from midi_vae_tpu_torch.models.vae import param_group_label
from midi_vae_tpu_torch.models.vq import VectorQuantizerEMA, codebook_metrics
from midi_vae_tpu_torch.train import schedules
from midi_vae_tpu_torch.train.optim import build_optimizer
from midi_vae_tpu_torch.train.state import create_train_state, make_loss, make_train_step
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

K, D = 16, 4
MODELS = {
    "folded": ("FoldedVQVAE", dict(in_channels=1, latent_dim=D, input_dim=32, hidden_dims=(8, 16), fold=2,
                                   codebook_size=K)),
    "vanilla": ("VQVAE", dict(in_channels=1, latent_dim=D, input_dim=32, hidden_dims=(8, 16), codebook_size=K)),
}
ATOL = 1e-5


def _randomize(variables, rng):
    """Perturb the biases and BatchNorm scales/statistics; keep kernels and
    give the quantizer a positive, uneven usage history."""

    def leaf(path, v):
        name = path[-1].key
        v = np.asarray(v, np.float32)
        if name in ("kernel", "codebook", "embed_avg"):
            return v
        if name == "cluster_size":
            return rng.uniform(0.5, 3.0, v.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.2 * rng.normal(size=v.shape)).astype(np.float32)
        return (0.2 * rng.normal(size=v.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, variables)


@functools.lru_cache(maxsize=None)
def _jax_pair(case):
    """(flax model, perturbed variables, a batch). The variables are the
    port's initial weights in flax's layout (no flax init to compile)."""
    arch, kw = MODELS[case]
    model = build_model(arch, device="cpu", **kw)
    variables = {"params": {}, "batch_stats": {}}
    for name, (collection, path) in flax_name_map(model).items():
        node = variables[collection]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = to_flax_layout(model, name, model.state_dict()[name])
    variables = _randomize(variables, np.random.default_rng(0))
    x = np.random.default_rng(0).normal(size=(4, 32, 32, 1)).astype(np.float32)
    return jax_build_model(arch, **kw), variables, x


def _model_pair(case):
    """The flax model, its variables, the port's model carrying them, a batch."""
    jmodel, variables, x = _jax_pair(case)
    arch, kw = MODELS[case]
    model = build_model(arch, device="cpu", **kw)
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    return jmodel, variables, model, x


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got, np.float32),
                               np.asarray(want, np.float32), rtol=0, atol=atol)


def _assert_indices_equal_but_near_ties(got, want, d2):
    """Indices equal; where not, the two codes must be a near-tie in ``d2``."""
    got, want, d2 = np.asarray(got).reshape(-1), np.asarray(want).reshape(-1), np.asarray(d2).reshape(len(got), -1)
    for i in np.flatnonzero(got != want):
        a, b = d2[i, got[i]], d2[i, want[i]]
        assert abs(a - b) <= 1e-5 * max(abs(a), abs(b)), (i, got[i], want[i], a, b)


# ------------------------------------------------------------ quantizer


def test_quantizer_indices_match_jax():
    rng = np.random.default_rng(0)
    z = rng.normal(size=(256, D)).astype(np.float32)
    jq = JaxQuantizer(num_codes=K, embed_dim=D)
    v = jq.init(jax.random.PRNGKey(0), jnp.zeros((1, D)), False)
    cb = rng.normal(size=(K, D)).astype(np.float32)
    v = {"batch_stats": {**v["batch_stats"], "codebook": jnp.asarray(cb)}}
    j_st, j_idx = jq.apply(v, jnp.asarray(z), False)
    q = VectorQuantizerEMA(K, D, generator=torch.Generator().manual_seed(0))
    q.codebook.copy_(torch.from_numpy(cb))
    st, idx = q(torch.from_numpy(z), False)
    _assert_indices_equal_but_near_ties(idx.numpy(), np.asarray(j_idx), q.distances(torch.from_numpy(z)).numpy())
    _close(st, j_st)


def test_quantizer_nearest_code_and_first_index_on_a_tie():
    q = VectorQuantizerEMA(4, 2, generator=torch.Generator().manual_seed(0))
    q.codebook.copy_(torch.tensor([[0.0, 0.0], [10.0, 0.0], [0.0, 10.0], [0.0, 0.0]]))
    z = torch.tensor([[0.1, -0.2], [9.0, 1.0], [1.0, 11.0], [0.0, 0.0]])
    st, idx = q(z, False)
    assert idx.tolist() == [0, 1, 2, 0]  # rows 0 and 3 of the codebook tie: the first wins
    _close(st, q.codebook[idx])


def test_quantizer_ema_update_matches_hand_math():
    """tests/test_vq.py's hand computation of one EMA step (rtol 1e-6)."""
    decay, eps = 0.5, 1e-5
    q = VectorQuantizerEMA(2, 2, decay=decay, epsilon=eps, generator=torch.Generator().manual_seed(0))
    cb0 = np.array([[0.0, 0.0], [10.0, 10.0]], np.float32)
    q.codebook.copy_(torch.from_numpy(cb0))
    q.cluster_size.fill_(1.0)
    q.embed_avg.copy_(torch.from_numpy(cb0))
    q(torch.tensor([[1.0, 1.0], [9.0, 9.0], [11.0, 11.0]]), True)  # code 0 gets 1 vector, code 1 gets 2
    cs1 = 0.5 * np.ones(2) + 0.5 * np.array([1.0, 2.0])
    ea1 = 0.5 * cb0 + 0.5 * np.array([[1.0, 1.0], [20.0, 20.0]])
    n = cs1.sum()
    smoothed = (cs1 + eps) / (n + 2 * eps) * n
    np.testing.assert_allclose(q.cluster_size.numpy(), cs1, rtol=1e-6)
    np.testing.assert_allclose(q.embed_avg.numpy(), ea1, rtol=1e-6)
    np.testing.assert_allclose(q.codebook.numpy(), ea1 / smoothed[:, None], rtol=1e-6)


def test_quantizer_counts_are_bincount_s():
    """The EMA counts, scatter-added as f32 ones, are ``bincount``'s exactly,
    codes that no vector picks included (at decay 0 the update leaves the
    batch's counts in ``cluster_size``)."""
    q = VectorQuantizerEMA(K, D, decay=0.0, generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    idx = torch.randint(0, K // 2, (300,), generator=g)  # the upper half of the codes goes unpicked
    q._ema_update(torch.randn(300, D, generator=g), idx)
    assert torch.equal(q.cluster_size, torch.bincount(idx, minlength=K).float())
    assert torch.all(q.cluster_size[K // 2 :] == 0)


def test_quantizer_ema_update_matches_jax():
    """One train-mode call at decay 0.99 (the f32 rounding of 1 − decay
    included): buffers within rtol 1e-6."""
    rng = np.random.default_rng(3)
    z = rng.normal(size=(200, D)).astype(np.float32)
    jq = JaxQuantizer(num_codes=K, embed_dim=D)
    v = jq.init(jax.random.PRNGKey(4), jnp.zeros((1, D)), False)
    _, mut = jq.apply(v, jnp.asarray(z), True, mutable=["batch_stats"])
    q = VectorQuantizerEMA(K, D, generator=torch.Generator().manual_seed(0))
    load_flax_variables(q, {}, jax.device_get(v["batch_stats"]))
    q(torch.from_numpy(z), True)
    for name in ("codebook", "cluster_size", "embed_avg"):
        np.testing.assert_allclose(getattr(q, name).numpy(), np.asarray(mut["batch_stats"][name]), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


def test_quantizer_no_update_in_eval_mode():
    q = VectorQuantizerEMA(4, 2, generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in q.state_dict().items()}
    q(torch.randn(8, 2, generator=torch.Generator().manual_seed(1)), False)
    assert all(torch.equal(before[k], v) for k, v in q.state_dict().items())


def test_straight_through_gradient_passes_to_input():
    q = VectorQuantizerEMA(4, 2, generator=torch.Generator().manual_seed(0))
    z = torch.randn(8, 2, generator=torch.Generator().manual_seed(1), requires_grad=True)
    codes = q.codebook.clone()
    st, idx = q(z, True)
    _close(st, codes[idx])  # the value is the codes from before the update
    (st * torch.arange(2.0)).sum().backward()
    assert torch.equal(z.grad, torch.arange(2.0).expand(8, 2))
    assert not q.codebook.requires_grad


# ------------------------------------------------------------- models


@pytest.mark.parametrize("case", list(MODELS))
def test_vq_model_matches_jax(case):
    """encode, encode_indices, decode_logits of a continuous z,
    decode_indices and the eval-mode forward, within 1e-5."""
    jmodel, variables, model, x = _model_pair(case)
    z = np.random.default_rng(7).normal(size=(3, model.flat_latent_dim)).astype(np.float32)
    grids = np.random.default_rng(8).integers(0, K, size=(3, 8, 8)).astype(np.int32)

    @jax.jit
    def jax_outputs(x, z, grids):  # one program for the five entry points
        apply = functools.partial(jmodel.apply, variables)
        return (apply(x, method=JaxVQVAE.encode), apply(x, method=JaxVQVAE.encode_indices),
                apply(z, method=JaxVQVAE.decode_logits), apply(grids, method=JaxVQVAE.decode_indices),
                apply(x, train=False))

    jenc, jidx, jdec, jdec_idx, jout = jax_outputs(jnp.asarray(x), jnp.asarray(z), jnp.asarray(grids))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        enc = model.encode(xt)
        _close(enc.mu, jenc.mu)
        _close(enc.log_var, jenc.log_var)
        _close(enc.pre_latents, jenc.pre_latents)
        idx = model.encode_indices(xt)
        d2 = model.quantizer.distances(enc.mu.reshape(-1, D)).numpy()
        _assert_indices_equal_but_near_ties(idx.numpy(), np.asarray(jidx), d2)
        assert idx.dtype == torch.int32 and idx.shape == (4, 8, 8)
        _close(model.decode_logits(torch.from_numpy(z)), jdec)
        _close(model.decode_indices(torch.from_numpy(grids)), jdec_idx)
        out = model(xt, train=False)
        for field in ("logits", "output", "latents"):
            _close(getattr(out, field), getattr(jout, field))


@pytest.mark.parametrize("case", list(MODELS))
def test_vq_train_forward_updates_buffers_as_jax(case):
    """Train-mode forward: logits and every updated buffer (BatchNorm
    statistics and the quantizer's) within 1e-5."""
    jmodel, variables, model, x = _model_pair(case)
    out = model(torch.from_numpy(x), train=True)
    jout, mut = jax.jit(functools.partial(jmodel.apply, train=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    _close(out.logits, jout.logits)
    stats = jax.device_get(mut["batch_stats"])
    for name, (collection, path) in flax_name_map(model).items():
        if collection == "batch_stats":
            want = stats
            for k in path:
                want = want[k]
            _close(model.state_dict()[name], want, atol=1e-5)


@pytest.mark.parametrize("pos_weight,denorm", [(None, None), (3.0, ((0.2,), (0.4,)))], ids=["plain", "weighted_raw"])
def test_vq_loss_matches_jax(pos_weight, denorm):
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(3, 8, 8, 1)).astype(np.float32)
    x = rng.uniform(-0.5, 0.5, size=(3, 8, 8, 1)).astype(np.float32)
    mu = rng.normal(size=(3, 12)).astype(np.float32)
    lat = rng.normal(size=(3, 12)).astype(np.float32)
    want = jax_vq_loss(JaxModelOutput(output=None, logits=jnp.asarray(logits), input=jnp.asarray(x),
                                      encoded=JaxEncoderOutput(mu=jnp.asarray(mu), log_var=jnp.zeros_like(mu),
                                                               pre_latents=None),
                                      latents=jnp.asarray(lat)), 0.25, pos_weight, denorm)
    t = torch.from_numpy
    got = vq_loss(ModelOutput(output=None, logits=t(logits), input=t(x),
                              encoded=EncoderOutput(mu=t(mu), log_var=torch.zeros(3, 12), pre_latents=None),
                              latents=t(lat)), 0.25, pos_weight, denorm)
    for field in ("loss", "reconstruction_loss", "kld_loss", "kl", "kld_weight"):
        np.testing.assert_allclose(float(getattr(got, field)), float(getattr(want, field)), rtol=1e-6, err_msg=field)
    assert float(got.kl) == -float(got.kld_loss) and float(got.kld_weight) == 0.25


def test_vq_train_step_matches_jax():
    """One VQ step (AdamW, OneCycle, raw targets with pos_weight) from the
    same weights on the same batch: the VQ forward draws nothing, so both
    steps see the same inputs exactly."""
    arch, kw = MODELS["folded"]
    jmodel, variables, _ = _jax_pair("folded")
    x = (np.random.default_rng(1).uniform(size=(6, 32, 32, 1)) > 0.7).astype(np.float32)
    denorm = ((0.0,), (1.0,))
    bundle = jax_build_optimizer(None, jax_param_group_label, optimizer="AdamW", lr=1e-3, scheduler="OneCycle",
                                 total_steps=10000)
    jstate = JaxTrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                           opt_state=bundle.tx.init(variables["params"]), step=jnp.int32(0), ema_params={})
    jstep = jax_make_train_step(jmodel, bundle.tx, jax_kl_schedules.kl_weight_schedule("constant", 0.25),
                                loss_type="vq", pos_weight=2.0, target_denorm=denorm, donate=False)
    jstate, jlo, jgn = jstep(jstate, jnp.asarray(x), jax.random.PRNGKey(5))

    model = build_model(arch, device="cpu", **kw)
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    tbundle = build_optimizer(model, param_group_label, optimizer="AdamW", lr=1e-3, scheduler="OneCycle",
                              total_steps=10000)
    step = make_train_step(kl_schedules.kl_weight_schedule("constant", 0.25), loss_type="vq", pos_weight=2.0,
                           target_denorm=denorm)
    state, lo, grad_norm = step(create_train_state(model, tbundle), torch.from_numpy(x), 5)

    for field in ("loss", "reconstruction_loss", "kld_loss", "kl", "kld_weight"):
        np.testing.assert_allclose(float(getattr(lo, field)), float(getattr(jlo, field)), rtol=1e-5, err_msg=field)
    np.testing.assert_allclose(float(grad_norm), float(jgn), rtol=1e-4)
    trees = {"params": jax.device_get(jstate.params), "batch_stats": jax.device_get(jstate.batch_stats)}
    lr0 = schedules.onecycle_lr(1e-3, 10000)(0)
    for name, (collection, path) in flax_name_map(model).items():
        got = to_flax_layout(model, name, model.state_dict()[name])
        want = trees[collection]
        for k in path:
            want = want[k]
        if name.endswith(("Conv_0.bias", "ConvTranspose_0.bias")) and "Block_" in name:
            assert np.abs(got - np.asarray(want)).max() <= 2 * lr0, name  # BN-cancelled, see the docstring
        else:
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-6, err_msg=name)
    assert any("quantizer" in n for n in flax_name_map(model)) and state.step == 1


@pytest.mark.parametrize("kwargs,error", [
    (dict(loss_type="vq", fused_loss=True), ValueError),
    (dict(loss_type="vq", free_bits=0.5), ValueError),
    (dict(loss_type="vq", log_var_clamp=(-1.0, 1.0)), ValueError),
], ids=["fused", "free_bits", "log_var_clamp"])
def test_vq_loss_option_guards(kwargs, error):
    with pytest.raises(error):
        make_loss(**kwargs)


# ------------------------------------------------- metrics, sampling, registry


def test_codebook_metrics_match_jax():
    rng = np.random.default_rng(4)
    model = build_model("VQVAE", device="cpu", **MODELS["vanilla"][1])
    for cs in (rng.uniform(0.0, 5.0, K).astype(np.float32), np.zeros(K, np.float32),
               np.eye(1, K, 3, dtype=np.float32)[0]):
        model.quantizer.cluster_size.copy_(torch.from_numpy(cs))
        want = jax_codebook_metrics({"quantizer": {"cluster_size": jnp.asarray(cs)}})
        got = codebook_metrics(model)
        assert got.keys() == want.keys() and got["active-codes"] == want["active-codes"]
        np.testing.assert_allclose(got["codebook-perplexity"], want["codebook-perplexity"], rtol=1e-12)
    assert codebook_metrics(build_model("VanillaVAE", in_channels=1, latent_dim=4, input_dim=32,
                                        hidden_dims=(8, 16), device="cpu")) == {}


def test_marginal_sampler_draws_the_usage_distribution():
    """sample_codes: int32 codes in [0, K), keyed by the seed, with
    frequencies matching the EMA usage marginal (5 standard errors)."""
    model = build_model("VQVAE", device="cpu", **MODELS["vanilla"][1])
    p = np.random.default_rng(5).dirichlet(np.ones(K)).astype(np.float32)
    model.quantizer.cluster_size.copy_(torch.from_numpy(p * 100))
    a, b = model.sample_codes(64, 3), model.sample_codes(64, 3)
    assert a.dtype == torch.int32 and a.shape == (64, 8, 8) and torch.equal(a, b)
    assert not torch.equal(a, model.sample_codes(64, 4))
    freq = np.bincount(a.numpy().reshape(-1), minlength=K) / a.numel()
    assert np.all(np.abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / a.numel()) + 1e-3)
    images = sample_prior(model, 3, 2)
    assert images.shape == (3, 32, 32, 1) and float(images.min()) >= 0.0 and float(images.max()) <= 1.0
    assert torch.equal(images, model.decode_indices(model.sample_codes(3, 2)))


@pytest.mark.parametrize("kwargs,error", [
    (dict(arch="VQVAE", fused_reparam=True), ValueError),
    (dict(arch="FoldedVQVAE", num_classes=3), ValueError),
    (dict(arch="VQVAE", torch_compat=True), ValueError),
    (dict(arch="FoldedVQVAE", head="d2s"), ValueError),
    (dict(arch="FoldedVQVAE", fold=1), ValueError),
    (dict(arch="FoldedVQVAE", stem="s2d"), ValueError),
    (dict(arch="VanillaVAE", torch_compat=True, head="d2s"), ValueError),
], ids=["fused", "conditional", "torch_compat", "folded_head", "fold", "vq_stem", "vanilla_torch_compat"])
def test_registry_guards(kwargs, error):
    arch = kwargs.pop("arch")
    with pytest.raises(error):
        build_model(arch, in_channels=1, latent_dim=D, input_dim=32, hidden_dims=(8, 16), device="cpu", **kwargs)

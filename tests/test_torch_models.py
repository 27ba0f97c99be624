"""PyTorch port vs the JAX package: conv blocks, folds and whole models.

Weights go from flax to torch through ``midi_vae_tpu_torch.interop.from_jax``;
biases, BatchNorm scales and running statistics are randomised first so
every parameter path carries signal. Inputs and the reparameterization
noise come from numpy and go to both sides. f32 on the CPU; atol 1e-4
(conv sums in a different order on each side).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midi_vae_tpu.models.folded import _depth_to_space as jax_d2s
from midi_vae_tpu.models.folded import _space_to_depth as jax_s2d
from midi_vae_tpu.models.registry import build_model as jax_build_model
from midi_vae_tpu.models.vae import ConvBlock as JaxConvBlock
from midi_vae_tpu.models.vae import DeconvBlock as JaxDeconvBlock
from midi_vae_tpu.models.vae import param_group_label as jax_param_group_label
from midi_vae_tpu_torch.interop.from_jax import flax_name_map, load_flax_variables, to_flax_layout
from midi_vae_tpu_torch.models.folded import _depth_to_space, _space_to_depth
from midi_vae_tpu_torch.models.registry import build_model
from midi_vae_tpu_torch.models.vae import ConvBlock, DeconvBlock, param_group_label
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-4


def _randomize(variables, rng):
    """Perturb every non-kernel leaf (biases, BN scale/bias/mean/var)."""

    def leaf(path, v):
        name = path[-1].key
        v = np.asarray(v, np.float32)
        if name == "kernel":
            return v
        if name == "var":
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.2 * rng.normal(size=v.shape)).astype(np.float32)
        return (0.2 * rng.normal(size=v.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(variables))


def _flax_leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("channels", [1, 3])
def test_space_to_depth_matches_jax(channels):
    x = np.random.default_rng(0).normal(size=(2, 8, 12, channels)).astype(np.float32)
    got = _space_to_depth(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_s2d(jnp.asarray(x), 4)))
    back = _depth_to_space(got, 4, channels)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jax_d2s(jnp.asarray(got.numpy()), 4, channels)))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("stride,size", [(2, 8), (2, 7), (1, 6)])
def test_conv_block_matches_flax(stride, size):
    """Stride-2 SAME pads (0, 1) on even sizes and (1, 1) on odd ones."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, size, size, 4)).astype(np.float32)
    jblock = JaxConvBlock(6, stride=stride)
    variables = _randomize(jblock.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False), rng)
    tblock = ConvBlock(4, 6, stride=stride, generator=torch.Generator().manual_seed(0))
    load_flax_variables(tblock, variables["params"], variables["batch_stats"])

    for train in (False, True):  # eval first: the train pass updates the running stats
        if train:
            y, mutated = jblock.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
        else:
            y = jblock.apply(variables, jnp.asarray(x), train=False)
        got = tblock(_nchw(x), train).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), atol=ATOL)
    for name, (collection, path) in flax_name_map(tblock).items():
        if collection == "batch_stats":
            np.testing.assert_allclose(
                to_flax_layout(tblock, name, tblock.state_dict()[name]),
                _flax_leaf(mutated["batch_stats"], path), atol=ATOL, err_msg=name,
            )


def test_deconv_block_matches_flax():
    """SAME ConvTranspose = conv_transpose2d with the flipped kernel, cropped to 2h x 2w."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 5, 4, 4)).astype(np.float32)
    jblock = JaxDeconvBlock(6)
    variables = _randomize(jblock.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False), rng)
    tblock = DeconvBlock(4, 6, generator=torch.Generator().manual_seed(0))
    load_flax_variables(tblock, variables["params"], variables["batch_stats"])
    for train in (False, True):  # eval first: the train pass updates the running stats
        y = jblock.apply(variables, jnp.asarray(x), train=train, mutable=["batch_stats"])[0]
        got = tblock(_nchw(x), train).permute(0, 2, 3, 1)
        assert got.shape == (3, 10, 8, 6)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), atol=ATOL)


# (arch, input_dim, hidden_dims, fold, latent, batch): the small folded config,
# the reference layout with a center crop (28 px through 3 stages decodes to
# 32), and the flagship widths at batch 2
MODEL_CASES = {
    "folded_small": ("FoldedVAE", 32, (8, 16, 16), 4, 4, 4),
    "vanilla_crop": ("VanillaVAE", 28, (8, 16, 16), 4, 4, 3),
    "folded_flagship": ("FoldedVAE", 128, (48, 64, 128, 256), 8, 10, 2),
}


@functools.lru_cache(maxsize=None)
def _jax_side(case):
    """(flax model, randomised variables, x, eps) for a case; JAX init compiles once per case."""
    arch, input_dim, hidden, fold, latent, batch = MODEL_CASES[case]
    rng = np.random.default_rng(0)
    jmodel = jax_build_model(
        arch, in_channels=1, latent_dim=latent, input_dim=input_dim, hidden_dims=hidden, fold=fold
    )
    x = rng.uniform(0, 1, (batch, input_dim, input_dim, 1)).astype(np.float32)
    variables = jax.jit(functools.partial(jmodel.init, train=True))(
        {"params": jax.random.PRNGKey(0), "reparam": jax.random.PRNGKey(1)}, jnp.asarray(x[:2])
    )
    variables = _randomize(variables, rng)
    eps = rng.normal(size=(batch, latent)).astype(np.float32)
    return jmodel, variables, x, eps


def _model_pair(case):
    """The JAX side plus a fresh torch model carrying its weights."""
    jmodel, variables, x, eps = _jax_side(case)
    arch, input_dim, hidden, fold, latent, _ = MODEL_CASES[case]
    tmodel = build_model(
        arch, in_channels=1, latent_dim=latent, input_dim=input_dim, hidden_dims=hidden, fold=fold, device="cpu"
    )
    load_flax_variables(tmodel, variables["params"], variables["batch_stats"])
    return jmodel, variables, tmodel, x, eps


def _jax_forward_with_eps(mdl, x, eps):
    enc = mdl.encode(x, train=True)
    z = enc.mu + eps * jnp.exp(0.5 * enc.log_var)
    return enc.mu, enc.log_var, mdl.decode_logits(z, train=True)


def _jax_posterior_mean_recon(mdl, x):
    return mdl.decode(mdl.encode(x, train=False).mu, train=False)


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_train_forward_matches_flax(case):
    """Train-mode logits/mu/log_var with injected eps, and the updated BN running stats."""
    jmodel, variables, tmodel, x, eps = _model_pair(case)
    apply = jax.jit(functools.partial(jmodel.apply, method=_jax_forward_with_eps, mutable=["batch_stats"]))
    (mu, lv, logits), mutated = apply(variables, jnp.asarray(x), jnp.asarray(eps))
    out = tmodel(torch.from_numpy(x), train=True, eps=torch.from_numpy(eps))
    assert out.logits.shape == x.shape and out.logits.is_contiguous()
    np.testing.assert_allclose(out.encoded.mu.detach().numpy(), np.asarray(mu), atol=ATOL)
    np.testing.assert_allclose(out.encoded.log_var.detach().numpy(), np.asarray(lv), atol=ATOL)
    np.testing.assert_allclose(out.logits.detach().numpy(), np.asarray(logits), atol=ATOL)
    for name, (collection, path) in flax_name_map(tmodel).items():
        if collection == "batch_stats":
            np.testing.assert_allclose(
                to_flax_layout(tmodel, name, tmodel.state_dict()[name]),
                _flax_leaf(mutated["batch_stats"], path), atol=ATOL, err_msg=name,
            )


@pytest.mark.parametrize("case", ["folded_small", "vanilla_crop"])
def test_eval_reconstruction_matches_flax(case):
    """Eval-mode posterior-mean reconstruction (what /reconstruct serves)."""
    jmodel, variables, tmodel, x, _ = _model_pair(case)
    want = jax.jit(functools.partial(jmodel.apply, method=_jax_posterior_mean_recon))(variables, jnp.asarray(x))
    with torch.no_grad():
        enc = tmodel.encode(torch.from_numpy(x), train=False)
        got = tmodel.decode(enc.mu, train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_bridge_covers_every_flax_leaf_once():
    _, variables, tmodel, _, _ = _model_pair("folded_small")
    mapped = sorted((c,) + p for c, p in flax_name_map(tmodel).values())
    leaves = sorted(
        tuple(k.key for k in path) for path, _ in jax.tree_util.tree_flatten_with_path(dict(variables))[0]
    )
    assert mapped == leaves
    for name, (collection, path) in flax_name_map(tmodel).items():
        np.testing.assert_array_equal(
            to_flax_layout(tmodel, name, tmodel.state_dict()[name]), _flax_leaf(variables[collection], path)
        )
        if collection == "params":
            assert param_group_label(name) == jax_param_group_label(path)


def test_build_model_needs_a_gpu_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("FoldedVAE", in_channels=1, latent_dim=4, input_dim=32, hidden_dims=(8, 16, 16))
    model = build_model("FoldedVAE", in_channels=1, latent_dim=4, input_dim=32, hidden_dims=(8, 16, 16), device="cpu")
    assert next(model.parameters()).device.type == "cpu"


@pytest.mark.parametrize(
    "kwargs",
    [dict(arch="VanillaVAE", stem="s2d"), dict(arch="VanillaVAE", head="d2s"), dict(arch="FoldedVAE", norm="group"),
     dict(arch="VanillaVAE", torch_compat=True)],
)
def test_unported_variants_raise(kwargs):
    """These variants were refused until the port had them; each now builds
    with its flax-named layers (``tests/test_torch_variants.py`` holds them
    to the JAX package), and its combination with a variant the JAX package
    refuses beside it raises JAX's ``ValueError``."""
    arch = kwargs.pop("arch")
    kw = dict(in_channels=1, latent_dim=4, input_dim=32, hidden_dims=(8, 16, 16), device="cpu")
    model = build_model(arch, **kw, **kwargs)
    names = set(model.state_dict())
    layer = {"stem": "encoder.S2DStem_0.Conv_0.weight", "head": "final_layer.Conv_1.weight",
             "norm": "encoder.ConvBlock_0.GroupNorm_0.weight", "torch_compat": "decoder.DeconvBlock_0.ConvTranspose_0.weight"}
    assert layer[next(iter(kwargs))] in names
    clash = dict(norm="group") if "torch_compat" in kwargs else dict(torch_compat=True)
    with pytest.raises(ValueError):
        build_model(arch, **kw, **kwargs, **clash)

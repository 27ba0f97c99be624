"""The β-TC objective and MLPVAE of the PyTorch port against the JAX
package's, on the CPU.

The β-TC terms (MI, TC, DWKL) and the loss take the same numpy z, mu,
log_var, logits and targets on both sides and agree within f32 1e-5
relative, also from bf16 inputs (both sides compute in f32). One β-TC
train step, at n = 1 and with ``grad_accum`` = 2 (the estimator then
spans each micro-batch), is held as ``tests/test_torch_accum.py`` holds
its step, with each draw injected. MLPVAE carries flax's weights through
the weight bridge: its forward with injected noise, conditional or not,
agrees within 1e-5. ``configs/beta_tc_vae.yaml`` trains at narrow widths
through the train CLI.
"""

import functools
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import midi_vae_tpu_torch.data.fetch as fetch
from midi_vae_tpu.core.types import EncoderOutput as JaxEncoderOutput
from midi_vae_tpu.core.types import ModelOutput as JaxModelOutput
from midi_vae_tpu.losses import schedules as jax_kl_schedules
from midi_vae_tpu.losses.tcvae import beta_tc_elbo_loss as jax_beta_tc_elbo_loss
from midi_vae_tpu.losses.tcvae import tc_decomposition as jax_tc_decomposition
from midi_vae_tpu.models.registry import build_model as jax_build_model
from midi_vae_tpu.models.vae import param_group_label as jax_param_group_label
from midi_vae_tpu.train.optim import build_optimizer as jax_build_optimizer
from midi_vae_tpu.train.state import create_train_state as jax_create_train_state
from midi_vae_tpu.train.state import make_train_step as jax_make_train_step
from midi_vae_tpu_torch.cli.train import cli as train_cli
from midi_vae_tpu_torch.core.types import EncoderOutput, ModelOutput
from midi_vae_tpu_torch.interop.from_jax import flax_name_map, load_flax_variables
from midi_vae_tpu_torch.losses import schedules as kl_schedules
from midi_vae_tpu_torch.losses.tcvae import beta_tc_elbo_loss, tc_decomposition
from midi_vae_tpu_torch.models.mlp import MLPVAE
from midi_vae_tpu_torch.models.registry import build_model
from midi_vae_tpu_torch.models.vae import param_group_label
from midi_vae_tpu_torch.train import schedules
from midi_vae_tpu_torch.train.optim import build_optimizer
from midi_vae_tpu_torch.train.state import create_train_state, make_train_step
from test_torch_accum import assert_losses_match, assert_state_matches, micro_eps
from test_torch_models import _randomize
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, D, N_DATA = 12, 5, 785


def _terms_inputs(seed=0):
    rng = np.random.default_rng(seed)
    mu = rng.normal(size=(B, D)).astype(np.float32)
    lv = (0.5 * rng.normal(size=(B, D)) - 0.5).astype(np.float32)
    z = (mu + np.exp(0.5 * lv) * rng.normal(size=(B, D))).astype(np.float32)
    logits = rng.normal(size=(B, 8, 8, 1)).astype(np.float32)
    x = (rng.uniform(size=(B, 8, 8, 1)) > 0.7).astype(np.float32) - 0.5
    return z, mu, lv, logits, x


def _outputs(z, mu, lv, logits, x):
    jenc = JaxEncoderOutput(mu=jnp.asarray(mu), log_var=jnp.asarray(lv), pre_latents=jnp.asarray(mu))
    jout = JaxModelOutput(output=jnp.asarray(logits), logits=jnp.asarray(logits), input=jnp.asarray(x), encoded=jenc,
                          latents=jnp.asarray(z))
    t = torch.from_numpy
    enc = EncoderOutput(mu=t(mu), log_var=t(lv), pre_latents=t(mu))
    out = ModelOutput(output=t(logits), logits=t(logits), input=t(x), encoded=enc, latents=t(z))
    return out, jout


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tc_decomposition_matches_jax(dtype):
    z, mu, lv, _, _ = _terms_inputs()
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_tc_decomposition(*(jnp.asarray(a).astype(jd) for a in (z, mu, lv)), N_DATA)
    got = tc_decomposition(*(torch.from_numpy(a).to(td) for a in (z, mu, lv)), N_DATA)
    for name, g, w in zip(("mi", "tc", "dwkl"), got, want):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(log_var_clamp=(-0.8, 0.3)),
    dict(pos_weight=3.0, target_denorm=((-0.5,), (1.0,))),
], ids=["plain", "clamp", "pos_weight_denorm"])
def test_beta_tc_loss_matches_jax(kw):
    out, jout = _outputs(*_terms_inputs(1))
    want = jax_beta_tc_elbo_loss(jout, tc_beta=6.0, dataset_size=N_DATA, kld_weight=0.3, **kw)
    got = beta_tc_elbo_loss(out, tc_beta=6.0, dataset_size=N_DATA, kld_weight=0.3, **kw)
    for field in ("loss", "reconstruction_loss", "kld_loss", "kl", "kld_weight"):
        np.testing.assert_allclose(float(getattr(got, field)), float(getattr(want, field)), rtol=1e-5, err_msg=field)
    mi, tc, dwkl = tc_decomposition(out.latents, out.encoded.mu, out.encoded.log_var.clamp(
        *kw.get("log_var_clamp", (-np.inf, np.inf))), N_DATA)
    assert float(got.kl) == pytest.approx(float(mi + tc + dwkl), rel=1e-6) and float(got.kld_loss) == -float(got.kl)


VAE_KW = dict(in_channels=1, latent_dim=4, input_dim=28, hidden_dims=(8, 16))
OPT_KW = dict(optimizer="AdamW", lr=1e-3, scheduler="OneCycle", total_steps=10000, weight_decay=1e-5)


@pytest.mark.parametrize("n", [1, 2], ids=["step", "grad_accum2"])
def test_beta_tc_step_matches_jax(n):
    x = (np.random.default_rng(2).uniform(size=(8, 28, 28, 1)) > 0.7).astype(np.float32)
    epoch_key = jax.random.PRNGKey(3)
    jmodel = jax_build_model("VanillaVAE", **VAE_KW)
    bundle = jax_build_optimizer(None, jax_param_group_label, **OPT_KW)
    jstate = jax_create_train_state(jmodel, bundle.tx, jax.random.PRNGKey(0), jnp.asarray(x[:2]))
    variables = _randomize({"params": jstate.params, "batch_stats": jstate.batch_stats}, np.random.default_rng(0))
    jstate = jstate.replace(params=variables["params"], batch_stats=variables["batch_stats"],
                            opt_state=bundle.tx.init(variables["params"]))
    step_key = jax.random.fold_in(epoch_key, 0)
    if n == 1:  # an unaccumulated step draws under the step key itself
        out, _ = jax.jit(functools.partial(jmodel.apply, train=True, mutable=["batch_stats"]))(
            variables, jnp.asarray(x), rngs={"reparam": step_key})
        eps = torch.from_numpy((np.asarray(out.latents, np.float64) - np.asarray(out.encoded.mu)) / np.exp(
            0.5 * np.asarray(out.encoded.log_var, np.float64)))
    else:
        eps = micro_eps(jmodel, variables, x, step_key, n)
    sched = dict(tc_beta=6.0, dataset_size=N_DATA, grad_accum=n)
    jstep = jax_make_train_step(jmodel, bundle.tx, jax_kl_schedules.kl_weight_schedule("constant", 0.5),
                                loss_type="beta-tc", donate=False, **sched)
    jstate, jlo, jgn = jstep(jstate, jnp.asarray(x), epoch_key)

    model = build_model("VanillaVAE", device="cpu", **VAE_KW)
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    state = create_train_state(model, build_optimizer(model, param_group_label, **OPT_KW))
    step = make_train_step(kl_schedules.kl_weight_schedule("constant", 0.5), loss_type="beta-tc", **sched)
    state, lo, grad_norm = step(state, torch.from_numpy(x), 3, eps=eps)
    assert_losses_match(lo, jlo, grad_norm, jgn)
    assert_state_matches(model, jstate, schedules.onecycle_lr(1e-3, 10000)(0))


MLP_KW = dict(in_channels=1, latent_dim=4, input_dim=12, hidden_dims=(24, 16))


def _jax_forward_with_eps(mdl, x, eps, y=None):
    yk = {} if y is None else {"y": y}
    enc = mdl.encode(x, train=True, **yk)
    z = enc.mu + eps * jnp.exp(0.5 * enc.log_var)
    return enc.mu, enc.log_var, mdl.decode_logits(z, train=True, **yk)


@pytest.mark.parametrize("num_classes", [0, 3], ids=["unconditional", "conditional"])
def test_mlpvae_forward_matches_flax(num_classes):
    rng = np.random.default_rng(4)
    x = rng.uniform(size=(5, 12, 12, 1)).astype(np.float32)
    eps = rng.normal(size=(5, 4)).astype(np.float32)
    y = np.array([0, 2, 1, 2, 0]) if num_classes else None
    jmodel = jax_build_model("MLPVAE", output_logit_bias=-2.0, num_classes=num_classes, **MLP_KW)
    yk = {} if y is None else {"y": jnp.asarray(y)}
    variables = jmodel.init({"params": jax.random.PRNGKey(0), "reparam": jax.random.PRNGKey(1)}, jnp.asarray(x), **yk)
    variables = _randomize(variables, rng)
    model = build_model("MLPVAE", output_logit_bias=-2.0, num_classes=num_classes, device="cpu", **MLP_KW)
    assert isinstance(model, MLPVAE) and model.decoder_out.bias.shape == (144,)
    load_flax_variables(model, variables["params"], variables.get("batch_stats", {}))
    mapped = sorted(p for _, p in flax_name_map(model).values())
    assert mapped == sorted(tuple(k.key for k in path) for path, _ in
                            jax.tree_util.tree_flatten_with_path(variables["params"])[0])
    mu, lv, logits = jmodel.apply(variables, jnp.asarray(x), jnp.asarray(eps), method=_jax_forward_with_eps,
                                  **({} if y is None else {"y": jnp.asarray(y)}))
    out = model(torch.from_numpy(x), train=True, eps=torch.from_numpy(eps),
                **({} if y is None else {"y": torch.from_numpy(y)}))
    for got, want in ((out.encoded.mu, mu), (out.encoded.log_var, lv), (out.logits, logits)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    if num_classes:
        with pytest.raises(ValueError, match="requires labels y"):
            model(torch.from_numpy(x), eps=torch.from_numpy(eps))


def test_mlpvae_fused_reparam_draws_k3s_noise():
    """With ``fused_reparam`` the model draws through K3 (its plain version
    on the CPU): z is the reparameterization of K3's own eps."""
    from midi_vae_tpu_torch.ops.fused_elbo import fused_reparam_kl

    model = build_model("MLPVAE", fused_reparam=True, device="cpu", **MLP_KW)
    x = torch.rand(3, 12, 12, 1)
    out = model(x, train=True, seed=11)
    z, _ = fused_reparam_kl(out.encoded.mu.detach(), out.encoded.log_var.detach(), 11)
    np.testing.assert_array_equal(out.latents.detach().numpy(), z.numpy())


@pytest.mark.parametrize("kwargs,error,match", [
    (dict(norm="group"), ValueError, "MLPVAE has no norm layers"),
    (dict(stem="s2d"), ValueError, "MLPVAE has neither"),
    (dict(num_classes=-1), ValueError, "known class"),
], ids=["norm", "stem", "negative_classes"])
def test_mlpvae_registry_guards(kwargs, error, match):
    with pytest.raises(error, match=match):
        build_model("MLPVAE", device="cpu", **MLP_KW, **kwargs)


def test_beta_tc_config_trains_at_narrow_width(tmp_path, monkeypatch):
    """configs/beta_tc_vae.yaml as written but narrow: VanillaVAE (8, 8, 16,
    16) at 128 px on a 16-file midi-synthetic corpus, 1 epoch."""
    monkeypatch.setitem(fetch.SYNTHETIC_SIZES, "midi-synthetic", 16)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    r = train_cli(["--config", os.path.join(_REPO, "configs", "beta_tc_vae.yaml"), "--hidden-dims", "8", "8", "16",
                   "16", "--batch-size", "8", "--epochs", "1", "--models-dir", str(tmp_path / "m"), "--cpu"])
    assert r["state"].model.hidden_dims == (8, 8, 16, 16)
    assert all(np.isfinite([r["train"]["loss"], r["final_test"]["kl"], r["final_test"]["cross-entropy"]]))

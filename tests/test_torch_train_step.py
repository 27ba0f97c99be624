"""One train step of the PyTorch port vs the JAX package's step, plus the
losses and schedules the step reads.

Both steps start from the same weights (flax → torch through the weight
bridge) on the same batch with the same reparameterization noise: the eps
of the JAX step is recovered from its own forward pass under the step's
key and injected into the torch step. f32 on the CPU. Tolerances: loss
rtol 1e-5, grad norm rtol 1e-4, every updated parameter and running
statistic rtol 1e-4 / atol 1e-6 (Adam's first step moves each parameter
by about lr·sign(g), so the parameters agree far more tightly than the
gradients need to). The exception are the biases of the convs that feed a
BatchNorm: their exact gradient is zero (BN subtracts the batch mean), so
each side's gradient is rounding noise and Adam turns it into a step of up
to ±lr in either direction; those are held to |difference| ≤ 2·lr.
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
from midi_vae_tpu.models.registry import build_model as jax_build_model
from midi_vae_tpu.models.vae import param_group_label as jax_param_group_label
from midi_vae_tpu.train import schedules as jax_schedules
from midi_vae_tpu.train.optim import build_optimizer as jax_build_optimizer
from midi_vae_tpu.train.state import create_train_state as jax_create_train_state
from midi_vae_tpu.train.state import make_loss as jax_make_loss
from midi_vae_tpu.train.state import make_train_step as jax_make_train_step
from midi_vae_tpu_torch.core.types import EncoderOutput, ModelOutput
from midi_vae_tpu_torch.interop.from_jax import flax_name_map, load_flax_variables, to_flax_layout
from midi_vae_tpu_torch.losses import schedules as kl_schedules
from midi_vae_tpu_torch.models.registry import build_model
from midi_vae_tpu_torch.models.vae import param_group_label
from midi_vae_tpu_torch.train import schedules
from midi_vae_tpu_torch.train.optim import build_optimizer
from midi_vae_tpu_torch.train.state import create_train_state, derive_step_seed, make_loss, make_train_step
from test_torch_models import _flax_leaf, _randomize
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

MODEL_KW = dict(in_channels=1, latent_dim=4, input_dim=32, hidden_dims=(8, 16, 16), fold=4)
BATCH = 6
KL_WEIGHT = 0.05  # large enough that the KL path moves the latent heads visibly

# name → (fused kernels on, optimizer options); the bench's AdamW/OneCycle
# settings, and a case with clipping, a frozen encoder, a decoder LR
# multiplier and weight decay
STEP_CASES = {
    "unfused": (False, dict()),
    "fused": (True, dict()),
    "clip_frozen_decay": (False, dict(grad_clip=1e-3, freeze_encoder=True, lr_decoder_mult=2.0, weight_decay=1e-4)),
}


def _jax_step(fused, opt_kw, x, epoch_key):
    model = jax_build_model("FoldedVAE", fused_reparam=fused, **MODEL_KW)
    bundle = jax_build_optimizer(
        None, jax_param_group_label, optimizer="AdamW", lr=1e-3, scheduler="OneCycle", total_steps=10000, **opt_kw
    )
    state = jax_create_train_state(model, bundle.tx, jax.random.PRNGKey(0), jnp.asarray(x[:2]))
    variables = _randomize({"params": state.params, "batch_stats": state.batch_stats}, np.random.default_rng(0))
    state = state.replace(
        params=variables["params"], batch_stats=variables["batch_stats"], opt_state=bundle.tx.init(variables["params"])
    )
    # the step's own draw: its forward under the step's key (train/state.py:311)
    out, _ = jax.jit(functools.partial(model.apply, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x), rngs={"reparam": jax.random.fold_in(epoch_key, state.step)}
    )
    eps = (np.asarray(out.latents, np.float64) - np.asarray(out.encoded.mu)) / np.exp(
        0.5 * np.asarray(out.encoded.log_var, np.float64)
    )
    step = jax_make_train_step(
        model, bundle.tx, jax_kl_schedules.kl_weight_schedule("constant", KL_WEIGHT), fused_loss=fused, donate=False
    )
    new_state, lo, grad_norm = step(state, jnp.asarray(x), epoch_key)
    return variables, eps, new_state, lo, grad_norm


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_jax(case):
    fused, opt_kw = STEP_CASES[case]
    x = (np.random.default_rng(1).uniform(size=(BATCH, 32, 32, 1)) > 0.7).astype(np.float32)
    variables, eps, jstate, jlo, jgn = _jax_step(fused, opt_kw, x, jax.random.PRNGKey(5))

    model = build_model("FoldedVAE", fused_reparam=fused, device="cpu", **MODEL_KW)
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    bundle = build_optimizer(
        model, param_group_label, optimizer="AdamW", lr=1e-3, scheduler="OneCycle", total_steps=10000, **opt_kw
    )
    state = create_train_state(model, bundle)
    step = make_train_step(kl_schedules.kl_weight_schedule("constant", KL_WEIGHT), fused_loss=fused)
    state, lo, grad_norm = step(state, torch.from_numpy(x), 5, eps=torch.from_numpy(eps))

    assert state.step == 1
    for field in ("loss", "reconstruction_loss", "kld_loss", "kl", "kld_weight"):
        np.testing.assert_allclose(float(getattr(lo, field)), float(getattr(jlo, field)), rtol=1e-5, err_msg=field)
    np.testing.assert_allclose(float(grad_norm), float(jgn), rtol=1e-4)
    trees = {"params": jax.device_get(jstate.params), "batch_stats": jax.device_get(jstate.batch_stats)}
    lr0 = schedules.onecycle_lr(1e-3 * opt_kw.get("lr_decoder_mult", 1.0), 10000)(0)
    for name, (collection, path) in flax_name_map(model).items():
        got = to_flax_layout(model, name, model.state_dict()[name])
        want = _flax_leaf(trees[collection], path)
        if name.endswith(("Conv_0.bias", "ConvTranspose_0.bias")) and "Block_" in name:
            assert np.abs(got - want).max() <= 2 * lr0, name  # BN-cancelled: see the module docstring
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("total_steps", [10000, 250])
def test_onecycle_schedules_match_jax(total_steps):
    """The bench's horizon (warm-up only over 200 steps) and a short one that
    passes the peak at step 74 and anneals."""
    steps = np.arange(200)
    for port, ref in (
        (schedules.onecycle_lr(1e-3, total_steps), jax_schedules.onecycle_lr(1e-3, total_steps)),
        (schedules.onecycle_momentum(total_steps), jax_schedules.onecycle_momentum(total_steps)),
    ):
        want = np.asarray(jax.vmap(ref)(jnp.asarray(steps)))
        np.testing.assert_allclose([port(int(s)) for s in steps], want, rtol=1e-6)


@pytest.mark.parametrize("kind", ["constant", "multiplicative", "linear", "cyclical"])
def test_kl_weight_schedules_match_jax(kind):
    kw = dict(weight=0.5, warmup_steps=40, period=30, growth=1.05)
    port, ref = kl_schedules.kl_weight_schedule(kind, **kw), jax_kl_schedules.kl_weight_schedule(kind, **kw)
    for s in range(100):
        np.testing.assert_allclose(port(s), float(ref(jnp.int32(s))), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize(
    "fused,pos_weight,log_var_clamp",
    [(False, None, None), (False, 4.0, None), (False, None, (-0.5, 0.5)), (True, None, None), (True, None, (-0.5, 0.5))],
)
def test_loss_matches_jax(fused, pos_weight, log_var_clamp):
    """make_loss on both sides: the unfused ELBO (elbo_loss) and the fused one
    (fused_elbo_terms: K1 plain here, Pallas interpret there)."""
    rng = np.random.default_rng(7)
    arrays = dict(
        logits=rng.normal(size=(4, 8, 8, 1)) * 3, x=rng.uniform(-0.5, 0.5, (4, 8, 8, 1)),
        mu=rng.normal(size=(4, 5)), lv=rng.normal(size=(4, 5)),
    )
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}

    def output(cls_out, cls_enc, conv):
        a = {k: conv(v) for k, v in arrays.items()}
        enc = cls_enc(mu=a["mu"], log_var=a["lv"], pre_latents=a["mu"])
        return cls_out(output=a["logits"], logits=a["logits"], input=a["x"], encoded=enc, latents=a["mu"])

    kw = dict(fused_loss=fused, pos_weight=pos_weight, log_var_clamp=log_var_clamp)
    want = jax_make_loss(**kw)(output(JaxModelOutput, JaxEncoderOutput, jnp.asarray), 0.3)
    got = make_loss(**kw)(output(ModelOutput, EncoderOutput, torch.from_numpy), 0.3)
    for field in ("loss", "reconstruction_loss", "kld_loss", "kl", "kld_weight"):
        np.testing.assert_allclose(float(getattr(got, field)), float(getattr(want, field)), rtol=1e-5, err_msg=field)


@pytest.mark.parametrize(
    "kwargs,error",
    [
        (dict(loss_type="nope"), ValueError),
        (dict(loss_type="beta-tc", fused_loss=True), ValueError),
        (dict(free_bits=0.1, fused_loss=True), ValueError),
        (dict(pos_weight=2.0, fused_loss=True), ValueError),
        (dict(target_denorm=((0.5,), (1.0,)), fused_loss=True), ValueError),
        (dict(loss_type="vq", log_var_clamp=(-1.0, 1.0)), ValueError),
        # ids kept from when the port refused these three options; they build working steps now
        pytest.param(dict(loss_type="beta-tc"), None, id="kwargs6-NotImplementedError"),
        (dict(grad_accum=0), ValueError),
        pytest.param(dict(grad_accum=2), None, id="kwargs8-NotImplementedError"),
        pytest.param(dict(loss_type="vq", grad_accum=2), None, id="kwargs9-NotImplementedError"),
    ],
)
def test_step_option_checks(kwargs, error):
    """Incompatible options raise; β-TC and grad_accum build a step that
    takes one finite step (on a VQ model for the VQ objective)."""
    if error is not None:
        with pytest.raises(error):
            make_train_step(kl_schedules.constant(1.0), **kwargs)
        return
    arch = "FoldedVQVAE" if kwargs.get("loss_type") == "vq" else "FoldedVAE"
    model = build_model(arch, device="cpu", **MODEL_KW)
    state = create_train_state(model, build_optimizer(model, param_group_label, lr=1e-3, total_steps=100))
    x = torch.from_numpy((np.random.default_rng(0).uniform(size=(BATCH, 32, 32, 1)) > 0.7).astype(np.float32))
    state, lo, grad_norm = make_train_step(kl_schedules.constant(0.25), **kwargs)(state, x, 0)
    assert state.step == 1 and np.isfinite(float(lo.loss)) and float(grad_norm) > 0


def test_make_loss_unfused_free_bits_not_ported():
    """Free bits are ported now (the name is kept): the unfused loss takes
    them and matches the JAX package's."""
    mu, lv = np.full((2, 3), 0.2, np.float32), np.zeros((2, 3), np.float32)
    enc = EncoderOutput(mu=torch.from_numpy(mu), log_var=torch.from_numpy(lv), pre_latents=torch.from_numpy(mu))
    out = ModelOutput(output=torch.zeros(2, 4), logits=torch.zeros(2, 4), input=torch.zeros(2, 4), encoded=enc, latents=enc.mu)
    got = make_loss(free_bits=0.1)(out, 1.0)
    jenc = JaxEncoderOutput(mu=jnp.asarray(mu), log_var=jnp.asarray(lv), pre_latents=jnp.asarray(mu))
    jout = JaxModelOutput(output=jnp.zeros((2, 4)), logits=jnp.zeros((2, 4)), input=jnp.zeros((2, 4)), encoded=jenc, latents=jenc.mu)
    want = jax_make_loss(free_bits=0.1)(jout, 1.0)
    np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=1e-6)
    np.testing.assert_allclose(float(got.kl), float(want.kl), rtol=1e-6)


def test_step_seeds_are_host_derived_and_distinct():
    seeds = {derive_step_seed(e, s) for e in range(3) for s in range(100)}
    assert len(seeds) == 300 and all(0 <= s < 2**31 for s in seeds)
    assert derive_step_seed(2, 17) == derive_step_seed(2, 17)

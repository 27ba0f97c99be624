"""Gradient accumulation (``grad_accum`` = 2) in the PyTorch port's train
step against the JAX package's ``accumulate_grads``, on the CPU in f32.

Both steps start from the same weights (flax → torch through the weight
bridge) on the same batch. The Gaussian step draws once per micro-batch:
micro i of the JAX step draws under ``fold_in(step_key, i)``, and its
noise is recovered from its own forward and injected into the torch step
(``eps`` as a list, one tensor per micro). With ``fused`` the losses run
K1/K2 (plain here, Pallas interpret there) and the model K3. The VQ step
draws nothing. Tolerances are those of ``tests/test_torch_train_step.py``:
every loss field rtol 1e-5, grad norm rtol 1e-4, every updated parameter
and buffer (BatchNorm statistics, and the quantizer's codebook, cluster
sizes and sums, which chain from micro to micro) rtol 1e-4 / atol 1e-6,
with the biases of convs that feed a BatchNorm held to 2·lr.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midi_vae_tpu.losses import schedules as jax_kl_schedules
from midi_vae_tpu.models.registry import build_model as jax_build_model
from midi_vae_tpu.models.vae import param_group_label as jax_param_group_label
from midi_vae_tpu.train.optim import build_optimizer as jax_build_optimizer
from midi_vae_tpu.train.state import TrainState as JaxTrainState
from midi_vae_tpu.train.state import create_train_state as jax_create_train_state
from midi_vae_tpu.train.state import make_train_step as jax_make_train_step
from midi_vae_tpu_torch.core.rng import derive_micro_seed, derive_step_seed
from midi_vae_tpu_torch.interop.from_jax import flax_name_map, load_flax_variables, to_flax_layout
from midi_vae_tpu_torch.losses import schedules as kl_schedules
from midi_vae_tpu_torch.models.registry import build_model
from midi_vae_tpu_torch.models.vae import param_group_label
from midi_vae_tpu_torch.train import schedules
from midi_vae_tpu_torch.train.optim import build_optimizer
from midi_vae_tpu_torch.train.state import create_train_state, make_train_step
from test_torch_models import _flax_leaf, _randomize
from test_torch_vq import _jax_pair
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

MODEL_KW = dict(in_channels=1, latent_dim=4, input_dim=32, hidden_dims=(8, 16, 16), fold=4)
N_MICRO, BATCH, KL_WEIGHT, LR = 2, 8, 0.05, 1e-3
OPT_KW = dict(optimizer="AdamW", lr=LR, scheduler="OneCycle", total_steps=10000)


def _batch(rng_seed=1, b=BATCH):
    return (np.random.default_rng(rng_seed).uniform(size=(b, 32, 32, 1)) > 0.7).astype(np.float32)


def assert_state_matches(model, jstate, lr0):
    """Every parameter and buffer of ``model`` against the JAX state."""
    trees = {"params": jax.device_get(jstate.params), "batch_stats": jax.device_get(jstate.batch_stats)}
    for name, (collection, path) in flax_name_map(model).items():
        got = to_flax_layout(model, name, model.state_dict()[name])
        want = _flax_leaf(trees[collection], path)
        if name.endswith(("Conv_0.bias", "ConvTranspose_0.bias")) and "Block_" in name:
            assert np.abs(got - want).max() <= 2 * lr0, name  # cancelled by the BatchNorm that follows
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6, err_msg=name)


def assert_losses_match(lo, jlo, grad_norm, jgn):
    for field in ("loss", "reconstruction_loss", "kld_loss", "kl", "kld_weight"):
        np.testing.assert_allclose(float(getattr(lo, field)), float(getattr(jlo, field)), rtol=1e-5, err_msg=field)
    np.testing.assert_allclose(float(grad_norm), float(jgn), rtol=1e-4)


def micro_eps(model, variables, x, step_key, n, **apply_kw):
    """The noise of each micro-batch of a JAX accumulated step, recovered
    from its forward under ``fold_in(step_key, i)``: a train-mode forward
    normalises with the micro's own statistics, so the running statistics
    the earlier micros leave behind do not change mu, log_var or z."""
    m = x.shape[0] // n
    fwd = jax.jit(functools.partial(model.apply, train=True, mutable=["batch_stats"], **apply_kw))
    eps = []
    for i in range(n):
        out, _ = fwd(variables, jnp.asarray(x[i * m : (i + 1) * m]), rngs={"reparam": jax.random.fold_in(step_key, i)})
        z, mu = np.asarray(out.latents, np.float64), np.asarray(out.encoded.mu, np.float64)
        eps.append(torch.from_numpy((z - mu) / np.exp(0.5 * np.asarray(out.encoded.log_var, np.float64))))
    return eps


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_accumulated_step_matches_jax(fused):
    x, epoch_key = _batch(), jax.random.PRNGKey(5)
    jmodel = jax_build_model("FoldedVAE", fused_reparam=fused, **MODEL_KW)
    bundle = jax_build_optimizer(None, jax_param_group_label, **OPT_KW)
    jstate = jax_create_train_state(jmodel, bundle.tx, jax.random.PRNGKey(0), jnp.asarray(x[:2]))
    variables = _randomize({"params": jstate.params, "batch_stats": jstate.batch_stats}, np.random.default_rng(0))
    jstate = jstate.replace(params=variables["params"], batch_stats=variables["batch_stats"],
                            opt_state=bundle.tx.init(variables["params"]))
    eps = micro_eps(jmodel, variables, x, jax.random.fold_in(epoch_key, 0), N_MICRO)
    jstep = jax_make_train_step(jmodel, bundle.tx, jax_kl_schedules.kl_weight_schedule("constant", KL_WEIGHT),
                                fused_loss=fused, grad_accum=N_MICRO, donate=False)
    jstate, jlo, jgn = jstep(jstate, jnp.asarray(x), epoch_key)

    model = build_model("FoldedVAE", fused_reparam=fused, device="cpu", **MODEL_KW)
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    state = create_train_state(model, build_optimizer(model, param_group_label, **OPT_KW))
    step = make_train_step(kl_schedules.kl_weight_schedule("constant", KL_WEIGHT), fused_loss=fused,
                           grad_accum=N_MICRO)
    state, lo, grad_norm = step(state, torch.from_numpy(x), 5, eps=eps)

    assert state.step == 1 and float(lo.kld_weight) == pytest.approx(KL_WEIGHT)
    assert_losses_match(lo, jlo, grad_norm, jgn)
    assert_state_matches(model, jstate, schedules.onecycle_lr(LR, 10000)(0))


def test_vq_accumulated_step_matches_jax():
    """FoldedVQVAE at n = 2: the quantizer's EMA buffers chain through both
    micros on each side, and the step draws nothing."""
    jmodel, variables, _ = _jax_pair("folded")
    from test_torch_vq import MODELS

    arch, kw = MODELS["folded"]
    x, denorm = _batch(b=6), ((0.0,), (1.0,))
    bundle = jax_build_optimizer(None, jax_param_group_label, **OPT_KW)
    jstate = JaxTrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                           opt_state=bundle.tx.init(variables["params"]), step=jnp.int32(0), ema_params={})
    jstep = jax_make_train_step(jmodel, bundle.tx, jax_kl_schedules.kl_weight_schedule("constant", 0.25),
                                loss_type="vq", pos_weight=2.0, target_denorm=denorm, grad_accum=N_MICRO,
                                donate=False)
    jstate, jlo, jgn = jstep(jstate, jnp.asarray(x), jax.random.PRNGKey(5))

    model = build_model(arch, device="cpu", **kw)
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    codebook0 = model.quantizer.codebook.clone()
    step = make_train_step(kl_schedules.kl_weight_schedule("constant", 0.25), loss_type="vq", pos_weight=2.0,
                           target_denorm=denorm, grad_accum=N_MICRO)
    state, lo, grad_norm = step(create_train_state(model, build_optimizer(model, param_group_label, **OPT_KW)),
                                torch.from_numpy(x), 5)

    assert state.step == 1 and not torch.equal(model.quantizer.codebook, codebook0)
    assert_losses_match(lo, jlo, grad_norm, jgn)
    assert_state_matches(model, jstate, schedules.onecycle_lr(LR, 10000)(0))


def test_indivisible_batch_raises_with_the_jax_message():
    model = build_model("FoldedVAE", device="cpu", **MODEL_KW)
    state = create_train_state(model, build_optimizer(model, param_group_label, **OPT_KW))
    step = make_train_step(kl_schedules.kl_weight_schedule("constant", KL_WEIGHT), grad_accum=3)
    with pytest.raises(ValueError, match="batch size 8 not divisible by grad_accum=3"):
        step(state, torch.from_numpy(_batch()), 0)


def test_micro_seeds_are_distinct_and_drive_each_fused_draw(monkeypatch):
    """Each micro of an accumulated fused step launches K3 with its own seed,
    derived from (step seed, micro); seeds stay in [0, 2**31)."""
    seeds = {derive_micro_seed(derive_step_seed(e, s), i) for e in range(3) for s in range(50) for i in range(4)}
    assert len(seeds) == 600 and all(0 <= s < 2**31 for s in seeds)

    import midi_vae_tpu_torch.models.vae as vae_mod

    seen = []
    real = vae_mod.fused_reparam_kl
    monkeypatch.setattr(vae_mod, "fused_reparam_kl",
                        lambda mu, lv, seed, *offset: seen.append(seed) or real(mu, lv, seed, *offset))
    model = build_model("FoldedVAE", fused_reparam=True, device="cpu", **MODEL_KW)
    state = create_train_state(model, build_optimizer(model, param_group_label, **OPT_KW))
    step = make_train_step(kl_schedules.kl_weight_schedule("constant", KL_WEIGHT), fused_loss=True, grad_accum=4)
    step(state, torch.from_numpy(_batch()), 7)
    step_seed = derive_step_seed(7, 0)
    assert seen == [derive_micro_seed(step_seed, i) for i in range(4)]


def test_accumulated_loss_is_the_mean_of_the_micro_losses():
    """With the same weights and noise, the n = 2 step reports the mean of
    the two micro-batches' losses taken one at a time."""
    x = torch.from_numpy(_batch())
    eps = [torch.from_numpy(np.random.default_rng(i).normal(size=(4, 4)).astype(np.float32)) for i in range(2)]
    sched = kl_schedules.kl_weight_schedule("constant", KL_WEIGHT)
    losses = []
    for xs, e, n in ((x, eps, 2), (x[:4], eps[0], 1), (x[4:], eps[1], 1)):
        model = build_model("FoldedVAE", device="cpu", seed=3, **MODEL_KW)
        state = create_train_state(model, build_optimizer(model, param_group_label, **OPT_KW))
        _, lo, _ = make_train_step(sched, grad_accum=n)(state, xs, 0, eps=e)
        losses.append(float(lo.loss))
    np.testing.assert_allclose(losses[0], (losses[1] + losses[2]) / 2, rtol=1e-6)

"""The explicit per-shard step of the PyTorch port (``parallel/spmd.py``)
on two gloo ranks against the JAX package's ``make_spmd_train_step`` on
``make_mesh(2)`` over the conftest's virtual CPU devices.

One process group of two ranks serves the module (``parallel.launch.spawn``
of ``torch_rank_cases.run_cases``); the JAX side runs in the test
process. Both start from the same weights (the port's initial weights in
flax's layout) and take the same batches. The noise, decorrelated per
shard by design in both packages with different generators, is
neutralised by JAX's recipe (``tests/test_spmd.py:1-12``), ``fc_var``
pinned (kernel 0), ``log_var_clamp=(−60, −60)`` and SGD, with the bias at
−61 rather than −60: below the clamp no gradient passes it in either
package, while at the bound itself ``jnp.clip`` passes a quarter of it
and ``torch.clamp`` all of it. Tolerances, as the port's other step tests against JAX: every
loss field rtol 1e-5, grad norm rtol 1e-4, every parameter and buffer
rtol 1e-4 / atol 1e-6 after 3 steps, and the two ranks' states bitwise
equal. Cases: MLPVAE, a conv model under ``--norm group``, a conditional
MLPVAE, a FoldedVQVAE (cross-rank BatchNorm and codebook sums, as JAX's
``bn_axis_name``), and β-TC's gathered estimator at the loss level with
fixed latents (JAX ``tests/test_spmd.py`` holds it the same way: the
pinned noise makes the full TC step degenerate). Per-rank noise differs
(JAX ``tests/test_spmd.py:110-140``), and an indivisible local batch
raises JAX's error.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midi_vae_tpu.core.types import EncoderOutput as JaxEncoderOutput
from midi_vae_tpu.core.types import ModelOutput as JaxModelOutput
from midi_vae_tpu.losses import schedules as jax_schedules
from midi_vae_tpu.losses.tcvae import beta_tc_elbo_loss as jax_beta_tc
from midi_vae_tpu.models.registry import build_model as jax_build_model
from midi_vae_tpu.models.vae import param_group_label as jax_param_group_label
from midi_vae_tpu.parallel.mesh import batch_sharding, make_mesh
from midi_vae_tpu.parallel.spmd import make_spmd_train_step as jax_make_spmd_train_step
from midi_vae_tpu.train.optim import build_optimizer as jax_build_optimizer
from midi_vae_tpu.train.state import TrainState as JaxTrainState
from midi_vae_tpu_torch.interop.from_jax import flax_name_map, to_flax_layout
from midi_vae_tpu_torch.parallel.launch import spawn
from test_torch_models import _flax_leaf
from torch_rank_cases import SGD, build_spec_model, make_data, run_cases
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

WORLD, BATCH, STEPS = 2, 16, 3
CLAMP = (-60.0, -60.0)
MLP = dict(in_channels=1, latent_dim=4, input_dim=16, hidden_dims=(32,))
SPECS = {
    "mlp": dict(arch="MLPVAE", model=MLP, kl=2.5e-4),
    "conv_groupnorm": dict(arch="FoldedVAE", kl=2.5e-4, model=dict(
        in_channels=1, latent_dim=4, input_dim=16, hidden_dims=(8, 16), fold=2, norm="group")),
    "conditional": dict(arch="MLPVAE", model={**MLP, "num_classes": 4}, kl=2.5e-4),
    "vq_cross_rank_bn": dict(arch="FoldedVQVAE", kl=0.25, model=dict(
        in_channels=1, latent_dim=4, input_dim=16, hidden_dims=(8, 16), fold=2, codebook_size=16)),
}


def _pinned_spec(name):
    """The case's spec with the port's initial weights (fc_var pinned for
    the Gaussian models) and its step options."""
    spec = dict(SPECS[name], batch=BATCH, steps=STEPS)
    model = build_spec_model(spec)
    if hasattr(model, "fc_var"):
        with torch.no_grad():
            model.fc_var.weight.zero_()
            model.fc_var.bias.fill_(-61.0)
        spec["step"] = dict(log_var_clamp=CLAMP)
    else:
        spec["step"] = dict(loss_type="vq")
    spec["state_dict"] = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    return spec, model


def _flax_variables(model):
    variables = {"params": {}, "batch_stats": {}}
    for name, (collection, path) in flax_name_map(model).items():
        node = variables[collection]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = jnp.asarray(to_flax_layout(model, name, model.state_dict()[name]))
    return variables


def _jax_run(name):
    """The JAX package's explicit step on make_mesh(2): loss fields, grad
    norms and the final variables."""
    spec, model = _pinned_spec(name)
    vq = spec["step"].get("loss_type") == "vq"
    mesh = make_mesh(WORLD)
    jmodel = jax_build_model(spec["arch"], bn_axis_name=("data",) if vq else None, **spec["model"])
    variables = _flax_variables(model)
    bundle = jax_build_optimizer(None, jax_param_group_label, **SGD)
    state = JaxTrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                          opt_state=bundle.tx.init(variables["params"]), step=jnp.int32(0), ema_params={})
    kw = dict(loss_type="vq") if vq else dict(log_var_clamp=CLAMP)
    step = jax_make_spmd_train_step(jmodel, bundle.tx, jax_schedules.kl_weight_schedule("constant", spec["kl"]),
                                    mesh, donate=False, **kw)
    x, y = make_data(spec, STEPS)
    fields, norms = [], []
    for i in range(STEPS):
        xs = jax.device_put(x[i], batch_sharding(mesh))
        if spec["model"].get("num_classes", 0):
            state, lo, gn = step(state, xs, jax.device_put(y[i].astype(np.int32), batch_sharding(mesh)),
                                 jax.random.PRNGKey(7))
        else:
            state, lo, gn = step(state, xs, jax.random.PRNGKey(7))
        fields.append([float(getattr(lo, f)) for f in ("loss", "reconstruction_loss", "kld_loss", "kl", "kld_weight")])
        norms.append(float(gn))
    return model, fields, norms, {"params": jax.device_get(state.params), "batch_stats": jax.device_get(state.batch_stats)}


TC = dict(tc_beta=6.0, dataset_size=100, kld_weight=1e-3)


def _tc_inputs():
    rng = np.random.default_rng(5)
    return {
        "z": rng.normal(size=(BATCH, 4)).astype(np.float32),
        "mu": rng.normal(size=(BATCH, 4)).astype(np.float32),
        "lv": (rng.normal(size=(BATCH, 4)) * 0.1).astype(np.float32),
        "logits": rng.normal(size=(BATCH, 8, 8, 1)).astype(np.float32),
        "targets": rng.uniform(0.0, 1.0, size=(BATCH, 8, 8, 1)).astype(np.float32),
        "kw": TC,
    }


@pytest.fixture(scope="module")
def ranks():
    specs = {name: _pinned_spec(name)[0] for name in SPECS}
    indivisible = dict(arch="MLPVAE", model=MLP, batch=4, step=dict(grad_accum=3))
    payload = {"spmd_steps": specs, "beta_tc_gather": _tc_inputs(), "shard_noise": dict(
        arch="MLPVAE", model=MLP, batch=2, rows=2), "spmd_indivisible": indivisible}
    return spawn(run_cases, WORLD, "cpu", list(payload), payload, timeout_s=300)


def result(ranks, name):
    status, value = ranks[name]
    if status != "ok":
        pytest.fail(f"rank case {name} failed:\n{value}")
    return value


@pytest.mark.parametrize("name", list(SPECS))
def test_explicit_step_matches_jax_make_spmd_train_step(ranks, name, eight_devices):
    per_rank = result(ranks, "spmd_steps")[name]
    model, fields, norms, trees = _jax_run(name)
    got = per_rank[0]
    np.testing.assert_allclose(got["fields"], fields, rtol=1e-5)
    np.testing.assert_allclose(got["grad_norms"], norms, rtol=1e-4)
    for tname, t in got["state"].items():
        np.testing.assert_array_equal(per_rank[1]["state"][tname], t, err_msg=f"ranks differ: {tname}")
    for tname, (collection, path) in flax_name_map(model).items():
        want = _flax_leaf(trees[collection], path)
        np.testing.assert_allclose(to_flax_layout(model, tname, got["state"][tname]), want, rtol=1e-4, atol=1e-6,
                                   err_msg=tname)


def test_beta_tc_gathers_the_global_batch_as_jax_does(ranks, eight_devices):
    """Each rank's β-TC loss over its rows with the latents gathered: the
    mean over ranks is JAX's full-batch loss, and rank r's gradients of its
    own (z, mu, log_var), divided by the ranks, are rows r of JAX's."""
    per_rank = result(ranks, "beta_tc_gather")
    inp = _tc_inputs()

    def full(z, mu, lv):
        out = JaxModelOutput(output=jax.nn.sigmoid(inp["logits"]), logits=jnp.asarray(inp["logits"]),
                             input=jnp.asarray(inp["targets"]),
                             encoded=JaxEncoderOutput(mu=mu, log_var=lv, pre_latents=mu), latents=z)
        return jax_beta_tc(out, **TC).loss

    loss, grads = jax.value_and_grad(full, argnums=(0, 1, 2))(*(jnp.asarray(inp[k]) for k in ("z", "mu", "lv")))
    np.testing.assert_allclose(np.mean([r[0] for r in per_rank]), float(loss), rtol=1e-5)
    b = BATCH // WORLD
    for r, (_, *g) in enumerate(per_rank):
        for got, want in zip(g, grads):
            np.testing.assert_allclose(got.numpy() / WORLD, np.asarray(want)[r * b:(r + 1) * b], rtol=1e-4, atol=1e-7)


def test_each_rank_draws_its_own_noise(ranks):
    """Same rows on both ranks: the explicit step's seeds differ by rank (the
    origin keeps the step seed), and so do the latents."""
    (s0, step_seed, z0), (s1, _, z1) = result(ranks, "shard_noise")
    assert s0 == step_seed and s1 != s0
    assert not torch.allclose(z0, z1)


def test_indivisible_local_batch_raises_the_jax_error(ranks):
    assert result(ranks, "spmd_indivisible") == "per-shard batch size 2 not divisible by grad_accum=3"

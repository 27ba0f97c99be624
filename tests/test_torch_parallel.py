"""Data parallelism of the PyTorch port on two gloo ranks on the CPU.

One process group of two ranks serves the whole module (a module fixture:
``parallel.launch.spawn`` runs ``torch_rank_cases.run_cases`` once, with a
``file://`` store, one thread a rank). Against the one-rank meaning,
computed here in the test process:

- the auto step on 2 ranks equals the one-rank step at twice the batch
  (as JAX ``tests/test_parallel.py:33-52`` holds its 8-way mesh to one
  device): every loss field and the grad norm within 2e-5 relative, every
  parameter and buffer within rtol 1e-4 / atol 1e-6 after 3 SGD steps, on
  a BatchNorm FoldedVAE, with ``grad_accum=2``, under ``batch-sub2``,
  fused (the kernels' plain versions, K3 at its counter offset), with a
  free-bits floor that the two ranks' halves of the batch straddle, and on
  a FoldedVQVAE (cross-rank BatchNorm and codebook sums);
- the auto step on 2 ranks against the JAX package's step on
  ``make_mesh(2)`` over the conftest's virtual CPU devices, from the same
  weights, with each step's noise recovered from the JAX forward under
  the step's key and injected (each rank its rows), on the BatchNorm
  FoldedVAE and with the free-bits floor, at the same tolerances;
- the collectives, values and gradients (exact up to f32 summation order,
  1e-6);
- the tensor-parallel heads on a (1, 2) data × model mesh against the
  single-device step (loss 1e-5, grad norm 1e-4, updated dense weights
  rtol 1e-4 / atol 1e-6, JAX ``tests/test_parallel.py:140-194``).

The mesh-shape errors, K3's counter offset, the row draws and the rank
loaders need no group and run in the test process.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midi_vae_tpu.losses import schedules as jax_schedules
from midi_vae_tpu.models.registry import build_model as jax_build_model
from midi_vae_tpu.models.vae import param_group_label as jax_param_group_label
from midi_vae_tpu.parallel.mesh import batch_sharding
from midi_vae_tpu.parallel.mesh import make_mesh as jax_make_mesh
from midi_vae_tpu.train.optim import build_optimizer as jax_build_optimizer
from midi_vae_tpu.train.state import TrainState as JaxTrainState
from midi_vae_tpu.train.state import make_train_step as jax_make_train_step
from midi_vae_tpu_torch.data.pipeline import DeviceLoader, DeviceResidentLoader
from midi_vae_tpu_torch.data.sources import ArrayDataset
from midi_vae_tpu_torch.data.transforms import get_transform
from midi_vae_tpu_torch.interop.from_jax import flax_name_map, to_flax_layout
from midi_vae_tpu_torch.models.registry import build_model
from midi_vae_tpu_torch.ops import fused_elbo as ops
from midi_vae_tpu_torch.parallel.launch import spawn
from midi_vae_tpu_torch.parallel.mesh import Mesh, make_mesh, make_mesh_2d, make_mesh_multislice
from midi_vae_tpu_torch.parallel.spmd import make_spmd_train_step
from midi_vae_tpu_torch.train.config import TrainConfig
from midi_vae_tpu_torch.train.loop import requested_devices
from test_torch_models import _flax_leaf
from test_torch_spmd import _flax_variables
from torch_rank_cases import SGD, build_spec_model, make_data, run_cases, train_steps
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

WORLD = 2
FOLDED = dict(in_channels=1, latent_dim=4, input_dim=32, hidden_dims=(8, 16, 16), fold=4)
VQ = dict(in_channels=1, latent_dim=4, input_dim=32, hidden_dims=(8, 16), fold=2, codebook_size=16)
# three of the four latent dimensions have their first step's batch-mean KL
# above this floor on one rank's half of the batch and below it on the other's
FREE_BITS = 0.6
AUTO_SPECS = {
    "batchnorm": dict(arch="FoldedVAE", model=FOLDED, batch=8),
    "grad_accum2": dict(arch="FoldedVAE", model=FOLDED, batch=8, step=dict(grad_accum=2)),
    "batch_sub2": dict(arch="FoldedVAE", model={**FOLDED, "norm": "batch-sub2"}, batch=8),
    "fused": dict(arch="FoldedVAE", model={**FOLDED, "fused_reparam": True}, batch=8, step=dict(fused_loss=True)),
    "vq": dict(arch="FoldedVQVAE", model=VQ, batch=8, step=dict(loss_type="vq"), kl=0.25),
    "free_bits": dict(arch="FoldedVAE", model=FOLDED, batch=8, step=dict(free_bits=FREE_BITS)),
}
JAX_SPECS = ("batchnorm", "free_bits")
TP_SPEC = dict(arch="VanillaVAE", model=dict(in_channels=1, latent_dim=8, input_dim=32, hidden_dims=(8, 16)),
               batch=8, opt=dict(optimizer="AdamW", lr=1e-3, scheduler="constant", total_steps=10), kl=2.5e-4)


def _jax_auto_run(spec: dict):
    """The JAX package's step, jit-partitioned over ``make_mesh(2)``, from
    the port's initial weights of ``spec``: the spec with those weights and
    each step's noise (recovered from the JAX forward under the step's
    key), the port model, and the JAX loss fields, grad norms and final
    variables."""
    model = build_spec_model(spec)
    n = spec.get("steps", 3)
    mesh = jax_make_mesh(WORLD)
    jmodel = jax_build_model(spec["arch"], **spec["model"])
    variables = _flax_variables(model)
    bundle = jax_build_optimizer(None, jax_param_group_label, **SGD)
    state = JaxTrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                          opt_state=bundle.tx.init(variables["params"]), step=jnp.int32(0), ema_params={})
    step = jax_make_train_step(jmodel, bundle.tx, jax_schedules.kl_weight_schedule("constant", spec.get("kl", 0.05)),
                               donate=False, **spec.get("step", {}))
    forward = jax.jit(functools.partial(jmodel.apply, train=True, mutable=["batch_stats"]))
    key = jax.random.PRNGKey(7)
    x, _ = make_data(spec, n)
    eps, fields, norms = [], [], []
    for i in range(n):
        out, _ = forward({"params": state.params, "batch_stats": state.batch_stats}, jnp.asarray(x[i]),
                         rngs={"reparam": jax.random.fold_in(key, state.step)})
        lv = np.asarray(out.encoded.log_var, np.float64)
        eps.append((np.asarray(out.latents, np.float64) - np.asarray(out.encoded.mu)) / np.exp(0.5 * lv))
        state, lo, gn = step(state, jax.device_put(x[i], batch_sharding(mesh)), key)
        fields.append([float(getattr(lo, f)) for f in ("loss", "reconstruction_loss", "kld_loss", "kl", "kld_weight")])
        norms.append(float(gn))
    spec = dict(spec, state_dict={k: v.numpy().copy() for k, v in model.state_dict().items()},
                eps=np.stack(eps).astype(np.float32))
    trees = {"params": jax.device_get(state.params), "batch_stats": jax.device_get(state.batch_stats)}
    return spec, model, fields, norms, trees


@pytest.fixture(scope="module")
def jax_auto(eight_devices):
    return {name: _jax_auto_run(AUTO_SPECS[name]) for name in JAX_SPECS}


@pytest.fixture(scope="module")
def ranks(jax_auto):
    auto = {**AUTO_SPECS, **{f"jax_{name}": run[0] for name, run in jax_auto.items()}}
    payload = {"auto_steps": auto, "collectives_grads": None, "tp_step": TP_SPEC}
    return spawn(run_cases, WORLD, "cpu", list(payload), payload, timeout_s=300)


def result(ranks, name):
    status, value = ranks[name]
    if status != "ok":
        pytest.fail(f"rank case {name} failed:\n{value}")
    return value


def assert_same_training(got, want, rtol=2e-5):
    np.testing.assert_allclose(got["fields"], want["fields"], rtol=rtol)
    np.testing.assert_allclose(got["grad_norms"], want["grad_norms"], rtol=rtol)
    for name, t in want["state"].items():
        np.testing.assert_allclose(got["state"][name].numpy(), t.numpy(), rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("name", list(AUTO_SPECS))
def test_auto_step_on_two_ranks_is_one_rank_at_twice_the_batch(ranks, name):
    got = result(ranks, "auto_steps")[name]
    want = train_steps(AUTO_SPECS[name])
    assert_same_training(got, want)
    if name == "vq":  # the codebook moved, the same on both
        assert not torch.equal(want["state"]["quantizer.codebook"], build_model(
            "FoldedVQVAE", device="cpu", seed=3, **VQ).state_dict()["quantizer.codebook"])
    if name == "free_bits":  # the floor splits the ranks' halves: the mean of clamps is not the clamp of the mean
        spec = AUTO_SPECS[name]
        out = build_spec_model(spec)(torch.from_numpy(make_data(spec, 1)[0][0]), train=True, seed=0)
        mu, lv = out.encoded.mu.detach(), out.encoded.log_var.detach()
        halves = (-0.5 * (1 + lv - mu**2 - lv.exp())).reshape(WORLD, -1, mu.shape[1]).mean(1)
        assert int(((halves > FREE_BITS).any(0) & (halves < FREE_BITS).any(0)).sum()) == 3, halves


@pytest.mark.parametrize("name", JAX_SPECS)
def test_auto_step_on_two_ranks_matches_jax_on_a_two_device_mesh(ranks, jax_auto, name):
    got = result(ranks, "auto_steps")[f"jax_{name}"]
    _, model, fields, norms, trees = jax_auto[name]
    np.testing.assert_allclose(got["fields"], fields, rtol=2e-5)
    np.testing.assert_allclose(got["grad_norms"], norms, rtol=2e-5)
    for tname, (collection, path) in flax_name_map(model).items():
        want = _flax_leaf(trees[collection], path)
        np.testing.assert_allclose(to_flax_layout(model, tname, got["state"][tname]), want, rtol=1e-4, atol=1e-6,
                                   err_msg=tname)


def test_collectives_match_their_one_rank_meaning(ranks):
    per_rank = result(ranks, "collectives_grads")
    xs, ws, gw, _, _ = per_rank[0]["inputs"]
    n = WORLD
    for r, out in enumerate(per_rank):
        # all_reduce_sum: the sum on every rank; d/dx_r of Σ_s <sum, w_s> = Σ_s w_s
        np.testing.assert_allclose(out["sum"], xs.sum(0), rtol=1e-6)
        np.testing.assert_allclose(out["sum_grad"], ws.sum(0), rtol=1e-6)
        # concat_all_gather: rank order; d/dx_r of Σ_s <gathered, gw_s> = rows r of Σ_s gw_s
        np.testing.assert_array_equal(out["gather"], xs.reshape(n * 3, 4))
        np.testing.assert_allclose(out["gather_grad"], gw.sum(0)[r * 3:(r + 1) * 3], rtol=1e-6)
        np.testing.assert_allclose(out["mean"], xs.mean(0), rtol=1e-6)
        vals, masks = out["ragged"]
        np.testing.assert_array_equal(vals, xs.reshape(n * 3, 4))
        np.testing.assert_array_equal(masks, [1, 0, 0, 1, 1, 1])


def test_cross_rank_batchnorm_is_batchnorm_of_the_whole_batch(ranks):
    from midi_vae_tpu_torch.models.vae import BatchNorm

    per_rank = result(ranks, "collectives_grads")
    _, _, _, bx, bw = per_rank[0]["inputs"]
    bn = BatchNorm(4)
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, 4))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, 4))
    x = bx.reshape(-1, 4, 3, 3).clone().requires_grad_(True)
    y = bn(x, train=True)
    (y * bw.reshape(-1, 4, 3, 3)).sum().backward()
    for r, out in enumerate(per_rank):
        yb, gb, rm, rv = out["bn"]
        np.testing.assert_allclose(yb, y.detach()[r * 2:(r + 1) * 2], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(gb, x.grad[r * 2:(r + 1) * 2], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(rm, bn.running_mean, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(rv, bn.running_var, rtol=1e-5, atol=1e-7)


def test_tensor_parallel_heads_match_the_single_device_step(ranks):
    from midi_vae_tpu_torch.parallel.mesh import MODEL_AXIS

    got = result(ranks, "tp_step")
    spec = {**TP_SPEC, "steps": 1, "step": {}, "epoch_seed": 1}
    want = train_steps(spec)
    np.testing.assert_allclose(got["loss"], want["fields"][0][0], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norms"][0], rtol=1e-4)
    w0, w1 = got["weights"]
    for name, dim in (("fc_mu.weight", 0), ("fc_mu.bias", 0), ("fc_var.weight", 0), ("decoder_input.weight", 1)):
        whole = torch.cat([w0[name], w1[name]], dim=dim)
        np.testing.assert_allclose(whole, want["state"][name], rtol=1e-4, atol=1e-6, err_msg=name)
    for name in ("decoder_input.bias", "encoder.ConvBlock_0.Conv_0.weight"):
        np.testing.assert_allclose(w0[name], want["state"][name], rtol=1e-4, atol=1e-6, err_msg=name)
        np.testing.assert_array_equal(w0[name], w1[name])
    specs = got["specs"]
    assert specs["fc_mu.weight"] == (MODEL_AXIS, None) and specs["decoder_input.weight"] == (None, MODEL_AXIS)
    assert specs["encoder.ConvBlock_0.Conv_0.weight"] == () and specs["decoder_input.bias"] == ()


# ------------------------------------------------------------- no group needed


@pytest.mark.parametrize("build,match", [
    (lambda: make_mesh(2), "requested 2 devices, only 1 available"),
    (lambda: make_mesh_multislice(2), "1 devices do not divide into 2 slices"),
    (lambda: make_mesh_multislice(2, 2), "mesh 2x2 needs 4 devices, have 1"),
    (lambda: make_mesh_2d(2, 2), "mesh 2x2 needs 4 devices, have 1"),
    (lambda: make_spmd_train_step(lambda step: 0.0, make_mesh_2d(1, 1)), "1-D"),
], ids=["flat", "slices", "slice_grid", "data_model", "spmd_on_model_mesh"])
def test_mesh_shape_errors_are_the_jax_packages(build, match):
    with pytest.raises(ValueError, match=match):
        build()


def test_default_device_count_is_every_visible_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert requested_devices(TrainConfig(), torch.device("cuda")) == 3
    assert requested_devices(TrainConfig(), torch.device("cpu")) == 1
    assert requested_devices(TrainConfig(num_devices=2), torch.device("cuda")) == 2
    with pytest.raises(ValueError, match="must be >= 1"):
        requested_devices(TrainConfig(num_devices=0), torch.device("cpu"))


def test_mesh_rows_cover_the_global_batch_and_each_micro_batch():
    meshes = [Mesh(("slice", "data"), (2, 2), r, {}) for r in range(4)]
    assert [m.shard_index for m in meshes] == [0, 1, 2, 3]
    np.testing.assert_array_equal(np.concatenate([m.local_rows(8) for m in meshes]), np.arange(8))
    # micro 2 of 16 rows over 4 shards: rank r holds rows 2r, 2r+1 of each half
    rows = [m.local_rows(16, 2) for m in meshes]
    np.testing.assert_array_equal(rows[1], [2, 3, 10, 11])
    np.testing.assert_array_equal(np.sort(np.concatenate(rows)), np.arange(16))
    with pytest.raises(ValueError, match="must divide evenly across 4 processes"):
        meshes[0].local_rows(6)
    with pytest.raises(ValueError, match="not divisible by grad_accum=3"):
        meshes[0].local_rows(8, 3)


def test_k3_counter_offset_draws_the_rows_of_the_whole_draw():
    whole = ops.k3_eps_plain((6, 5), 99)
    halves = [ops.k3_eps_plain((3, 5), 99, offset=o) for o in (0, 15)]
    np.testing.assert_array_equal(torch.cat(halves), whole)
    mu, lv = torch.randn(6, 5), 0.3 * torch.randn(6, 5)
    z, _ = ops.reparam_kl(mu, lv, 99)
    z1, _ = ops.reparam_kl(mu[3:], lv[3:], 99, 15)
    np.testing.assert_array_equal(z1, z[3:])
    with pytest.raises(ValueError, match="32-bit counter"):
        ops.reparam_kl(mu, lv, 99, 2**32 - 29)


@pytest.mark.parametrize("fused", [False, True], ids=["generator", "k3"])
def test_row_draw_is_the_slice_of_the_global_draw(fused):
    model = build_model("FoldedVAE", device="cpu", fused_reparam=fused, **FOLDED)
    mu, lv = torch.randn(8, 4), 0.3 * torch.randn(8, 4)
    whole = model.reparameterize(mu, lv, seed=17)
    part = model.reparameterize(mu[4:], lv[4:], seed=17, rows=(4, 8))
    np.testing.assert_array_equal(part, whole[4:])


@pytest.mark.parametrize("loader_cls", [DeviceLoader, DeviceResidentLoader], ids=["host", "resident"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_rank_loaders_rebuild_the_one_rank_batches(loader_cls, train):
    """Two ranks' batches (random pianoroll transforms on the train side)
    put together are the one-rank loader's, padding and masks included."""
    rng = np.random.default_rng(0)
    images = (rng.uniform(size=(21, 32, 32, 1)) > 0.8).astype(np.uint8) * 255
    spec_train, spec_eval = get_transform("pianoroll", 32, {})
    ds = ArrayDataset(images, np.arange(21) % 3, transform=spec_train if train else spec_eval)
    one = list(loader_cls(ds, 8, train=train, seed=4, device="cpu").epoch(2))
    parts = [list(loader_cls(ds, 8, train=train, seed=4, device="cpu",
                             rows=Mesh(("data",), (2,), r, {}).local_rows(8)).epoch(2)) for r in range(2)]
    assert len(one) == len(parts[0]) == len(parts[1]) == (2 if train else 3)
    for i, b in enumerate(one):
        for field in ("x", "y", "mask"):
            np.testing.assert_array_equal(torch.cat([getattr(p[i], field) for p in parts]), getattr(b, field))

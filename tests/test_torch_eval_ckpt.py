"""The loss options, the eval step, the EMA update and the checkpoint I/O of
the PyTorch port, against the JAX package on the CPU where it has a
counterpart.

Tolerances: ``elbo_loss`` with ``target_denorm``/``free_bits`` 1e-6
relative (values) and 1e-5 (gradients) at f32; the eval step's metric
sums 1e-5 relative on the same weights, batch and noise (the JAX step's
own draw, recovered from its forward and injected); the EMA update 1e-6;
checkpoints bitwise.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midi_vae_tpu.core.types import EncoderOutput as JaxEncoderOutput
from midi_vae_tpu.core.types import ModelOutput as JaxModelOutput
from midi_vae_tpu.evaluation.evaluate import make_eval_step as jax_make_eval_step
from midi_vae_tpu.io.checkpoint import restore_config as jax_restore_config
from midi_vae_tpu.losses.elbo import elbo_loss as jax_elbo_loss
from midi_vae_tpu.models.registry import build_model as jax_build_model
from midi_vae_tpu.train.state import ema_update as jax_ema_update
from midi_vae_tpu_torch.core.types import EncoderOutput, ModelOutput
from midi_vae_tpu_torch.evaluation.evaluate import evaluate, make_eval_step
from midi_vae_tpu_torch.interop.from_jax import load_flax_variables
from midi_vae_tpu_torch.io import checkpoint as ckpt
from midi_vae_tpu_torch.io.logging import MetricLogger, PhaseTimer, generate_id
from midi_vae_tpu_torch.losses.elbo import elbo_loss
from midi_vae_tpu_torch.losses.schedules import constant
from midi_vae_tpu_torch.models.registry import build_model
from midi_vae_tpu_torch.models.vae import param_group_label
from midi_vae_tpu_torch.train.optim import build_optimizer
from midi_vae_tpu_torch.train.state import (
    create_train_state,
    ema_update,
    load_state_dict,
    make_train_step,
    reconcile_ema_state_dict,
    state_dict,
)
from test_torch_models import _randomize
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

MODEL_KW = dict(in_channels=1, latent_dim=4, input_dim=32, hidden_dims=(8, 16, 16), fold=4)
DENORM = ((0.5,), (1.0,))


def _loss_arrays(seed=7):
    rng = np.random.default_rng(seed)
    arrays = dict(
        logits=rng.normal(size=(4, 8, 8, 1)) * 3, x=rng.uniform(-0.5, 0.5, (4, 8, 8, 1)),
        mu=rng.normal(size=(4, 5)) * 0.3, lv=rng.normal(size=(4, 5)) * 0.3,
    )
    return {k: v.astype(np.float32) for k, v in arrays.items()}


@pytest.mark.parametrize(
    "kw",
    [dict(target_denorm=DENORM), dict(free_bits=0.2), dict(free_bits=0.05, target_denorm=DENORM, pos_weight=3.0)],
    ids=["raw_targets", "free_bits", "both_and_pos_weight"],
)
def test_elbo_options_match_jax(kw):
    a = _loss_arrays()

    def jax_loss(logits, mu, lv):
        enc = JaxEncoderOutput(mu=mu, log_var=lv, pre_latents=mu)
        out = JaxModelOutput(output=logits, logits=logits, input=jnp.asarray(a["x"]), encoded=enc, latents=mu)
        return jax_elbo_loss(out, kld_weight=0.7, **kw)

    want = jax_loss(*(jnp.asarray(a[k]) for k in ("logits", "mu", "lv")))
    jgrads = jax.grad(lambda *args: jax_loss(*args).loss, argnums=(0, 1, 2))(*(jnp.asarray(a[k]) for k in ("logits", "mu", "lv")))

    t = {k: torch.from_numpy(v).requires_grad_(k != "x") for k, v in a.items()}
    enc = EncoderOutput(mu=t["mu"], log_var=t["lv"], pre_latents=t["mu"])
    got = elbo_loss(ModelOutput(output=t["logits"], logits=t["logits"], input=t["x"], encoded=enc, latents=t["mu"]),
                    kld_weight=0.7, **kw)
    for field in ("loss", "reconstruction_loss", "kld_loss", "kl", "kld_weight"):
        np.testing.assert_allclose(float(getattr(got, field)), float(getattr(want, field)), rtol=1e-6, err_msg=field)
    got.loss.backward()
    for k, g in zip(("logits", "mu", "lv"), jgrads):
        np.testing.assert_allclose(t[k].grad.numpy(), np.asarray(g), rtol=1e-5, atol=1e-8, err_msg=k)


def test_free_bits_floor_stops_the_gradient_of_quiet_dimensions():
    mu = torch.zeros(3, 2, requires_grad=True)
    lv = torch.zeros(3, 2, requires_grad=True)
    enc = EncoderOutput(mu=mu, log_var=lv, pre_latents=mu)
    x = torch.zeros(3, 2)
    lo = elbo_loss(ModelOutput(output=x, logits=x, input=x, encoded=enc, latents=mu), kld_weight=1.0, free_bits=0.5)
    lo.loss.backward()
    assert float(lo.kl) == 0.0 and torch.all(mu.grad == 0) and torch.all(lv.grad == 0)


def _jax_model_and_vars(seed=0):
    model = jax_build_model("FoldedVAE", **MODEL_KW)
    variables = model.init({"params": jax.random.PRNGKey(seed), "reparam": jax.random.PRNGKey(1)},
                           jnp.zeros((2, 32, 32, 1)), train=True)
    return model, _randomize(variables, np.random.default_rng(seed))


@pytest.mark.parametrize("raw", [False, True], ids=["normalized", "raw_targets"])
def test_eval_step_matches_jax(raw):
    jmodel, variables = _jax_model_and_vars()
    x = ((np.random.default_rng(3).uniform(size=(6, 32, 32, 1)) > 0.6).astype(np.float32) - 0.5)
    mask = np.asarray([1, 1, 1, 1, 0, 0], np.float32)
    key = jax.random.PRNGKey(11)
    out = jax.jit(functools.partial(jmodel.apply, train=False))(variables, jnp.asarray(x), rngs={"reparam": key})
    eps = (np.asarray(out.latents, np.float64) - np.asarray(out.encoded.mu)) / np.exp(
        0.5 * np.asarray(out.encoded.log_var, np.float64)
    )
    kw = dict(target_denorm=DENORM if raw else None, occupancy_denorm=DENORM)
    want = jax.device_get(jax_make_eval_step(jmodel, **kw)(
        variables["params"], variables["batch_stats"], jnp.asarray(x), jnp.asarray(mask), key
    ))

    model = build_model("FoldedVAE", device="cpu", **MODEL_KW)
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    got = make_eval_step(model, **kw)(torch.from_numpy(x), torch.from_numpy(mask), 0, eps=torch.from_numpy(eps).float())
    assert set(got) == set(want)
    assert int(want["occ_tp"]) > 0 and int(want["occ_fp"]) > 0
    for k, v in want.items():
        np.testing.assert_allclose(got[k].double().numpy(), np.asarray(v, np.float64), rtol=1e-5, atol=1e-6, err_msg=k)


class _ListLoader:
    def __init__(self, batches):
        self.batches = batches

    def epoch(self, epoch):
        return iter(self.batches)


def test_evaluate_reduces_masked_sums_and_uses_override_params(capsys):
    from midi_vae_tpu_torch.data.pipeline import Batch

    torch.manual_seed(0)
    model = build_model("FoldedVAE", device="cpu", **MODEL_KW)
    xs = [torch.rand(4, 32, 32, 1) - 0.5 for _ in range(2)]
    masks = [torch.ones(4), torch.tensor([1.0, 1.0, 0.0, 0.0])]
    loader = _ListLoader([Batch(x=x, y=torch.zeros(4, dtype=torch.int64), mask=m) for x, m in zip(xs, masks)])
    step = make_eval_step(model, occupancy_denorm=DENORM)
    res = evaluate(loader, model, partition_name="Val", seed=3, eval_step=step)
    assert res["count"] == 6 and 0 <= res["active-units"] <= 4
    assert {"cross-entropy", "mse", "mae", "kl", "precision", "recall", "f1"} <= set(res)
    assert "Val evaluation results" in capsys.readouterr().out
    # the same sweep twice is the same (seeded draws); other weights give other metrics
    assert evaluate(loader, model, seed=3, eval_step=step, verbosity=0) == res
    shifted = {n: p.detach() + 0.05 for n, p in model.named_parameters()}
    other = evaluate(loader, model, shifted, seed=3, eval_step=step, verbosity=0)
    assert other["cross-entropy"] != res["cross-entropy"]


def test_ema_update_matches_jax():
    model = build_model("FoldedVAE", device="cpu", **MODEL_KW)
    state = create_train_state(model, build_optimizer(model, param_group_label), ema=True)
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.from_numpy(rng.normal(size=p.shape).astype(np.float32)))
    ema0 = {k: v.numpy().copy() for k, v in state.ema_params.items()}
    params = {k: p.detach().numpy().copy() for k, p in model.named_parameters()}
    want = jax.device_get(jax_ema_update(ema0, params, 0.999))
    ema_update(state.ema_params, model, 0.999)
    for k, v in want.items():
        np.testing.assert_allclose(state.ema_params[k].numpy(), np.asarray(v), rtol=1e-6, atol=1e-7, err_msg=k)


def test_train_step_tracks_ema_and_seeds_it_when_missing():
    model = build_model("FoldedVAE", device="cpu", **MODEL_KW)
    state = create_train_state(model, build_optimizer(model, param_group_label, lr=1e-2))
    step = make_train_step(constant(0.1), ema_decay=0.5)
    x = torch.rand(4, 32, 32, 1) - 0.5
    state, _, _ = step(state, x, 0)  # no averages yet: seeded from the updated parameters
    assert all(torch.equal(state.ema_params[n], p) for n, p in model.named_parameters())
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    ema_before = {k: v.clone() for k, v in state.ema_params.items()}
    state, _, _ = step(state, x, 0)
    for n, p in model.named_parameters():
        torch.testing.assert_close(state.ema_params[n], 0.5 * ema_before[n] + 0.5 * p.detach(), rtol=1e-6, atol=1e-7)
    assert any(not torch.equal(before[n], p) for n, p in model.named_parameters())


def _trained_state(ema: bool):
    torch.manual_seed(0)
    model = build_model("FoldedVAE", device="cpu", **MODEL_KW)
    state = create_train_state(model, build_optimizer(model, param_group_label, lr=1e-2, total_steps=10), ema=ema)
    step = make_train_step(constant(0.1), ema_decay=0.9 if ema else None)
    for i in range(2):
        state, _, _ = step(state, torch.rand(4, 32, 32, 1) - 0.5, i)
    return state


def _assert_tree_equal(a, b):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    else:
        assert a == b


@pytest.mark.parametrize("writer", ["sync", "async"])
def test_checkpoint_roundtrip_is_bitwise(tmp_path, writer):
    state = _trained_state(ema=True)
    path = str(tmp_path / "run" / ckpt.CHECKPOINT_LATEST)
    kw = dict(config={"seed": 3, "hidden_dims": [8, 16]}, epoch=2, total_step=17, n_samples_seen=1700,
              encoder_config={"input_size": 32}, transform_args={"normalization": "mnist"}, best_epoch=1,
              best_metric=0.25, best_metric_name="cross-entropy")
    if writer == "sync":
        ckpt.save_checkpoint(path, state_dict(state), **kw)
    else:
        w = ckpt.AsyncCheckpointWriter()
        w.save(path, state_dict(state), **kw)
        w.wait()
    assert not list((tmp_path / "run").glob(".tmp.*"))
    payload = ckpt.load_checkpoint(path)
    _assert_tree_equal(payload["state"], state_dict(state))
    for k, v in kw.items():
        assert payload[k] == v
    fresh = _trained_state(ema=True)  # other weights and moments, same structure
    fresh = load_state_dict(fresh, reconcile_ema_state_dict(payload["state"], fresh))
    _assert_tree_equal(state_dict(fresh), state_dict(state))
    best = ckpt.copy_best(path)
    assert best.endswith(ckpt.BEST_MODEL) and open(best, "rb").read() == open(path, "rb").read()


def test_reconcile_ema_across_generations():
    with_ema, without = _trained_state(ema=True), _trained_state(ema=False)
    seeded = reconcile_ema_state_dict(state_dict(without), with_ema)
    _assert_tree_equal(seeded["ema_params"], {n: p.detach() for n, p in without.model.named_parameters()})
    assert reconcile_ema_state_dict(state_dict(with_ema), without)["ema_params"] == {}


def test_async_writer_surfaces_errors(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    w = ckpt.AsyncCheckpointWriter()
    w.save(str(blocker / "sub" / "c.pt"), {"a": torch.zeros(1)})
    with pytest.raises(OSError):
        w.wait()
    w.wait()  # the error is raised once


def test_jax_checkpoints_are_refused(tmp_path):
    """A JAX package Orbax directory whose files fail their check is refused
    with the reason, and a missing checkpoint is missing; an intact one
    loads (its flax params bitwise; every case: ``test_torch_orbax_read.py``),
    as JAX ``.msgpack`` files do (``test_torch_jax_checkpoints.py``)."""
    from midi_vae_tpu.io.checkpoint import save_checkpoint as jax_save_checkpoint

    jmodel, variables = _jax_model_and_vars()
    path = str(tmp_path / "checkpoint_latest.orbax")
    jax_save_checkpoint(path, {"params": variables["params"]}, config={"arch": "FoldedVAE"}, epoch=1, backend="orbax")
    payload = ckpt.load_checkpoint(path)
    assert payload["state_format"] == ckpt.FLAX_STATE and payload["epoch"] == 1
    for got, want in zip(jax.tree_util.tree_leaves(payload["state"]["params"]),
                         jax.tree_util.tree_leaves(variables["params"])):
        assert np.asarray(want).tobytes() == got.tobytes()
    manifest = os.path.join(path, "state", "manifest.ocdbt")
    blob = bytearray(open(manifest, "rb").read())
    blob[30] ^= 0xFF
    open(manifest, "wb").write(bytes(blob))
    with pytest.raises(ValueError, match="CRC32C mismatch"):
        ckpt.load_checkpoint(path)
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(str(tmp_path / "checkpoint_latest.msgpack"))


@pytest.mark.parametrize(
    "live,stored",
    [({"a": None, "b": 2, "checkpoint_path": "x"}, {"a": 1, "b": 3, "checkpoint_path": "y", "c": 4}),
     ({"seed": None, "prefetch": 2}, {"seed": 0, "prefetch": 8, "epochs": None})],
)
def test_restore_config_matches_jax(live, stored):
    with pytest.warns(UserWarning) if live.get("b") else _no_warning():
        got = ckpt.restore_config(live, stored)
    assert got == jax_restore_config(live, stored)


class _no_warning:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_metric_logger_and_phase_timer(tmp_path):
    logger = MetricLogger(str(tmp_path / "run"))
    logger.log({"training/stepwise/train/loss": np.float32(0.5), "x": 1}, step=3)
    logger.close()
    rows = [json.loads(line) for line in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert rows == [{"step": 3, "training/stepwise/train/loss": 0.5, "x": 1}]
    timer = PhaseTimer()
    for name in ("dataloader", "device_step", "dataloader", "logging"):
        timer.mark(name)
    assert set(timer.durations()) == {"dataloader", "device_step"}
    assert len(generate_id()) == 8 and generate_id() != generate_id()


def test_wandb_must_be_importable(monkeypatch, tmp_path):
    import sys

    monkeypatch.setitem(sys.modules, "wandb", None)
    with pytest.raises(RuntimeError, match="wandb"):
        MetricLogger(str(tmp_path), use_wandb=True)

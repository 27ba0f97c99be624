"""JAX package ``.msgpack`` checkpoints in the PyTorch port, on the CPU.

- The port's decoder (``io/flax_msgpack.py``) against
  ``flax.serialization.msgpack_restore`` on checkpoints the JAX package
  writes (a Gaussian model with EMA, a VQ model, a conditional model):
  every leaf bitwise, the optimizer state included.
- The weights those checkpoints put into the port's models: the flax
  variables through the weight bridge (EMA averages preferred), bitwise.
- ``evaluate`` and ``generate --mode reconstruct`` of the JAX-trained
  fixture (``tests/fixtures/jax_folded_lines28.msgpack``, see
  ``make_jax_checkpoint.py``) against the JAX CLIs, f32, rtol 1e-5, with
  the reparameterization draw neutralised on both sides (z = mu): the
  streams of the two packages cannot match, and this compares the loaded
  weights, not the draws.
- ``--pretrained x.msgpack`` warm-starts (parameters and statistics from
  the EMA averages, optimizer and counters fresh, EMA restarted), and a
  resume from a JAX checkpoint is refused.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

import midi_vae_tpu_torch.models.vae as port_vae
from midi_vae_tpu.cli import evaluate as jax_evaluate
from midi_vae_tpu.cli import generate as jax_generate
from midi_vae_tpu.io.checkpoint import save_checkpoint as jax_save_checkpoint
from midi_vae_tpu.models.registry import build_model as jax_build_model
from midi_vae_tpu.train.config import TrainConfig as JaxTrainConfig
from midi_vae_tpu.train.state import create_train_state as jax_create_train_state
from midi_vae_tpu_torch.cli import evaluate, generate
from midi_vae_tpu_torch.cli.generate import _load_model_and_state
from midi_vae_tpu_torch.interop.from_jax import load_flax_variables
from midi_vae_tpu_torch.io import flax_msgpack
from midi_vae_tpu_torch.io.checkpoint import FLAX_STATE, load_checkpoint, model_weights
from midi_vae_tpu_torch.models.registry import build_model
from midi_vae_tpu_torch.train.config import TrainConfig
from midi_vae_tpu_torch.train.loop import run
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

_HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(_HERE, "fixtures", "jax_folded_lines28.msgpack")

# name → (arch, model options, config options)
CASES = {
    "gaussian_ema": ("FoldedVAE", dict(hidden_dims=(8, 16), fold=4), dict(ema_decay=0.9)),
    "vq": ("VQVAE", dict(hidden_dims=(8, 16), codebook_size=16), dict(codebook_size=16, loss_type="vq")),
    "conditional": ("VanillaVAE", dict(hidden_dims=(8, 16), num_classes=3), dict(conditional=True, num_classes=3)),
}


def _jax_checkpoint(tmp_path, name, backend="msgpack"):
    arch, model_kw, config_kw = CASES[name]
    model = jax_build_model(arch, in_channels=1, latent_dim=4, input_dim=32, **model_kw)
    ema = "ema_decay" in config_kw
    tx = optax.adamw(1e-3)  # the init traced once under jit: eager flax init costs seconds an architecture
    state = jax.jit(lambda key: jax_create_train_state(model, tx, key, jnp.zeros((2, 32, 32, 1)), ema=ema))(
        jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    perturb = lambda a: np.asarray(a) + rng.normal(0, 0.05, np.shape(a)).astype(np.asarray(a).dtype)  # noqa: E731
    # distinct EMA averages and running statistics, so a mix-up shows
    state = state.replace(
        ema_params=jax.tree_util.tree_map(perturb, state.ema_params) if ema else {},
        batch_stats=jax.tree_util.tree_map(lambda a: np.abs(perturb(a)), state.batch_stats),
    )
    config = JaxTrainConfig(dataset_name="vae-lines-synthetic", image_size=32, arch=arch, n_features=4,
                            hidden_dims=model_kw["hidden_dims"], fold=model_kw.get("fold", 4), **config_kw).to_dict()
    path = str(tmp_path / f"{name}.{backend}")
    jax_save_checkpoint(path, state, config=config, epoch=3, total_step=21, n_samples_seen=2688,
                        encoder_config={"input_size": 32, "n_feature": 4}, best_epoch=2, backend=backend)
    return path, state


def _assert_trees_bitwise(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_trees_bitwise(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype and got.shape == want.shape, path
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes(), path
    else:
        assert type(got) is type(want) and got == want, path


@pytest.mark.parametrize("name", list(CASES))
def test_decoder_matches_flax_bitwise(tmp_path, name):
    path, _ = _jax_checkpoint(tmp_path, name)
    blob = open(path, "rb").read()
    want = serialization.msgpack_restore(blob)
    got = flax_msgpack.msgpack_restore(blob)
    _assert_trees_bitwise(got, want)
    assert set(got["state"]) == {"params", "batch_stats", "opt_state", "step", "ema_params"}


@pytest.mark.parametrize("name", list(CASES))
def test_jax_checkpoint_weights_load_into_the_port(tmp_path, name):
    path, state = _jax_checkpoint(tmp_path, name)
    payload = load_checkpoint(path)
    assert payload["state_format"] == FLAX_STATE and payload["epoch"] == 3 and payload["config"]["arch"] == CASES[name][0]
    model, cfg, size, channels, dataset = _load_model_and_state(path, device="cpu")
    assert (size, channels, dataset) == (32, 1, "vae-lines-synthetic")
    params = jax.device_get(state.ema_params or state.params)
    want = build_model(CASES[name][0], in_channels=1, latent_dim=4, input_dim=32, device="cpu", **CASES[name][1])
    load_flax_variables(want, params, jax.device_get(state.batch_stats))
    for k, v in want.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    raw = model_weights(payload, want, use_ema=False)
    load_flax_variables(want, jax.device_get(state.params), jax.device_get(state.batch_stats))
    for k, v in want.state_dict().items():
        assert torch.equal(raw[k], v), k


@pytest.fixture()
def no_noise(monkeypatch):
    """z = mu in both packages' reparameterization (their draws cannot match)."""
    monkeypatch.setattr(jax.random, "normal", lambda key, shape=(), dtype=jnp.float32: jnp.zeros(shape, dtype))
    monkeypatch.setattr(port_vae.VanillaVAE, "reparameterize", lambda self, mu, log_var, **kw: mu)


def test_evaluate_of_the_jax_fixture_matches_the_jax_cli(tmp_path, no_noise):
    """Both partitions at ``--batch-size 8``: at the default 128 (and at 32)
    the JAX package's f32 sums of the squared errors on the CPU are
    themselves 1.0e-5 off (train mse 78.352594 against a float64 sum's
    78.353391; the port's 78.353393), so the comparison would measure
    XLA's reduction, not the loaded weights; at 8 they are 7.9e-7 off."""
    want_path, got_path = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    argv = ["--checkpoint", FIXTURE, "--cpu", "--partition", "all", "--batch-size", "8"]
    jax_evaluate.cli(argv + ["--json", want_path])
    evaluate.cli(argv + ["--json", got_path])
    want, got = json.load(open(want_path)), json.load(open(got_path))
    assert set(got) == set(want) == {"train", "test"}
    for part in want:
        assert set(got[part]) == set(want[part])
        for k, v in want[part].items():
            np.testing.assert_allclose(got[part][k], v, rtol=1e-5, atol=1e-7, err_msg=f"{part}/{k}")


def test_generate_reconstruct_of_the_jax_fixture_matches_the_jax_cli(tmp_path, no_noise, monkeypatch):
    captured = []
    real = jax_generate._to_grid
    monkeypatch.setattr(jax_generate, "_to_grid", lambda images, *a, **k: captured.append(np.asarray(images))
                        or real(images, *a, **k))
    argv = ["--checkpoint", FIXTURE, "--cpu", "--mode", "reconstruct", "-n", "6"]
    jax_generate.cli(argv + ["--out", str(tmp_path / "jax.png")])
    got = generate.cli(argv + ["--out", str(tmp_path / "port.png")])
    want = captured[0]
    assert got.shape == want.shape == (12, 28, 28, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _fixture_config(tmp_path, **kw):
    base = dict(dataset_name="vae-lines-synthetic", transform_type="noaug", image_size=28, arch="FoldedVAE", fold=4,
                n_features=4, hidden_dims=(8, 16), epochs=1, batch_size_per_device=128, seed=0, models_dir=None,
                log_images=False)
    return TrainConfig(**{**base, **kw})


def test_pretrained_msgpack_warm_starts_from_the_ema_weights(tmp_path, monkeypatch):
    import midi_vae_tpu_torch.data.fetch as fetch
    import midi_vae_tpu_torch.train.loop as loop_mod

    monkeypatch.setitem(fetch.SYNTHETIC_SIZES, "vae-lines-synthetic", 256)
    seen = {}
    real = loop_mod._warm_start

    def spy(state, path):
        real(state, path)
        seen["params"] = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
        seen["ema"] = {k: v.clone() for k, v in state.ema_params.items()}

    monkeypatch.setattr(loop_mod, "_warm_start", spy)
    r = run(_fixture_config(tmp_path, pretrained=FIXTURE, ema_decay=0.5), device="cpu")
    assert r["total_step"] == r["steps_per_epoch"] == 1 and np.isfinite(r["train"]["loss"])
    payload = load_checkpoint(FIXTURE)
    flax_state = payload["state"]
    want = build_model("FoldedVAE", in_channels=1, latent_dim=4, input_dim=28, hidden_dims=(8, 16), fold=4, device="cpu")
    load_flax_variables(want, flax_state["ema_params"], flax_state["batch_stats"])
    for k, v in want.state_dict().items():
        assert torch.equal(seen["params"][k], v), k
    for k, v in seen["ema"].items():  # EMA restarts from the warm weights
        assert torch.equal(v, seen["params"][k]), k


def test_resuming_a_jax_checkpoint_is_refused(tmp_path):
    with pytest.raises(ValueError, match="cannot resume its optimizer state.*--pretrained"):
        run(_fixture_config(tmp_path, checkpoint_path=FIXTURE), device="cpu")

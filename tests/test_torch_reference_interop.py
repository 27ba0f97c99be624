"""The reference's torch ``state_dict`` and the port's ``torch_compat``
VanillaVAE (``midi_vae_tpu_torch/interop/torch_reference.py``), on the CPU:
the import against the JAX package's ``import_reference_state_dict``
carried into the port by ``interop/from_jax.py`` (identical tensors); the
port's forward against the reference torch model
(``benchmarks/torch_cpu_baseline.py`` ``TorchRefVAE``, as
``tests/test_torch_parity.py`` uses it) in eval and train mode, within
1e-6 absolute; the export and a bitwise round trip; the export CLI, its
``.npz`` file against the JAX package's ``torch_export`` CLI on the same
JAX checkpoint (whose weights the port carries across with
``interop/from_jax.py``), key for key and bitwise, and its refusal of
``--no-ema``; the refusals.

Reference widths (32, 64, 128, 256), latent 10, batch 4; the forwards at
32 px, the only size the reference runs (its decoder reshape is fixed),
the import and the round trip also at 28 px.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from midi_vae_tpu.interop import torch_export as jax_torch_export
from midi_vae_tpu.interop.torch_import import flatten_permutation as jax_flatten_permutation
from midi_vae_tpu.interop.torch_import import import_reference_state_dict as jax_import
from midi_vae_tpu.io.checkpoint import save_checkpoint as jax_save_checkpoint
from midi_vae_tpu.models.registry import build_model as jax_build_model
from midi_vae_tpu.train.config import TrainConfig as JaxTrainConfig
from midi_vae_tpu.train.state import create_train_state as jax_create_train_state
from midi_vae_tpu_torch.interop import torch_reference
from midi_vae_tpu_torch.interop.from_jax import load_flax_variables
from midi_vae_tpu_torch.interop.torch_reference import (
    export_reference_state_dict,
    flatten_permutation,
    import_reference_state_dict,
)
from midi_vae_tpu_torch.io.checkpoint import save_checkpoint
from midi_vae_tpu_torch.models.registry import build_model
from midi_vae_tpu_torch.models.vae import param_group_label
from midi_vae_tpu_torch.train.optim import build_optimizer
from midi_vae_tpu_torch.train.state import create_train_state, state_dict

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "benchmarks"))
from torch_cpu_baseline import TorchRefVAE  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402, F401 (autouse)

HID = (32, 64, 128, 256)
ATOL = 1e-6
STEPS_TRACKED = 3


def _reference(input_dim):
    """The reference model after 3 train-mode forwards (running statistics
    and ``num_batches_tracked`` moved), in eval mode."""
    torch.manual_seed(input_dim)
    ref = TorchRefVAE(in_ch=1, latent=10, input_dim=input_dim, hidden=HID)
    with torch.no_grad():
        for i in range(STEPS_TRACKED):
            ref(torch.rand(4, 1, input_dim, input_dim), eps=torch.zeros(4, 10))
    return ref.eval()


def _port(input_dim):
    return build_model("VanillaVAE", in_channels=1, latent_dim=10, input_dim=input_dim, hidden_dims=HID,
                       torch_compat=True, device="cpu")


@pytest.fixture(scope="module", params=[32, 28], ids=["32px", "28px"])
def pair(request):
    ref = _reference(request.param)
    port = _port(request.param)
    import_reference_state_dict(port, ref.state_dict())
    return request.param, ref, port


def test_flatten_permutation_is_the_jax_packages():
    for s, c in ((2, 256), (3, 5)):
        np.testing.assert_array_equal(flatten_permutation(s, c), jax_flatten_permutation(s, c))


def test_import_equals_the_jax_import_carried_across(pair):
    """The port's import and JAX's import + ``from_jax`` give identical tensors."""
    input_dim, ref, port = pair
    via_jax = _port(input_dim)
    variables = jax_import(ref.state_dict(), input_dim=input_dim, hidden_dims=HID)
    load_flax_variables(via_jax, variables["params"], variables["batch_stats"])
    for (name, a), b in zip(port.state_dict().items(), via_jax.state_dict().values()):
        assert torch.equal(a, b), name


def test_eval_forward_matches_the_reference():
    input_dim, ref, port = 32, _reference(32), _port(32)
    import_reference_state_dict(port, ref.state_dict())
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (4, 1, input_dim, input_dim)).astype(np.float32))
    eps = torch.from_numpy(np.random.default_rng(1).normal(size=(4, 10)).astype(np.float32))
    with torch.no_grad():
        recon, mu, log_var = ref(x, eps=eps)
        out = port(x.permute(0, 2, 3, 1), train=False, eps=eps)
    np.testing.assert_allclose(out.encoded.mu.numpy(), mu.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(out.encoded.log_var.numpy(), log_var.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(out.output.permute(0, 3, 1, 2).numpy(), recon.numpy(), rtol=0, atol=ATOL)


def test_train_forward_and_running_statistics_match_the_reference():
    """Batch statistics in the forward, and the running means after it
    (the running variances differ by design: torch averages the unbiased
    variance, the port, as flax, the biased one)."""
    input_dim = 32
    ref = _reference(input_dim)
    port = _port(input_dim)
    import_reference_state_dict(port, ref.state_dict())
    ref.train()
    x = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (4, 1, input_dim, input_dim)).astype(np.float32))
    eps = torch.from_numpy(np.random.default_rng(3).normal(size=(4, 10)).astype(np.float32))
    with torch.no_grad():
        recon, mu, log_var = ref(x, eps=eps)
        out = port(x.permute(0, 2, 3, 1), train=True, eps=eps)
    np.testing.assert_allclose(out.encoded.mu.numpy(), mu.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(out.output.permute(0, 3, 1, 2).numpy(), recon.numpy(), rtol=0, atol=ATOL)
    sd = export_reference_state_dict(port)
    for key, value in ref.state_dict().items():
        if key.endswith("running_mean"):
            np.testing.assert_allclose(sd[key].numpy(), value.numpy(), rtol=0, atol=ATOL, err_msg=key)


def test_state_dict_round_trips_bitwise(pair):
    _, ref, port = pair
    want = ref.state_dict()
    got = export_reference_state_dict(port, num_batches_tracked=STEPS_TRACKED)
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key
    # and into a fresh reference model, strictly
    fresh = TorchRefVAE(in_ch=1, latent=10, input_dim=ref.s * 16, hidden=HID)
    fresh.load_state_dict(got, strict=True)


def test_export_cli_writes_a_reference_state_dict(tmp_path, capsys):
    model = _port(32)
    state = create_train_state(model, build_optimizer(model, param_group_label))
    path = str(tmp_path / "c.pt")
    save_checkpoint(path, state_dict(state), total_step=7, encoder_config={"input_size": 32, "n_feature": 10},
                    config={"arch": "VanillaVAE", "dataset_name": "midi-synthetic", "n_features": 10,
                            "hidden_dims": list(HID), "image_size": 32, "torch_compat": True})
    out = str(tmp_path / "ref.pt")
    torch_reference.main(["--checkpoint", path, "--out", out])
    assert "wrote 64 tensors" in capsys.readouterr().out
    sd = torch.load(out)
    assert int(sd["encoder.0.1.num_batches_tracked"]) == 7
    ref = TorchRefVAE(in_ch=1, latent=10, input_dim=32, hidden=HID)
    ref.load_state_dict(sd, strict=True)
    x = torch.rand(2, 1, 32, 32)
    with torch.no_grad():
        want = model.decode(model.encode(x.permute(0, 2, 3, 1)).mu).permute(0, 3, 1, 2)
        got = ref.eval().decode(ref.encode(x)[0])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("kwargs,match", [
    (dict(arch="VanillaVAE"), "torch_compat=False"),
    (dict(arch="FoldedVAE", fold=4), "got FoldedVAE"),
], ids=["same_padding", "folded"])
def test_only_torch_compat_vanilla_has_a_reference_twin(kwargs, match):
    model = build_model(in_channels=1, latent_dim=10, input_dim=32, hidden_dims=HID, device="cpu", **kwargs)
    with pytest.raises(ValueError, match=match):
        export_reference_state_dict(model)
    with pytest.raises(ValueError, match=match):
        import_reference_state_dict(model, _reference(32).state_dict())


def _jax_torch_compat_checkpoint(path: str) -> None:
    """A JAX checkpoint of a ``torch_compat`` VanillaVAE whose EMA averages
    and running statistics differ from its parameters, so a mix-up shows."""
    model = jax_build_model("VanillaVAE", in_channels=1, latent_dim=10, input_dim=32, hidden_dims=HID,
                            torch_compat=True)
    state = jax.jit(lambda key: jax_create_train_state(model, optax.adamw(1e-3), key, jnp.zeros((2, 32, 32, 1)),
                                                       ema=True))(jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    perturb = lambda a: np.asarray(a) + rng.normal(0, 0.05, np.shape(a)).astype(np.asarray(a).dtype)  # noqa: E731
    state = state.replace(ema_params=jax.tree_util.tree_map(perturb, state.ema_params),
                          batch_stats=jax.tree_util.tree_map(lambda a: np.abs(perturb(a)), state.batch_stats))
    config = JaxTrainConfig(dataset_name="vae-lines-synthetic", image_size=32, arch="VanillaVAE", n_features=10,
                            hidden_dims=HID, torch_compat=True, ema_decay=0.9).to_dict()
    jax_save_checkpoint(path, state, config=config, epoch=1, total_step=9,
                        encoder_config={"input_size": 32, "n_feature": 10})


def test_export_cli_npz_is_the_jax_torch_export_npz(tmp_path, capsys):
    """``--out x.npz`` writes ``np.savez`` of the state_dict: the keys,
    shapes, dtypes and bytes of the JAX CLI's ``.npz`` for the same
    checkpoint (its EMA weights; ``num_batches_tracked`` int64 0-d)."""
    ckpt = str(tmp_path / "tc.msgpack")
    _jax_torch_compat_checkpoint(ckpt)
    want_path, got_path = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_torch_export.main(["--checkpoint", ckpt, "--out", want_path])
    torch_reference.main(["--checkpoint", ckpt, "--out", got_path])
    assert "wrote 64 tensors" in capsys.readouterr().out
    want, got = np.load(want_path), np.load(got_path)
    assert list(got.files) == list(want.files) and len(want.files) == 64
    for key in want.files:
        a, b = got[key], want[key]
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), key
    assert got["encoder.0.1.num_batches_tracked"].dtype == np.int64
    assert int(got["encoder.0.1.num_batches_tracked"]) == 9


def test_export_cli_refuses_no_ema(tmp_path, capsys):
    """The JAX CLI always exports the EMA weights and has no ``--no-ema``;
    neither has the port's."""
    with pytest.raises(SystemExit) as exc:
        torch_reference.main(["--checkpoint", str(tmp_path / "c.pt"), "--out", str(tmp_path / "r.pt"), "--no-ema"])
    assert exc.value.code == 2 and "--no-ema" in capsys.readouterr().err

"""The committed JAX trajectory fixture (``tests/fixtures/
trajectory_folded_fold8.npz`` and ``.json``, which ``chip_smoke.py``
``trajectory_phase`` replays on the card) is current: the first two steps
of its float32 run, rerun live through the JAX train CLI at full width
on the CPU (``--fused``: the Pallas kernels in interpret mode), give the
fixture's loss, reconstruction, KL loss, KL weight and grad norm (rtol
1e-6), its reparameterization draws (atol 1e-6) and its augmentation
draws (exactly); and the seeded init rebuilt from the port's model alone
(as the card rebuilds it) has the fixture's checksum. Regenerate the
fixture with ``tests/fixtures/make_trajectory.py`` when the JAX package
changes.
"""

import json
import os

import numpy as np
import pytest

import midi_vae_tpu.cli.train as jax_cli
import torch_trajectory as tt
from make_trajectory import ARGV, FIXTURE, INIT_SEED, SYNTHETIC_FILES, model_config
from midi_vae_tpu.data.transforms import get_transform
from midi_vae_tpu_torch.models.registry import build_model
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from trajectory_replay import checksum, init_leaves, port_shapes


class _TwoSteps(Exception):
    pass


@pytest.fixture(scope="module")
def fixture():
    with open(FIXTURE + ".json") as f:
        meta = json.load(f)
    return meta, dict(np.load(FIXTURE + ".npz"))


def test_init_rebuilt_from_the_port_model_has_the_fixture_checksum(fixture):
    meta, _ = fixture
    model = build_model("FoldedVAE", in_channels=1, latent_dim=10, input_dim=128, hidden_dims=(48, 64, 128, 256),
                        fold=8, device="cpu")
    assert checksum(init_leaves(port_shapes(model), meta["init_seed"])) == pytest.approx(meta["init_checksum"], rel=1e-9)


def test_first_two_steps_rerun_in_jax_match_the_fixture(fixture, tmp_path):
    meta, arrays = fixture
    assert meta["argv"] == ARGV and meta["synthetic_files"] == SYNTHETIC_FILES and meta["init_seed"] == INIT_SEED
    init = str(tmp_path / "init.msgpack")
    tt.write_init_checkpoint(model_config(), init, INIT_SEED)
    draws, steps = tt.Draws(), []
    make_train_step, make_eval_step, evaluate = tt.jax_recorders(draws)

    def two_steps(model, tx, kl_schedule, **kw):
        step = make_train_step(model, tx, kl_schedule, **kw)

        def stepped(state, x, key):
            if len(steps) == 2:
                raise _TwoSteps
            state, lo, grad_norm = step(state, x, key)
            steps.append([float(v) for v in (lo.loss, lo.reconstruction_loss, lo.kld_loss, lo.kld_weight, grad_norm)])
            return state, lo, grad_norm

        stepped.raw_step_fn, stepped.conditional = step.raw_step_fn, step.conditional
        return stepped

    with tt.synthetic_sizes({"midi-synthetic": SYNTHETIC_FILES}), \
            tt.patched(tt.jax_loop, "make_train_step", two_steps), \
            tt.patched(tt.jax_loop, "make_eval_step", make_eval_step), \
            tt.patched(tt.jax_loop, "evaluate", evaluate), pytest.raises(_TwoSteps):
        jax_cli.cli(ARGV + ["--pretrained", init, "--models-dir", str(tmp_path / "models"), "--run-id", "float32"])

    rows = [r for r in meta["runs"]["float32"]["rows"] if "training/stepwise/train/loss" in r][:2]
    keys = ("loss", "loss_recon", "loss_kld", "kld_weight", "grad_norm")
    want = [[r[f"training/stepwise/train/{k}"] for k in keys] for r in rows]
    np.testing.assert_allclose(steps, want, rtol=1e-6)
    np.testing.assert_allclose(np.stack([d[0] for d in draws.train]), arrays["float32_train_eps"][:2], rtol=0,
                               atol=1e-6)
    nb = meta["runs"]["float32"]["steps_per_epoch"]
    spec = get_transform("pianoroll", 128)[0]
    for k in range(2):
        dps, dts, scales = tt.jax_aug_draws(0, 1 + k // nb, k % nb, 100, spec)
        assert dps == arrays["aug_dp"][k].tolist() and dts == arrays["aug_dt"][k].tolist()
        assert np.array_equal(np.asarray(scales, np.float32), arrays["aug_scale"][k])
    assert os.path.getsize(FIXTURE + ".npz") + os.path.getsize(FIXTURE + ".json") < 300_000

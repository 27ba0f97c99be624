"""Shared set-up of the port's train-loop tests (``tests/test_torch_cli*.py``):
the small run configuration they train, and the one-epoch run of each
option once refused (``run_option_case``), whose cases are split over
``test_torch_cli_options.py`` and ``test_torch_cli_variant_options.py``
under the ids they had in one list."""

import os

import numpy as np
import pytest

import midi_vae_tpu_torch.data.fetch as fetch
from midi_vae_tpu_torch.data.sources import write_rrd
from midi_vae_tpu_torch.data.synthetic import generate_line_images
from midi_vae_tpu_torch.io.checkpoint import load_checkpoint
from midi_vae_tpu_torch.io.dcp_io import is_orbax_checkpoint
from midi_vae_tpu_torch.ops import cuda_lib
from midi_vae_tpu_torch.ops.cuda_lib import BUILD_DIR_ENV
from midi_vae_tpu_torch.train import schedules
from midi_vae_tpu_torch.train.config import TrainConfig
from midi_vae_tpu_torch.train.loop import run
from midi_vae_tpu_torch.train.optim import scale_lr

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_FIXTURE = os.path.join(_REPO, "tests", "fixtures", "jax_folded_lines28.msgpack")


def small_config(tmp_path, **overrides) -> TrainConfig:
    base = dict(
        dataset_name="vae-lines-synthetic",
        transform_type="noaug",
        image_size=28,
        arch="VanillaVAE",
        n_features=4,
        hidden_dims=(8, 16),
        epochs=2,
        batch_size_per_device=128,
        lr_relative=0.02,
        kld_weight=0.00025,
        seed=0,
        models_dir=str(tmp_path / "models"),
        log_interval=2,
        log_images=False,
    )
    base.update(overrides)
    return TrainConfig(**base)


# (train config overrides, the ROADMAP item that once refused them)
OPTION_CASES = [
        (dict(arch="VQVAE", grad_accum=2), 7), (dict(loss_type="beta-tc"), 17),
        (dict(arch="FoldedVQVAE", step_impl="shard_map"), 16),
        (dict(pretrained="checkpoint_latest.msgpack"), 10),
        (dict(grad_accum=2), 7), (dict(scan_steps=8), 9), (dict(checkpoint_backend="orbax"), 10),
        (dict(num_devices=1, mesh_slices=1), 16), (dict(mesh_slices=1, step_impl="shard_map"), 16),
        (dict(step_impl="shard_map"), 16),
        (dict(conditional=True), 17), (dict(stem="s2d"), 17), (dict(norm="group"), 17), (dict(remat=True), 17),
        (dict(torch_compat=True), 17), (dict(verbose=True), 17), (dict(compilation_cache="/c"), "17e"),
        (dict(optimizer="Lion"), 17), (dict(scheduler="cosine"), 17), (dict(arch="MLPVAE"), 17),
        (dict(dataset_name="rrd:/x.rrd"), 9),
    ]
OPTION_IDS = [f"overrides{i}-{item}" for i, (_, item) in enumerate(OPTION_CASES)]
OPTION_SPLIT = 11  # cases [:11] in test_torch_cli_options.py, the rest in test_torch_cli_variant_options.py


def run_option_case(tmp_path, monkeypatch, overrides) -> None:
    """One epoch of ``small_config`` under ``overrides`` on a 256-image
    corpus, finite, and the option's own check (``_PORTED_OPTIONS``); the
    options that name a file get a real one under ``tmp_path`` (``_FILES``)."""
    monkeypatch.setitem(fetch.SYNTHETIC_SIZES, "vae-lines-synthetic", 256)
    for env in (BUILD_DIR_ENV, "TRITON_CACHE_DIR", "TORCHINDUCTOR_CACHE_DIR"):
        monkeypatch.delenv(env, raising=False)  # --compilation-cache sets them for the process
    check = next(c for options, c in _PORTED_OPTIONS if options == overrides)
    key = next(iter(overrides))
    options = {**overrides, **_FILES[key](tmp_path)} if key in _FILES else overrides
    r = run(small_config(tmp_path, models_dir=None, epochs=1, **options), device="cpu")
    assert np.isfinite(r["train"]["loss"]) and np.isfinite(r["final_test"]["cross-entropy"])
    assert check(r) if key not in _FILES else check(r, tmp_path)




def _lines_rrd(tmp_path) -> dict:
    """The 256-image corpus as an RRD stream, host-fed (the native loader)."""
    images, labels = generate_line_images(256, img_size=(28, 28), max_lines=2, line_width=2, seed=0)
    write_rrd(images[..., None], labels, str(tmp_path / "x.rrd"))
    return dict(dataset_name="rrd:" + str(tmp_path / "x.rrd"), data_placement="host")


# options that name a file → the real options (the file made under tmp_path)
_FILES = {
    "pretrained": lambda tmp: dict(pretrained=JAX_FIXTURE, arch="FoldedVAE", fold=4),
    "checkpoint_backend": lambda tmp: dict(checkpoint_backend="orbax", save_best_model=True,
                                           checkpoint_path=str(tmp / "o" / "checkpoint_latest.orbax")),
    "compilation_cache": lambda tmp: dict(compilation_cache=str(tmp / "c")),
    "dataset_name": _lines_rrd,
}


def _lr_now(r):
    return r["state"].optimizer.optimizer.param_groups[0]["lr"]


def _accumulated(r):
    return r["forwards"]["train_forwards"] == 2 * r["forwards"]["train_steps"] > 0


# (options, check of the run's results) for the options ported since they were refused here
_PORTED_OPTIONS = [
    (dict(arch="VQVAE", grad_accum=2), lambda r: _accumulated(r) and r["final_test"]["active-codes"] > 0),
    (dict(loss_type="beta-tc"), lambda r: np.isfinite(r["final_test"]["kl"])),
    (dict(grad_accum=2), _accumulated),
    # vae-lines-synthetic labels are line counts, 1 or 2: max + 1 = 3 classes
    (dict(conditional=True), lambda r: r["state"].model.num_classes == 3),
    (dict(optimizer="Lion"), lambda r: type(r["state"].optimizer.optimizer).__name__ == "Lion"),
    (dict(scheduler="cosine"), lambda r: r["state"].optimizer.optimizer.param_groups[0]["lr"] == pytest.approx(
        schedules.cosine_lr(scale_lr(0.02, 128), r["total_step"])(r["total_step"] - 1))),
    (dict(arch="MLPVAE"), lambda r: type(r["state"].model).__name__ == "MLPVAE"),
    (dict(stem="s2d"), lambda r: r["state"].model.stem == "s2d" and hasattr(r["state"].model.encoder, "S2DStem_0")),
    (dict(norm="group"), lambda r: hasattr(r["state"].model.encoder.ConvBlock_0, "GroupNorm_0")),
    (dict(remat=True), lambda r: r["state"].model.remat),
    (dict(torch_compat=True), lambda r: type(r["state"].model.decoder.DeconvBlock_0.ConvTranspose_0).__name__
     == "TorchConvTranspose"),
    (dict(verbose=True), lambda r: r["state"].model.verbose),
    (dict(arch="FoldedVQVAE", step_impl="shard_map"),
     lambda r: r["mesh"] == {"axes": ("data",), "shape": (1,)} and r["final_test"]["active-codes"] > 0),
    (dict(num_devices=1, mesh_slices=1), lambda r: r["mesh"] == {"axes": ("slice", "data"), "shape": (1, 1)}),
    (dict(mesh_slices=1, step_impl="shard_map"), lambda r: r["mesh"] == {"axes": ("slice", "data"), "shape": (1, 1)}),
    (dict(step_impl="shard_map"), lambda r: r["mesh"] == {"axes": ("data",), "shape": (1,)}),
    # one host read per chunk of 8 steps over the device-resident corpus
    (dict(scan_steps=8), lambda r: r["history"][0]["train"]["host_syncs"] == -(-r["steps_per_epoch"] // 8)),
    # warm-started from the JAX package's fixture: counters fresh
    (dict(pretrained="checkpoint_latest.msgpack"),
     lambda r, tmp: r["total_step"] == r["steps_per_epoch"] and r["config"]["pretrained"] == JAX_FIXTURE),
    (dict(checkpoint_backend="orbax"), lambda r, tmp: is_orbax_checkpoint(str(tmp / "o" / "checkpoint_latest.orbax"))
     and load_checkpoint(str(tmp / "o" / "checkpoint_latest.orbax"))["epoch"] == 1
     and is_orbax_checkpoint(str(tmp / "o" / "best_model.orbax"))),
    (dict(compilation_cache="/c"), lambda r, tmp: cuda_lib.build_dir() == tmp / "c" / "kernels"
     and os.environ["TRITON_CACHE_DIR"] == str(tmp / "c" / "triton")),
    (dict(dataset_name="rrd:/x.rrd"), lambda r, tmp: r["corpus"] == {"train": 204, "val": 52, "test": 52}
     and r["config"]["dataset_name"].startswith("rrd:")),
]



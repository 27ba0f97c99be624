"""The train CLI of the PyTorch port: its config and flags against the JAX
package's, key for key (``configs/*.yaml`` through both readers, the
parsers' flags, defaults and choices, YAML/flag precedence). The loop end
to end is in ``tests/test_torch_cli_run.py``, the options one by one in
``tests/test_torch_cli_options.py``.
"""

import argparse
import dataclasses
import glob
import os

import pytest
import yaml

from midi_vae_tpu.cli.train import args_to_config as jax_args_to_config
from midi_vae_tpu.cli.train import get_parser as jax_get_parser
from midi_vae_tpu.train.config import from_yaml as jax_from_yaml
from midi_vae_tpu_torch.cli.train import args_to_config, get_parser
from midi_vae_tpu_torch.train.config import TrainConfig, from_yaml, read_yaml

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(_REPO, "configs", "*.yaml")))


# ------------------------------------------------------------ config parity


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_from_yaml_matches_jax(path):
    assert from_yaml(path).to_dict() == jax_from_yaml(path).to_dict()
    with open(path) as f:
        assert read_yaml(path) == yaml.safe_load(f)


def test_reference_yaml_schema_and_scalars_match_jax(tmp_path):
    p = tmp_path / "vae.yaml"
    p.write_text(
        "# reference schema\nmodel_params:\n  latent_dim: 10   # z\n  hidden_dims: [32, 64, 128, 256]\n"
        "data_params:\n  train_batch_size: 100\n  data_path: '/data/x # not a comment'\n"
        "exp_params:\n  LR: 0.001\n  weight_decay: 1e-4\n  kld_weight: .25\n  manual_seed: 0\n"
        "trainer_params:\n  max_epochs: 100\n  flag: yes\n  empty:\n  nothing: ~\n  inf: -.inf\n"
    )
    assert read_yaml(str(p)) == yaml.safe_load(p.read_text())
    assert from_yaml(str(p)).to_dict() == jax_from_yaml(str(p)).to_dict()
    (tmp_path / "empty.yaml").write_text("# nothing\n")
    assert read_yaml(str(tmp_path / "empty.yaml")) is None
    assert from_yaml(str(tmp_path / "empty.yaml")) == TrainConfig()
    (tmp_path / "bad.yaml").write_text("a: {b: 1}\n")
    with pytest.raises(ValueError, match="unsupported"):
        read_yaml(str(tmp_path / "bad.yaml"))


def test_parser_matches_jax():
    def surface(parser):
        return sorted(
            (tuple(a.option_strings), a.dest, repr(a.default), repr(a.choices), a.nargs, getattr(a, "const", None))
            for a in parser._actions
        )

    assert surface(get_parser()) == surface(jax_get_parser())


ARGVS = {
    "defaults": [],
    "flagship_fused": ["--config", "configs/folded.yaml", "--fused", "--bce-targets", "normalized", "--epochs", "3"],
    "yaml_wins_over_defaults": ["--config", "configs/midi.yaml"],
    "typed_default_beats_yaml": ["--config", "configs/folded.yaml", "--batch-size=128", "--lr", "0.01"],
    "abbreviated_beats_yaml": ["--config", "configs/folded.yaml", "--epoch", "5", "--stop-after", "2"],
    "many_flags": [
        "--dataset", "vae-lines-synthetic", "--model", "FoldedVAE", "--fold", "8", "--hidden-dims", "8", "16",
        "--log-var-clamp", "-10", "10", "--free-bits", "0.1", "--bce-pos-weight", "auto", "--output-bias-init", "-2.5",
        "--prototyping", "3", "--protoval-split-rate", "auto", "--ema-decay", "0.99", "--bf16", "--kl-schedule", "linear",
        "--async-checkpoint", "--save-best-model", "--data-placement", "host", "--disable-wandb", "--log-wandb",
    ],
}


@pytest.mark.parametrize("name", list(ARGVS))
def test_args_to_config_matches_jax(name, monkeypatch):
    monkeypatch.chdir(_REPO)
    argv = ARGVS[name]
    got = args_to_config(get_parser().parse_args(argv), argv)
    want = jax_args_to_config(jax_get_parser().parse_args(argv), argv)
    assert got.to_dict() == want.to_dict()


def test_yaml_and_flag_precedence(monkeypatch):
    monkeypatch.chdir(_REPO)
    argv = ["--config", "configs/folded.yaml", "--epoch", "5", "--batch-size", "128"]
    config = args_to_config(get_parser().parse_args(argv), argv)
    assert (config.epochs, config.batch_size_per_device, config.arch, config.fold) == (5, 128, "FoldedVAE", 8)
    assert config.bce_targets == "raw" and config.output_bias_init == "auto" and config.dtype == "bfloat16"


def test_every_enum_and_switch_flag_reaches_config():
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    parser = get_parser()
    defaults = parser.parse_args([])
    covered = 0
    for action in parser._actions:
        d = action.dest
        if d not in fields or not action.option_strings:
            continue
        default = getattr(defaults, d)
        if action.choices:
            alts = [c for c in action.choices if c != default]
            if not alts:
                continue
            argv, expected = [action.option_strings[0], str(alts[0])], alts[0]
        elif isinstance(action, argparse._StoreTrueAction) and not default:
            argv, expected = [action.option_strings[0]], True
        elif action.type in (int, float) and action.nargs is None:
            expected = action.type(3 if action.type is int else 0.1875)
            if expected in (default, getattr(TrainConfig(), d, None)):
                expected = action.type(7 if action.type is int else 0.4375)
            argv = [action.option_strings[0], repr(expected)]
        else:
            continue
        config = args_to_config(parser.parse_args(argv), argv)
        assert getattr(config, d) == expected, f"{action.option_strings[0]} parsed but not wired into TrainConfig.{d}"
        covered += 1
    assert covered >= 10

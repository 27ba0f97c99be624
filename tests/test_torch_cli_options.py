"""The train CLI's options on the CPU, one run each (the first half of
``torch_cli_helpers.OPTION_CASES``; the rest in
``test_torch_cli_variant_options.py``): every option once refused (now
ported) trains one epoch on a 256-image corpus and meets a check of its
own; the one refusal left (``--allow-download-dataset``, which needs the
network) names the ROADMAP item that lists it; ``--multihost`` and the
mesh options' errors.
"""

import os
import re

import pytest

from midi_vae_tpu_torch.cli.train import cli
from midi_vae_tpu_torch.train.loop import run
from torch_cli_helpers import OPTION_CASES, OPTION_IDS, OPTION_SPLIT, run_option_case, small_config
from torch_cli_helpers import one_torch_thread  # noqa: F401 (autouse)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("overrides,item", OPTION_CASES[:OPTION_SPLIT], ids=OPTION_IDS[:OPTION_SPLIT])
def test_unported_options_raise_with_their_roadmap_item(tmp_path, monkeypatch, overrides, item):
    """Every option these cases once refused is ported: items 7, 16 and
    17a–d (grad_accum, the multi-device options, β-TC and MLPVAE, the
    optimizers and schedules, conditional models, the model variants), and
    items 9, 10 and 17e (``--scan-steps``, an ``rrd:`` stream, the
    ``orbax`` backend, ``--pretrained`` from a JAX ``.msgpack``,
    ``--compilation-cache``). Each trains one epoch on a 256-image corpus
    and meets its own check (item 16's over one device, its mesh and
    collectives over a one-rank group; several ranks:
    ``tests/test_torch_multirank_cli.py``). The options that name a file
    get a real one under ``tmp_path`` (``_FILES``)."""
    run_option_case(tmp_path, monkeypatch, overrides)


# each option still refused (train config overrides) → the flag ROADMAP names it by
_STILL_REFUSED = [(dict(dataset_name="mnist", allow_download_dataset=True), "--allow-download-dataset")]


def _roadmap_queue1_entries() -> dict:
    """ROADMAP Queue 1's open entries: item label (``16``, ``17e`` …) → the entry's text."""
    text = open(os.path.join(_REPO, "ROADMAP.md")).read()
    queue = text.split("### Queue 1", 1)[1].split("\n### ", 1)[0]
    entries = {}
    for block in re.split(r"\n(?=\d+\. \*\*)", queue)[1:]:
        title = block.split("**")[1]
        for label in re.findall(r"\b(\d+[a-e]?)\b", title.split(":")[0]):
            entries[label] = block
    return entries


@pytest.mark.parametrize("overrides,flag", _STILL_REFUSED, ids=[f for _, f in _STILL_REFUSED])
def test_refusals_name_the_item_roadmap_lists_them_under(tmp_path, overrides, flag):
    """Each option still refused names a ROADMAP Queue 1 item whose entry lists it."""
    with pytest.raises(NotImplementedError, match=r"ROADMAP Queue 1 item (\w+)") as info:
        run(small_config(tmp_path, models_dir=None, data_dir=str(tmp_path), **overrides), device="cpu")
    item = re.search(r"ROADMAP Queue 1 item (\w+)", str(info.value)).group(1)
    entries = _roadmap_queue1_entries()
    assert item in entries, f"{flag}: item {item} is not an open ROADMAP Queue 1 entry ({sorted(entries)})"
    assert flag in entries[item], f"{flag}: ROADMAP item {item} does not list it"


def test_multihost_flag_raises(monkeypatch):
    """--multihost joins the ranks torchrun started; without torchrun's
    environment it raises naming what is missing."""
    from midi_vae_tpu_torch.parallel.mesh import TORCHRUN_ENV

    for key in TORCHRUN_ENV:
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        cli(["--multihost", "--cpu"])


@pytest.mark.parametrize("overrides,match", [
    (dict(mesh_slices=2), "--num-devices 1 does not divide into --mesh-slices 2"),
    (dict(num_devices=3, mesh_slices=2), "--num-devices 3 does not divide into --mesh-slices 2"),
], ids=["one_device_two_slices", "three_devices_two_slices"])
def test_mesh_slices_that_do_not_divide_the_devices_raise(tmp_path, overrides, match):
    """The JAX package's divisibility error, before any rank starts."""
    with pytest.raises(ValueError, match=match):
        run(small_config(tmp_path, models_dir=None, **overrides), device="cpu")

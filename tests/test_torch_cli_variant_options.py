"""The train CLI's options on the CPU, one run each: the second half of
``torch_cli_helpers.OPTION_CASES`` (the model variants, conditional
models, the optimizers and schedules, MLPVAE, ``--compilation-cache`` and
an ``rrd:`` stream), under the ids the cases have in that one list.
"""

import pytest

from torch_cli_helpers import OPTION_CASES, OPTION_IDS, OPTION_SPLIT, run_option_case
from torch_cli_helpers import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("overrides,item", OPTION_CASES[OPTION_SPLIT:], ids=OPTION_IDS[OPTION_SPLIT:])
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

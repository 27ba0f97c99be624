"""FLOPs of each configuration's step against a count by hand, and K1's
and K2's bytes and operations."""

import json
import os

import pytest

from bench_cuda import counts, peaks
from bench_cuda.reference import vae
from bench_cuda.tests.conftest import ROOT

# per sample, forward: (multiply-adds of each conv, transposed conv and dense layer), first conv first.
# A conv's are Cin·Cout·9 per output pixel; a transposed conv's Cin·Cout·9 per input pixel.
HAND = {
    "folded_fold8": [64 * 48 * 9 * 64, 48 * 64 * 9 * 64, 64 * 128 * 9 * 64, 128 * 256 * 9 * 64,  # encoder at 8x8
                     2 * 16384 * 10, 10 * 16384,  # fc_mu, fc_var; decoder_input
                     256 * 128 * 9 * 64, 128 * 64 * 9 * 64, 64 * 48 * 9 * 64,  # decoder: 2 convs, 1 deconv from 8x8
                     48 * 48 * 9 * 256, 48 * 64 * 9 * 256],  # head at 16x16
    "vanilla_midi": [1 * 32 * 9 * 4096, 32 * 64 * 9 * 1024, 64 * 128 * 9 * 256, 128 * 256 * 9 * 64,
                     2 * 16384 * 10, 10 * 16384,
                     256 * 128 * 9 * 64, 128 * 64 * 9 * 256, 64 * 32 * 9 * 1024,  # deconvs from 8, 16, 32
                     32 * 32 * 9 * 4096, 32 * 1 * 9 * 16384],  # final deconv from 64, output conv at 128
}


def _config(name):
    with open(os.path.join(ROOT, f"bench_cuda/configs/{name}.json")) as f:
        return json.load(f)["train"]


@pytest.mark.parametrize("name,fwd_mflop", [("folded_fold8", 130.74432), ("vanilla_midi", 314.769408)])
def test_forward_flops_by_hand(name, fwd_mflop):
    assert 2 * sum(HAND[name]) == pytest.approx(fwd_mflop * 1e6, abs=1)


@pytest.mark.parametrize("name", sorted(HAND))
@pytest.mark.parametrize("batch", [1, 100, 2048])
def test_step_flops_match_the_hand_count(name, batch):
    """Forward, the input's gradient (none for the first conv, whose input
    needs none) and the weight's gradient each cost one forward."""
    macs = HAND[name]
    step = 2 * (3 * sum(macs) - macs[0]) * batch
    assert counts.model_flops(vae, _config(name), batch) == step


def test_flagship_flops_per_sample():
    assert counts.model_flops(vae, _config("folded_fold8"), 1) == pytest.approx(0.3887e9, rel=1e-3)


def test_kernel_bytes_and_operations():
    n = 2048 * 128 * 128
    assert counts.kernel_cost("K1", n, 2, 4) == (n * 6 + 4, n * 23)
    assert counts.kernel_cost("K2", n, 2, 4) == (n * 8 + 4, n * 23)
    # bound by bytes on the flagship call: 60.1 us for K1, 80.1 us for K2
    assert counts.bound_seconds(*counts.kernel_cost("K1", n, 2, 4)) == pytest.approx(n * 6 / 3.35e12, rel=1e-6)
    assert counts.bound_seconds(*counts.kernel_cost("K2", n, 2, 4)) == pytest.approx(80.1e-6, rel=1e-3)
    with pytest.raises(ValueError):
        counts.kernel_cost("K3", n, 2, 4)


def test_operations_bound_when_bytes_are_few():
    assert counts.bound_seconds(8, 67e12) == pytest.approx(1.0)
    assert peaks.PEAK_FLOPS["bfloat16"] == 989e12 and peaks.HBM_BYTES_PER_S == 3.35e12

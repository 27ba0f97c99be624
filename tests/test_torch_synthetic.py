"""The port's on-device piano-roll generator vs the JAX one. The random
streams differ (torch's generator vs threefry), so the comparison is of
the distribution: shape, dtype, value ranges, notes per roll, fill rate."""

import jax
import numpy as np
import pytest
import torch

from midi_vae_tpu.data.synthetic import make_pianoroll_batch as jax_make_pianoroll_batch
from midi_vae_tpu_torch.data.synthetic import make_pianoroll_batch
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROLLS = 256


@pytest.fixture(scope="module")
def batches():
    roll, notes = make_pianoroll_batch(torch.Generator().manual_seed(0), ROLLS, device="cpu")
    jroll, jnotes = jax_make_pianoroll_batch(jax.random.PRNGKey(0), ROLLS)
    return roll.numpy(), notes.numpy(), np.asarray(jroll), np.asarray(jnotes)


def test_shape_dtype_and_ranges(batches):
    roll, notes, _, _ = batches
    assert roll.shape == (ROLLS, 128, 128, 1) and roll.dtype == np.float32
    assert roll.min() >= 0.0 and roll.max() <= 1.0
    on = roll[roll > 0]
    assert on.min() >= 0.25 and on.max() <= 1.0
    assert notes.shape == (ROLLS,) and notes.min() >= 1 and notes.max() <= 24


def test_fill_rate_and_note_counts_match_jax(batches):
    roll, notes, jroll, jnotes = batches
    fill, jfill = (roll > 0).mean(), (jroll > 0).mean()
    assert abs(fill - jfill) <= 0.2 * jfill, (fill, jfill)
    assert abs(notes.mean() - jnotes.mean()) <= 0.2 * jnotes.mean()


def test_same_generator_state_repeats():
    a, _ = make_pianoroll_batch(torch.Generator().manual_seed(3), 4, device="cpu")
    b, _ = make_pianoroll_batch(torch.Generator().manual_seed(3), 4, device="cpu")
    c, _ = make_pianoroll_batch(torch.Generator().manual_seed(4), 4, device="cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)

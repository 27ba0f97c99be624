"""The benchmark's frozen copies against the port as it stands today."""

import numpy as np
import pytest
import torch

from bench_cuda import frozen

SEEDS = [0, 7, 2**31 + 5, 3_000_000_017]


@pytest.mark.parametrize("seed", SEEDS)
def test_rolls_match_the_port_generator(seed):
    from midi_vae_tpu_torch.data.synthetic import make_pianoroll_batch

    port, _ = make_pianoroll_batch(torch.Generator().manual_seed(seed), 32, device="cpu")
    ours = frozen.make_rolls(torch.Generator().manual_seed(seed), 32)
    assert torch.equal(port, ours)


@pytest.mark.parametrize("seed", SEEDS)
def test_seeds_match_the_port(seed):
    from midi_vae_tpu_torch.core import rng

    for epoch in (1, 2, 57):
        assert frozen.epoch_seed(seed, epoch) == rng.epoch_seed(seed, epoch)
        assert frozen.host_epoch_seed(seed, epoch) == rng.host_epoch_seed(seed, epoch)
        for step in (0, 1, 799, 16399):
            assert frozen.step_seed(frozen.epoch_seed(seed, epoch), step) == rng.derive_step_seed(
                rng.epoch_seed(seed, epoch), step)


@pytest.mark.parametrize("seed", SEEDS)
def test_k3_draw_matches_the_port(seed):
    from midi_vae_tpu_torch.ops.fused_elbo import k3_eps_plain

    s = seed & 0x7FFFFFFF
    for offset in (0, 2048 * 10):
        assert torch.equal(frozen.k3_eps((64, 10), s, "cpu", offset), k3_eps_plain((64, 10), s, "cpu", offset))


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_loader_batches_match_order_and_transform(seed):
    """Every batch of the port's device-resident loader is the frozen order's
    rows through the frozen transform, bit for bit."""
    from midi_vae_tpu_torch.data.pipeline import DeviceResidentLoader
    from midi_vae_tpu_torch.data.sources import ArrayDataset
    from midi_vae_tpu_torch.data.transforms import get_transform

    corpus = frozen.make_corpus(seed, 40, "cpu", chunk=16)
    spec, _ = get_transform("pianoroll", 128, {"normalization": "midi-synthetic"})
    ds = ArrayDataset(images=corpus.numpy(), labels=np.zeros(40, np.int64), transform=spec)
    loader = DeviceResidentLoader(ds, 8, train=True, seed=seed, device="cpu")
    for epoch in (1, 3):
        order = frozen.train_order(seed, epoch, 40, 8)
        for i, batch in enumerate(loader.epoch(epoch)):
            x = frozen.pianoroll_train_transform(corpus[torch.as_tensor(order[i])], frozen.transform_seed(seed, epoch, i))
            assert torch.equal(batch.x, x), (epoch, i)
        assert i == len(order) - 1


def test_corpus_is_the_seed_s_and_uint8():
    a, b = frozen.make_corpus(11, 20, "cpu", chunk=8), frozen.make_corpus(11, 20, "cpu", chunk=8)
    assert a.dtype == torch.uint8 and a.shape == (20, 128, 128, 1) and torch.equal(a, b)
    assert not torch.equal(a, frozen.make_corpus(12, 20, "cpu", chunk=8))


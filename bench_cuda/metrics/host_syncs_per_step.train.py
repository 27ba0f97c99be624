"""The epoch loop's reads of device values per training step: the port's
counters ``train.host_syncs`` over ``train.steps``
(``midi_vae_tpu_torch/io/tracing.py``), which every epoch of the run adds
to. None where the port has no such counter."""


def read(traced: dict):
    try:
        from midi_vae_tpu_torch.io import tracing
    except ImportError:
        return None
    counts = tracing.counters()
    steps = counts.get("train.steps", 0)
    if steps <= 0:
        return None
    return counts.get("train.host_syncs", 0) / steps

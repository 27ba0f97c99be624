"""The conv blocks' BatchNorm forwards that ran as the fused BatchNorm +
LeakyReLU operation, in % of all of them: the port's counters
``norm.fused_calls`` over ``norm.batch_calls``
(``midi_vae_tpu_torch/io/tracing.py``), over the whole run. In a graphed
step the forwards count at the capture, not at the replays; each layer
chooses the same way every time, so the share is the same. None where the
port has no such counters."""


def read(traced: dict):
    try:
        from midi_vae_tpu_torch.io import tracing
    except ImportError:
        return None
    counts = tracing.counters()
    calls = counts.get("norm.batch_calls", 0)
    if calls <= 0:
        return None
    return 100.0 * counts.get("norm.fused_calls", 0) / calls

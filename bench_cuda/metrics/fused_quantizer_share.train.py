"""The VQ quantizer's calls that took the hand-written search and sum
kernels, in % of all its calls: the port's counters ``vq.fused_calls``
over ``vq.calls`` (``midi_vae_tpu_torch/io/tracing.py``), over the whole
run. None where the port has no such counters (no quantizer call, or a
program without ``vq.fused_calls``)."""


def read(traced: dict):
    try:
        from midi_vae_tpu_torch.io import tracing
    except ImportError:
        return None
    counts = tracing.counters()
    calls = counts.get("vq.calls", 0)
    if calls <= 0 or "vq.fused_calls" not in counts:
        return None
    return 100.0 * counts["vq.fused_calls"] / calls

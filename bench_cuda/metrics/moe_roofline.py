"""The MoE layers' expert part against its roofline: the least time of one
forward call of it (``bench_cuda/counts_prior.py``: the held experts over
a call's held assignments, the port's counter ``moe.held_assignments``
over ``moe.calls``, and the shared expert over its tokens) over the
device time launched inside the span ``prior.moe.experts`` a call (calls
counted by its ranges) in the labelled stretch, in %. None where the port
has no such span or counters."""

from bench_cuda import counts_prior


def read(traced: dict):
    labelled, moe = traced.get("spans"), traced.get("moe")
    if labelled is None or moe is None:
        return None
    calls, device_s = labelled.ranges("prior.moe.experts"), labelled.device_s("prior.moe.experts")
    try:
        from midi_vae_tpu_torch.io import tracing
    except ImportError:
        return None
    counts = tracing.counters()
    if calls == 0 or device_s <= 0 or counts.get("moe.calls", 0) <= 0 or "moe.held_assignments" not in counts:
        return None
    held = counts["moe.held_assignments"] / counts["moe.calls"]
    least = counts_prior.experts_call_least_seconds(moe["config"], held, moe["tokens"])
    return 100.0 * least / (device_s / calls)

"""The VQ quantizer's share of its roofline: the least time of one training
call (``bench_cuda/counts_vq.py``; N the vectors a call, the port's
counters ``vq.vectors`` over ``vq.calls``) over the device time launched
inside the spans ``model.quantize`` and ``model.codebook_update`` a call
(calls counted by the ``model.quantize`` ranges) in the labelled stretch,
in %. None where the port has no such spans or counters."""

from bench_cuda import counts_vq


def read(traced: dict):
    labelled, vq = traced.get("spans"), traced.get("vq")
    if labelled is None or vq is None:
        return None
    calls = labelled.ranges("model.quantize")
    device_s = labelled.device_s("model.quantize") + labelled.device_s("model.codebook_update")
    try:
        from midi_vae_tpu_torch.io import tracing
    except ImportError:
        return None
    counts = tracing.counters()
    if calls == 0 or device_s <= 0 or counts.get("vq.calls", 0) <= 0:
        return None
    n = counts["vq.vectors"] / counts["vq.calls"]
    return 100.0 * counts_vq.least_seconds(n, vq["codes"], vq["dim"], vq["z_bytes"]) / (device_s / calls)

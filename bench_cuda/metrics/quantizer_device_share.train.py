"""The VQ quantizer's share of the training step's device time: the device
time launched inside the port's spans ``model.quantize`` and
``model.codebook_update`` over that launched inside ``train.step``, in the
labelled stretch (``bench_cuda/spans.py``), in %. None where the stretch
holds no quantizer span (a program without them) or no step."""


def read(traced: dict):
    labelled = traced.get("spans")
    if labelled is None or labelled.ranges("model.quantize") == 0:
        return None
    step_s = labelled.device_s("train.step")
    if step_s <= 0:
        return None
    return 100.0 * (labelled.device_s("model.quantize") + labelled.device_s("model.codebook_update")) / step_s

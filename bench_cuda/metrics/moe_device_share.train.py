"""The MoE layers' share of the prior's training step on the device: the
device time launched inside the port's spans ``prior.moe.route`` and
``prior.moe.experts`` (the forward: routing, dispatch, experts, combine)
over that launched inside ``prior.step`` (forward and backward), in the
labelled stretch (``bench_cuda/spans.py``), in %. None where the stretch
holds no such span (a program without them) or no step."""


def read(traced: dict):
    labelled = traced.get("spans")
    if labelled is None or labelled.ranges("prior.moe.experts") == 0:
        return None
    step_s = labelled.device_s("prior.step")
    if step_s <= 0:
        return None
    return 100.0 * (labelled.device_s("prior.moe.route") + labelled.device_s("prior.moe.experts")) / step_s

"""The latent attention's share of the prior's training step on the
device: the device time launched inside the port's span
``prior.attention`` (each MLA forward) over that launched inside
``prior.step`` (forward and backward), in the labelled stretch
(``bench_cuda/spans.py``), in %. None where the stretch holds no such span
or no step."""


def read(traced: dict):
    labelled = traced.get("spans")
    if labelled is None or labelled.ranges("prior.attention") == 0:
        return None
    step_s = labelled.device_s("prior.step")
    if step_s <= 0:
        return None
    return 100.0 * labelled.device_s("prior.attention") / step_s

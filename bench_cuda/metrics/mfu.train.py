"""The whole step's share of the card's peak: the model's matmul and
convolution FLOPs per step (counted on the plain reference, forward and
backward) times the window's steps, over the window's seconds, over the
peak of the configuration's dtype, in %. Taken from the unprofiled window."""


def read(traced: dict):
    w, flops, peak = traced.get("window"), traced.get("flops_per_step"), traced.get("peak_flops")
    if not w or not flops or not peak or w["seconds"] <= 0 or w["steps"] <= 0:
        return None
    return flops * w["steps"] / w["seconds"] / peak * 100.0

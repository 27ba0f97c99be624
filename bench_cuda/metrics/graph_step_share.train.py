"""Training steps whose encoder and decoder ran as CUDA graph replays, in
% of all steps: the port's counters ``train.graph_steps`` over
``train.steps`` (``midi_vae_tpu_torch/io/tracing.py``), which every epoch
of the run adds to. None where the port has no such counter."""


def read(traced: dict):
    try:
        from midi_vae_tpu_torch.io import tracing
    except ImportError:
        return None
    counts = tracing.counters()
    steps = counts.get("train.steps", 0)
    if steps <= 0 or "train.graph_steps" not in counts:
        return None
    return 100.0 * counts["train.graph_steps"] / steps

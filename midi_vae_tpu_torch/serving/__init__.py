"""Serving: micro-batched inference over a trained checkpoint, over HTTP
(counterpart of ``midi_vae_tpu/serving``). :mod:`batcher` is the queueing
core, :mod:`server` the HTTP front end, :mod:`wire` the npy wire format
and :mod:`client` the caller's side. Importing this package imports
numpy only; the server module imports torch.
"""

from midi_vae_tpu_torch.serving.batcher import MicroBatcher  # noqa: F401
from midi_vae_tpu_torch.serving.client import ServingClient, ServingError  # noqa: F401
from midi_vae_tpu_torch.serving.wire import NPY_CONTENT_TYPE, npy_dumps, npy_loads  # noqa: F401

"""The explicit per-shard train step (counterpart of ``midi_vae_tpu/parallel/spmd.py``).

The auto step (``train/state.py`` with a mesh) is the one-rank step on
the global batch. This one is the JAX package's ``shard_map`` step: each
rank runs the forward and backward on its own rows and the collectives
are written out, which differs from the auto step on purpose:

- BatchNorm statistics are per shard, and the running averages are
  mean-reduced after the step. A VQ model is the exception, as in JAX
  (``train/loop.py`` hands it the mesh axes as ``bn_axis_name``): its
  BatchNorm statistics and codebook sums span every rank, so the codebook
  cannot drift per shard.
- Each rank draws its noise under its own seed, the step seed with its
  mesh coordinates folded in (``core/rng.py`` :func:`derive_shard_seed`);
  under ``--fused`` K3 draws the local batch from counter 0.
- The free-bits floor compares with the local batch's per-dimension KL.
- ``grad_accum`` cuts the local batch into micro-batches.
- One all-reduce per batch carries the gradients, the loss terms and the
  running statistics; then one optimizer update. β-TC gathers the latents
  over every rank.

Models without BatchNorm (``--norm group|none``, ``MLPVAE``) take the
same gradients on both steps once the noise is neutralised.
"""

from __future__ import annotations

from typing import Callable

from midi_vae_tpu_torch.parallel.mesh import DATA_AXIS, SLICE_AXIS, Mesh
from midi_vae_tpu_torch.train.state import make_train_step


def make_spmd_train_step(kl_schedule: Callable[[int], float], mesh: Mesh, **kwargs) -> Callable:
    """Build the explicit step ``(state, x, epoch_seed, *, y=None, eps=None)
    → (state, LossOutput, grad_norm)`` on a ``(data,)`` or ``(slice, data)``
    mesh (raises on any other); ``x`` and ``y`` are this rank's rows, and
    ``kwargs`` are :func:`~midi_vae_tpu_torch.train.state.make_train_step`'s."""
    axes = tuple(mesh.axis_names)
    if any(a not in (SLICE_AXIS, DATA_AXIS) for a in axes) or DATA_AXIS not in axes:
        raise ValueError(
            f"explicit SPMD step needs a 1-D ('{DATA_AXIS}',) or 2-D "
            f"('{SLICE_AXIS}', '{DATA_AXIS}') mesh, got axes {axes}"
        )
    return make_train_step(kl_schedule, mesh=mesh, per_shard=True, **kwargs)

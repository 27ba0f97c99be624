"""Multi-GPU training (counterpart of ``midi_vae_tpu/parallel``): the rank
mesh and process groups (``mesh``), collectives (``collectives``), the
launcher (``launch``), the explicit per-shard step (``spmd``) and the
tensor-parallel latent heads (``sharding_rules``)."""

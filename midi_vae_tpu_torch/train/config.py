"""Run configuration (counterpart of ``midi_vae_tpu/train/config.py``).

:class:`TrainConfig` has the JAX package's field names and defaults, so a
checkpoint's config dict means the same thing in both packages. The
device is not a field: ``train.loop.run(config, device=...)`` takes it.

``configs/*.yaml`` are read by :func:`read_yaml`
(``midi_vae_tpu_torch/io/yaml_read.py``), which returns what the JAX
package's ``yaml.safe_load`` returns without PyYAML installed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from midi_vae_tpu_torch.io.yaml_read import read_yaml


@dataclasses.dataclass
class TrainConfig:
    # Dataset
    dataset_name: str = "mnist"
    protoval_split_id: Optional[int] = None
    prototyping: bool = False
    data_dir: Optional[str] = None
    allow_download_dataset: bool = False
    transform_type: str = "digits"
    image_size: Optional[int] = None  # None → 32
    protoval_split_rate: Any = 0.1  # fraction, or "auto" (sized like the test set)

    # Architecture
    arch: str = "VanillaVAE"
    stem: str = "conv"
    head: str = "deconv"
    fold: int = 4
    norm: str = "batch"
    remat: bool = False
    torch_compat: bool = False
    pretrained: Optional[str] = None  # warm start: parameters only, counters fresh
    freeze_encoder: bool = False
    n_features: int = 10  # latent dim
    hidden_dims: Tuple[int, ...] = (32, 64, 128, 256)
    conditional: bool = False
    num_classes: int = 0

    # Loss
    kld_weight: float = 1.0
    kl_schedule: str = "constant"  # constant | multiplicative | linear | cyclical
    kl_warmup_steps: int = 1000
    kl_cycle_steps: int = 1000
    kl_ramp_fraction: float = 0.5
    kl_growth: float = 1.005
    kl_cap: float = 1.0
    loss_type: str = "elbo"  # elbo | beta-tc | vq
    tc_beta: float = 6.0
    codebook_size: int = 512
    vq_decay: float = 0.99
    log_var_clamp: Optional[Tuple[float, float]] = None
    free_bits: Optional[float] = None  # per-dimension KL floor in nats
    bce_pos_weight: Any = None  # float, "auto" = (1-p)/p, or None
    output_bias_init: Any = None  # float, "auto" = log(p/(1-p)), or None
    bce_targets: str = "normalized"  # normalized | raw
    fused: bool = False  # the hand-written kernels K1-K3 on the hot path

    # Optimization
    epochs: int = 5
    stop_after_epochs: Optional[int] = None
    early_stop_patience: Optional[int] = None
    final_iwae: Optional[int] = None
    final_mig: Optional[int] = None
    lr_relative: float = 0.01
    lr_encoder_mult: float = 1.0
    lr_decoder_mult: float = 1.0
    weight_decay: float = 0.0
    optimizer: str = "AdamW"
    scheduler: str = "OneCycle"
    grad_accum: int = 1
    grad_clip: float = 0.0  # 0.0 = off
    ema_decay: Optional[float] = None  # EMA of the parameters; eval and best use it

    # Checkpointing
    models_dir: Optional[str] = "models"
    async_checkpoint: bool = False
    checkpoint_backend: str = "msgpack"
    checkpoint_path: str = ""
    save_best_model: bool = False

    # Reproducibility
    seed: Optional[int] = None
    deterministic: bool = False
    debug_nans: bool = False
    verbose: bool = False
    profile_dir: Optional[str] = None
    profile_epochs: int = 1
    compilation_cache: Optional[str] = None

    # Hardware
    batch_size_per_device: int = 128
    prefetch: int = 2
    data_placement: str = "auto"  # auto | host | device
    scan_steps: int = 1
    num_devices: Optional[int] = None
    mesh_slices: Optional[int] = None
    dtype: str = "float32"  # float32 | bfloat16
    step_impl: str = "auto"

    # Logging
    log_interval: int = 10
    print_interval: Optional[int] = None
    log_wandb: bool = False
    wandb_entity: Optional[str] = None
    wandb_project: str = "midi_vae_tpu"
    run_name: Optional[str] = None
    run_id: Optional[str] = None
    log_images: bool = True

    # Derived at run time
    model_output_dir: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["hidden_dims"] = list(self.hidden_dims)
        if self.log_var_clamp is not None:
            d["log_var_clamp"] = list(self.log_var_clamp)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrainConfig":
        field_names = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in field_names}
        if "hidden_dims" in kwargs and kwargs["hidden_dims"] is not None:
            kwargs["hidden_dims"] = tuple(kwargs["hidden_dims"])
        if kwargs.get("log_var_clamp") is not None:
            kwargs["log_var_clamp"] = tuple(kwargs["log_var_clamp"])
        return cls(**kwargs)


def from_yaml(path: str) -> TrainConfig:
    """Load a config from YAML: this package's flat schema, or the
    reference's nested one (model_params/exp_params/data_params/trainer_params)."""
    raw = read_yaml(path) or {}
    if any(k in raw for k in ("model_params", "exp_params", "data_params", "trainer_params")):
        model = raw.get("model_params", {})
        data = raw.get("data_params", {})
        exp = raw.get("exp_params", {})
        trainer = raw.get("trainer_params", {})
        flat: Dict[str, Any] = {}
        if "latent_dim" in model:
            flat["n_features"] = model["latent_dim"]
        if "hidden_dims" in model:
            flat["hidden_dims"] = model["hidden_dims"]
        if "data_path" in data:
            flat["data_dir"] = data["data_path"]
        if "train_batch_size" in data:
            flat["batch_size_per_device"] = data["train_batch_size"]
        if "LR" in exp:
            # the YAML's LR is absolute; the CLI's is relative to batch 128
            flat["lr_relative"] = exp["LR"] * 128 / data.get("train_batch_size", 128)
        if "weight_decay" in exp:
            flat["weight_decay"] = exp["weight_decay"]
        if "kld_weight" in exp:
            flat["kld_weight"] = exp["kld_weight"]
        if "manual_seed" in exp:
            flat["seed"] = exp["manual_seed"]
        if "max_epochs" in trainer:
            flat["epochs"] = trainer["max_epochs"]
        return TrainConfig.from_dict(flat)
    return TrainConfig.from_dict(raw)

"""Optimisation settings of the training step (counterpart of s2t_tpu/config.py:253-290).

The port's own copy of the ``OptimizationConfig`` fields its train step reads,
with the JAX names and defaults.  ``lr_groups`` and ``quant_noise_p`` are kept
so that a non-default value raises instead of being ignored, as do optimizers
other than adam/adamw and schedulers other than inverse_sqrt.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

PORTED_OPTIMIZERS = ("adam", "adamw")
PORTED_SCHEDULERS = ("inverse_sqrt",)


@dataclass
class OptimizationConfig:
    lr: float = 2e-3
    clip_norm: float = 0.0
    update_freq: int = 1  # gradient accumulation: micro-batches on a leading axis
    # carried with the config; the criterion's own sentence_avg sets the sample size
    sentence_avg: bool = False
    optimizer: str = "adam"
    adam_betas: Tuple[float, float] = (0.9, 0.98)
    adam_eps: float = 1e-8
    weight_decay: float = 0.0
    lr_scheduler: str = "inverse_sqrt"
    warmup_updates: int = 10000
    warmup_init_lr: float = -1.0
    lr_groups: Dict[str, float] = field(default_factory=dict)
    quant_noise_p: float = 0.0


def check_supported(cfg: OptimizationConfig) -> None:
    """Raise NotImplementedError on a setting the port does not have."""
    if cfg.optimizer not in PORTED_OPTIMIZERS:
        raise NotImplementedError(
            f"OptimizationConfig.optimizer={cfg.optimizer!r} is not ported to s2t_tpu_torch "
            f"(only {PORTED_OPTIMIZERS})")
    if cfg.lr_scheduler not in PORTED_SCHEDULERS:
        raise NotImplementedError(
            f"OptimizationConfig.lr_scheduler={cfg.lr_scheduler!r} is not ported to "
            f"s2t_tpu_torch (only {PORTED_SCHEDULERS})")
    if cfg.lr_groups:
        raise NotImplementedError("OptimizationConfig.lr_groups is not ported to s2t_tpu_torch")
    if cfg.quant_noise_p > 0:
        raise NotImplementedError("OptimizationConfig.quant_noise_p is not ported to s2t_tpu_torch")
    if cfg.update_freq < 1:
        raise ValueError(f"update_freq must be >= 1, got {cfg.update_freq}")

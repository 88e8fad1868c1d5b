"""Trainer: one training step, forward with dropout -> loss -> backward -> clip ->
AdamW -> non-finite skip (counterpart of s2t_tpu/trainer.py:57-77, 80-375, without
the mesh, BMUF or quant-noise).

``Trainer(model, criterion, opt_cfg, device, seed).train_step(batch)`` is
the step ``bench.py`` section B drives through the JAX ``Trainer``:

* with ``update_freq`` = n > 1 every batch leaf carries a leading axis of n
  micro-batches; their summed losses are backpropagated one by one and the
  summed gradients and loss are normalised by the GLOBAL sample size
  (trainer.py:351-355) before the global norm is taken;
* the optimizer is ``FusedAdamWSkipNonFinite`` under the LR schedule;
* it returns ``loss``, ``gnorm``, ``lr`` (the schedule at the step count
  before this update, trainer.py:366-369), ``sample_size`` and the
  criterion's logs, all summed over the micro-batches.

Dropout bits come from a ``torch.Generator`` on the model's device seeded
from (seed, step) -- and the micro-batch index when n > 1 -- the counterpart
of ``jax.random.fold_in`` (trainer.py:325, :334), so a step is reproducible.
The model must be built with ``for_training=True`` (float32 master
parameters, compute in ``cfg.dtype``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from s2t_tpu_torch.config import OptimizationConfig, check_supported
from s2t_tpu_torch.device import resolve_device
from s2t_tpu_torch.optim.builders import FusedAdamWSkipNonFinite, build_lr_schedule

_MASK64 = (1 << 64) - 1


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from (seed, data): splitmix64 of their combination."""
    x = (seed * 0x9E3779B97F4A7C15 + data + 0x632BE59BD9B4E019) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) >> 1


def s2t_forward(model, batch: Dict[str, torch.Tensor], train: bool = False,
                generator: torch.Generator | None = None) -> Dict[str, Any]:
    """The forward adapter for speech-to-text batches (the JAX trainer's s2t_forward)."""
    return model(batch["features"], batch["feat_lengths"], batch["prev_tokens"],
                 train=train, generator=generator)


class Trainer:
    def __init__(self, model, criterion, opt_cfg: OptimizationConfig, device="cuda",
                 seed: int = 1):
        check_supported(opt_cfg)
        self.device = resolve_device(device)
        params = [p for p in model.parameters() if p.requires_grad]
        if not params:
            raise ValueError("Trainer: the model has no trainable parameters; build it with "
                             "for_training=True")
        if any(p.device.type != self.device.type for p in params):
            raise ValueError(f"Trainer: the model's parameters are not on {self.device}")
        self.model = model
        self.criterion = criterion
        self.opt_cfg = opt_cfg
        self.seed = seed
        self.schedule = build_lr_schedule(opt_cfg)
        self.optimizer = FusedAdamWSkipNonFinite(params, opt_cfg, self.schedule,
                                                 max_consecutive_errors=8)
        self.step = 0  # updates attempted, skipped ones included (the JAX state.step)

    def _to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        out = {}
        for key, val in batch.items():
            t = val if isinstance(val, torch.Tensor) else torch.as_tensor(np.asarray(val))
            out[key] = t.to(self.device, non_blocking=True)
        return out

    def _micro_batches(self, batch):
        accum = self.opt_cfg.update_freq
        if accum == 1:
            return [batch]
        for key, val in batch.items():
            if val.dim() == 0 or val.shape[0] != accum:
                raise ValueError(f"update_freq={accum}: batch[{key!r}] needs a leading axis of "
                                 f"{accum} micro-batches, got shape {tuple(val.shape)}")
        return [{key: val[i] for key, val in batch.items()} for i in range(accum)]

    def _generator(self, step: int, micro: int | None = None) -> torch.Generator:
        """The dropout generator of (step, micro-batch), on the model's device."""
        seed = fold_in(self.seed, step)
        if micro is not None:
            seed = fold_in(seed, micro)
        return torch.Generator(device=self.device).manual_seed(seed)

    def train_step(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        self.model.train()
        for p in self.optimizer.params:
            p.grad = None
        micros = self._micro_batches(self._to_device(batch))
        loss_sum, size_sum, logs_sum = 0.0, 0.0, {}
        for i, micro in enumerate(micros):
            gen = self._generator(self.step, None if len(micros) == 1 else i)
            out = s2t_forward(self.model, micro, train=True, generator=gen)
            loss, sample_size, logs = self.criterion(out, micro)
            loss.float().backward()
            loss_sum = loss_sum + loss.detach().float()
            size_sum = size_sum + torch.as_tensor(sample_size, dtype=torch.float32)
            for key, val in logs.items():
                logs_sum[key] = logs_sum.get(key, 0.0) + val.detach()
        # normalise summed grads / loss by the GLOBAL sample size
        norm = torch.clamp(size_sum.to(self.device), min=1.0)
        gnorm = self.optimizer.step(grad_divisor=norm)
        metrics = {
            **logs_sum,
            "loss": loss_sum / norm,
            "gnorm": gnorm,
            "lr": float(self.schedule(self.step)),
            "sample_size": size_sum,
        }
        self.step += 1
        return metrics

"""Trainer: one training step, forward with dropout -> loss -> backward -> clip ->
AdamW -> non-finite skip, the validation step and the trainer state
(counterpart of s2t_tpu/trainer.py:57-77, 80-375, 227-275 and 644-651, without
the mesh or BMUF).

``Trainer(model, criterion, opt_cfg, device, seed, forward_fn).train_step(batch)``
is the step ``bench.py`` section B drives through the JAX ``Trainer``; the
forward adapter (default ``s2t_forward``; a task's ``forward_fn()`` runs its
feature pipeline first) is called as ``forward_fn(model, batch, train=...,
generator=...)``:

* with ``update_freq`` = n > 1 every batch leaf carries a leading axis of n
  micro-batches; their summed losses are backpropagated one by one and the
  summed gradients and loss are normalised by the GLOBAL sample size
  (trainer.py:351-355) before the global norm is taken;
* the optimizer is ``FusedAdamWSkipNonFinite`` under the LR schedule for Adam
  without ``lr_groups`` and ``SkipNonFiniteChain`` (clip -> optimizer -> the groups'
  factors -> the lr scale, skipped when non-finite) otherwise, as the JAX trainer
  picks (trainer.py:131-143); ``lr_groups`` keys are the flax tree's top-level keys
  of the parameters (``interop/from_flax.flax_path``);
* it returns ``loss``, ``gnorm``, ``lr`` (the schedule at the step count
  before this update, trainer.py:366-369), ``sample_size`` and the
  criterion's logs, all summed over the micro-batches.

Dropout bits come from a ``torch.Generator`` on the model's device seeded
from (seed, step) -- and the micro-batch index when n > 1 -- the counterpart
of ``jax.random.fold_in`` (trainer.py:325, :334), so a step is reproducible.
The model must be built with ``for_training=True`` (float32 master
parameters, compute in ``cfg.dtype``).

With ``quant_noise_p`` > 0 every forward and backward of a step runs on
block-noised copies of the dense kernels and embeddings
(``modules/quant_noise.py``) through ``torch.func.functional_call``; the
optimizer updates the un-noised parameters.  The masks come from a generator
seeded by the step's seed folded with 0x51AE, as JAX folds its key; a
``quant_noise_masks`` dict handed to ``train_step`` replaces the draw.

``valid_step(batch)`` runs the adapter in eval mode without gradients and
returns the summed loss, the sample size and the criterion's logs.
``set_lr_scale(value)`` sets the runtime lr multiplier (reduce_on_plateau).
``state_dict()`` / ``load_state_dict()`` carry the float32 master
parameters, the optimizer's state (both Adam moments, or the chain's), its
counters and lr scale and the step, as host tensors and ints
(``utils/checkpoint.py`` saves them).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from s2t_tpu_torch.config import OptimizationConfig, check_supported
from s2t_tpu_torch.device import resolve_device
from s2t_tpu_torch.modules.quant_noise import quant_noise_params
from s2t_tpu_torch.optim.builders import (
    FusedAdamWSkipNonFinite, SkipNonFiniteChain, build_lr_schedule, group_scales)

_MASK64 = (1 << 64) - 1
QUANT_NOISE_FOLD = 0x51AE  # the JAX step folds its dropout key with this for quant noise


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from (seed, data): splitmix64 of their combination."""
    x = (seed * 0x9E3779B97F4A7C15 + data + 0x632BE59BD9B4E019) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) >> 1


def flax_top_key(model) -> Callable[[str], str]:
    """A parameter name -> the first key of its flax path (``lr_groups``' keys); a
    decoder table tied to a CTC head is flax's top-level ``shared_embed``."""
    from s2t_tpu_torch.interop.from_flax import flax_path

    shared = bool(getattr(getattr(model, "cfg", None), "share_ctc_and_embed", False))
    ndim = {n: p.dim() for n, p in model.named_parameters()}

    def key(name: str) -> str:
        try:
            return flax_path(name, ndim[name], shared)[0]
        except KeyError:
            return name.split(".")[0]

    return key


def s2t_forward(model, batch: Dict[str, torch.Tensor], train: bool = False,
                generator: torch.Generator | None = None) -> Dict[str, Any]:
    """The forward adapter for speech-to-text batches (the JAX trainer's s2t_forward):
    in training it hands the step count to mixup's ratio decay."""
    kw = {}
    if train and getattr(getattr(model, "cfg", None), "inter_mixup_ratio_decay", False) \
            and "_step" in batch:
        kw["num_updates"] = int(batch["_step"])
    return model(batch["features"], batch["feat_lengths"], batch["prev_tokens"],
                 train=train, generator=generator, **kw)


class _Forward(nn.Module):
    """``forward_fn`` over ``model`` as a module, so ``functional_call`` can swap
    the model's parameters for their noised copies for one call."""

    def __init__(self, model, forward_fn):
        super().__init__()
        self.model = model
        self.forward_fn = forward_fn

    def forward(self, batch, train, generator):
        return self.forward_fn(self.model, batch, train=train, generator=generator)


class Trainer:
    def __init__(self, model, criterion, opt_cfg: OptimizationConfig, device="cuda",
                 seed: int = 1, forward_fn: Optional[Callable] = None):
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
        self.forward_fn = forward_fn or s2t_forward
        self.opt_cfg = opt_cfg
        self.seed = seed
        self.schedule = build_lr_schedule(opt_cfg)
        if opt_cfg.optimizer in ("adam", "adamw") and not opt_cfg.lr_groups:
            self.optimizer = FusedAdamWSkipNonFinite(params, opt_cfg, self.schedule,
                                                     max_consecutive_errors=8)
        else:
            scales = None
            if opt_cfg.lr_groups:
                names = [n for n, p in model.named_parameters() if p.requires_grad]
                scales = group_scales(names, opt_cfg.lr_groups, flax_top_key(model))
            self.optimizer = SkipNonFiniteChain(params, opt_cfg, self.schedule, scales,
                                                max_consecutive_errors=8)
        self.step = 0  # updates attempted, skipped ones included (the JAX state.step)

    def _to_device(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        out = {}
        for key, val in batch.items():
            if isinstance(val, dict):  # nested inputs (a zip batch's pairs, handed-over draws)
                out[key] = self._to_device(val)
                continue
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

    def _forward_train(self, micro, gen, quant_noise_masks=None):
        cfg = self.opt_cfg
        if cfg.quant_noise_p <= 0:
            return self.forward_fn(self.model, micro, train=True, generator=gen)
        params = dict(self.model.named_parameters())
        qn_gen = torch.Generator(device=self.device).manual_seed(
            fold_in(gen.initial_seed(), QUANT_NOISE_FOLD))
        noised = quant_noise_params(params, cfg.quant_noise_p, cfg.quant_noise_block_size,
                                    qn_gen, quant_noise_masks)
        return torch.func.functional_call(
            _Forward(self.model, self.forward_fn), {f"model.{k}": v for k, v in noised.items()},
            (micro, True, gen))

    def train_step(self, batch: Dict[str, Any],
                   quant_noise_masks: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Dict[str, torch.Tensor]:
        """One update.  ``quant_noise_masks``: the quant-noise drop masks to use in
        place of this step's draw (parameter name -> bool mask, the port's layout)."""
        self.model.train()
        for p in self.optimizer.params:
            p.grad = None
        micros = self._micro_batches(self._to_device(batch))
        loss_sum, size_sum, logs_sum = 0.0, 0.0, {}
        for i, micro in enumerate(micros):
            gen = self._generator(self.step, None if len(micros) == 1 else i)
            # the update count, for forward adapters with an in-step schedule (trainer.py:316)
            micro = {**micro, "_step": self.step}
            out = self._forward_train(micro, gen, quant_noise_masks)
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

    @torch.no_grad()
    def valid_step(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Loss (summed), sample size and the criterion's logs of one batch in
        eval mode (no dropout, the eval feature transforms)."""
        self.model.eval()
        batch = self._to_device(batch)
        out = self.forward_fn(self.model, batch, train=False, generator=None)
        loss, sample_size, logs = self.criterion(out, batch)
        return {"loss": loss.detach().float(),
                "sample_size": torch.as_tensor(sample_size, dtype=torch.float32), **logs}

    def set_lr_scale(self, value: float) -> None:
        """The runtime lr multiplier of every later update (the JAX ``set_lr_scale``)."""
        self.optimizer.lr_scale = float(value)

    def state_dict(self) -> Dict[str, Any]:
        """Host copies of the master parameters, the optimizer's state and counters
        and the step (the JAX ``TrainState``: step, params, opt_state)."""
        return {
            "step": self.step,
            # one host copy each (.cpu() of a card tensor already copies)
            "params": {k: v.detach().to("cpu", copy=True)
                       for k, v in self.model.state_dict().items()},
            "opt_state": self.optimizer.state_dict(),
        }

    def load_state_dict(self, state: Dict[str, Any], params_only: bool = False) -> None:
        """Restore ``state_dict()``'s output; ``params_only`` keeps the fresh
        optimizer and step (``checkpoint.reset_optimizer``)."""
        self.model.load_state_dict(state["params"], strict=True)
        if params_only:
            return
        self.optimizer.load_state_dict(state["opt_state"])
        self.step = int(state["step"])

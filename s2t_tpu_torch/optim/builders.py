"""LR schedule and optimizer of the training step (counterpart of
s2t_tpu/optim/builders.py:30-45 and :180-269).

Plain PyTorch, as the JAX package leaves this to XLA.  Everything stays on
the device: the schedule is evaluated on the optimizer's count tensor and the
skip decision is a device boolean, so a step never waits for the host.
``torch.optim.AdamW`` has no skip semantics, so the transformation is written
out here.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Union

import torch

from s2t_tpu_torch.config import OptimizationConfig, check_supported


def inverse_sqrt(cfg: OptimizationConfig) -> Callable:
    """Warmup from warmup_init_lr to lr, then lr * sqrt(warmup / step); the
    schedule maps an integer step (int or tensor) to a float32 tensor."""
    warmup = max(cfg.warmup_updates, 1)
    init_lr = cfg.warmup_init_lr if cfg.warmup_init_lr >= 0 else 0.0
    peak = cfg.lr
    decay_factor = peak * math.sqrt(warmup)

    def schedule(step) -> torch.Tensor:
        step = torch.as_tensor(step).clamp(min=1)
        s = step.float()
        warm = init_lr + (peak - init_lr) * s / warmup
        decay = decay_factor * torch.rsqrt(s)
        return torch.where(step < warmup, warm, decay)

    return schedule


def build_lr_schedule(cfg: OptimizationConfig) -> Callable:
    check_supported(cfg)
    return inverse_sqrt(cfg)


class FusedAdamWSkipNonFinite:
    """clip-by-global-norm -> AdamW -> non-finite skip, as one transformation
    (``fused_adamw_skip_nonfinite``):

    * the clip scale min(1, clip / gnorm) comes from the global gradient norm,
      which also decides finiteness;
    * a non-finite norm skips the step: the moments keep their values
      (``where``, not a multiply by 0, so a NaN cannot poison them) and
      neither the Adam count nor the LR schedule advances;
    * after ``max_consecutive_errors`` consecutive bad steps the update is
      applied anyway, so the non-finite values surface;
    * update = -lr * (m_hat / (sqrt(v_hat) + eps) + wd * p), lr = schedule(count)
      at the count before this update.

    The moments are two flat float32 buffers over all parameters; the
    gradients are gathered into one flat buffer per step and the update is
    added back with ``torch._foreach_add_``.
    """

    def __init__(self, params: Iterable[torch.nn.Parameter], cfg: OptimizationConfig,
                 schedule: Callable, max_consecutive_errors: int = 8):
        self.params = [p for p in params if p.requires_grad]
        if not self.params:
            raise ValueError("FusedAdamWSkipNonFinite: no parameter requires grad")
        if any(p.dtype != torch.float32 for p in self.params):
            raise ValueError("FusedAdamWSkipNonFinite: master parameters must be float32")
        dev = self.params[0].device
        self.b1, self.b2 = cfg.adam_betas
        self.eps, self.wd, self.clip = cfg.adam_eps, cfg.weight_decay, cfg.clip_norm
        self.schedule = schedule
        self.max_consecutive_errors = max_consecutive_errors
        n = sum(p.numel() for p in self.params)
        self.mu = torch.zeros(n, dtype=torch.float32, device=dev)
        self.nu = torch.zeros(n, dtype=torch.float32, device=dev)
        self.count = torch.zeros((), dtype=torch.int32, device=dev)  # applied updates
        self.notfinite_count = torch.zeros((), dtype=torch.int32, device=dev)

    def _flat_grads(self) -> torch.Tensor:
        return torch.cat([
            (p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1).float()
            for p in self.params
        ])

    @torch.no_grad()
    def step(self, grad_divisor: Union[torch.Tensor, float, None] = None) -> torch.Tensor:
        """Apply one update from the parameters' ``.grad`` (divided by
        ``grad_divisor`` first).  Returns the global norm of those gradients."""
        g = self._flat_grads()
        if grad_divisor is not None:
            g = g / grad_divisor
        # accumulated in float64: a float32 reduction over the m model's 79M entries
        # is off by 0.2-1 % on the CPU (measured), which moves the clip scale
        gnorm = torch.linalg.vector_norm(g, dtype=torch.float64).float()
        ok = torch.isfinite(gnorm)
        apply_it = ok | (self.notfinite_count >= self.max_consecutive_errors)
        if self.clip > 0:
            g = g * torch.clamp(self.clip / torch.clamp(gnorm, min=1e-12), max=1.0)
        count_new = self.count + apply_it.to(torch.int32)
        # when every step so far was skipped count_new is 0; the lr factor zeroes
        # the update then, and the clamp keeps the bias correction finite
        cf = torch.clamp(count_new, min=1).float()
        bc1 = 1.0 - torch.pow(self.b1, cf)
        bc2 = 1.0 - torch.pow(self.b2, cf)
        lr = self.schedule(self.count) * apply_it.float()
        self.mu.add_((1.0 - self.b1) * torch.where(apply_it, g - self.mu, 0.0))
        self.nu.add_((1.0 - self.b2) * torch.where(apply_it, g * g - self.nu, 0.0))
        adam = (self.mu / bc1) / (torch.sqrt(self.nu / bc2) + self.eps)
        if self.wd:
            adam = adam + self.wd * torch.cat([p.reshape(-1) for p in self.params])
        update = -lr * adam
        sizes = [p.numel() for p in self.params]
        torch._foreach_add_(self.params, [u.view_as(p) for u, p in
                                          zip(update.split(sizes), self.params)])
        self.notfinite_count = torch.where(ok, 0, self.notfinite_count + 1).to(torch.int32)
        self.count = count_new
        return gnorm

"""LR schedules and optimizer of the training step (counterpart of
s2t_tpu/optim/builders.py:30-91 and :180-269): ``inverse_sqrt``, ``cosine``,
``tri_stage``, ``polynomial_decay`` and ``fixed``.

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


def tri_stage(cfg: OptimizationConfig) -> Callable:
    """Linear warm-up to lr, a hold at lr, then an exponential decay to
    max(min_lr, lr / 100); the stages are ``warmup_updates`` (or 10 % of
    max_update when 0), 40 % and the rest of max_update (builders.py:60-75)."""
    total = max(cfg.max_update, 1)
    w = cfg.warmup_updates or int(0.1 * total)
    h = int(0.4 * total)
    d = max(total - w - h, 1)
    peak = cfg.lr
    log_final = math.log(max(cfg.min_lr, peak * 0.01) / peak)

    def schedule(step) -> torch.Tensor:
        s = torch.as_tensor(step).float()
        warm = peak * torch.clamp(s / max(w, 1), max=1.0)
        decay = peak * torch.exp(log_final * torch.clamp((s - w - h) / d, 0.0, 1.0))
        return torch.where(s < w, warm, torch.where(s < w + h, torch.full_like(s, peak), decay))

    return schedule


def polynomial_decay(cfg: OptimizationConfig) -> Callable:
    """``optax.linear_schedule(lr, min_lr, max_update - warmup_updates,
    transition_begin=warmup_updates)`` as JAX builds it (builders.py:78-84): lr
    is HELD through the warm-up, with no ramp (a reference quirk), then falls
    linearly to min_lr."""
    steps = max(cfg.max_update - cfg.warmup_updates, 1)
    begin = max(cfg.warmup_updates, 0)
    init, end = cfg.lr, cfg.min_lr

    def schedule(step) -> torch.Tensor:
        count = torch.clamp(torch.as_tensor(step).float() - begin, 0.0, float(steps))
        return (init - end) * (1.0 - count / steps) + end

    return schedule


def cosine(cfg: OptimizationConfig) -> Callable:
    """``optax.warmup_cosine_decay_schedule`` as JAX builds it (builders.py:48-57):
    a linear warm-up from max(warmup_init_lr, 0) to lr over ``warmup_updates``,
    then a cosine from lr to min_lr over the rest of decay_steps =
    max(max_update, warmup_updates + 1), which counts the warm-up; min_lr after."""
    warm = cfg.warmup_updates
    decay = max(cfg.max_update, warm + 1) - warm
    init, peak, end = max(cfg.warmup_init_lr, 0.0), cfg.lr, cfg.min_lr
    alpha = 0.0 if peak == 0.0 else end / peak

    def schedule(step) -> torch.Tensor:
        s = torch.as_tensor(step).float()
        if warm > 0:
            warm_lr = (init - peak) * (1.0 - torch.clamp(s, 0.0, float(warm)) / warm) + peak
        else:  # optax holds a schedule of no transition steps at its init value
            warm_lr = torch.full_like(s, init)
        c = torch.clamp(s - warm, max=float(decay))
        cos_lr = peak * ((1.0 - alpha) * (0.5 * (1.0 + torch.cos(math.pi * c / decay))) + alpha)
        return torch.where(s < warm, warm_lr, cos_lr)

    return schedule


def fixed(cfg: OptimizationConfig) -> Callable:
    """``optax.constant_schedule(lr)`` (builders.py:89-91)."""
    lr = cfg.lr

    def schedule(step) -> torch.Tensor:
        return torch.full_like(torch.as_tensor(step).float(), lr)

    return schedule


SCHEDULES = {"inverse_sqrt": inverse_sqrt, "tri_stage": tri_stage,
             "polynomial_decay": polynomial_decay, "cosine": cosine, "fixed": fixed}


def build_lr_schedule(cfg: OptimizationConfig) -> Callable:
    check_supported(cfg)
    return SCHEDULES[cfg.lr_scheduler](cfg)


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
    gradients are gathered into one flat buffer per step, the moments move in place
    (``lerp_``) and the update is built in place in that buffer and added back with
    ``torch._foreach_add_``, so a step allocates one flat buffer besides ``m_hat``:
    on the CPU the float32 references of ``chip_smoke.py`` spend their optimizer time
    in memory passes.  A skipped step zeroes the buffer and the rates first, so a NaN
    gradient cannot reach the moments.
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
            g.div_(grad_divisor)
        # accumulated in float64: a float32 reduction over the m model's 79M entries
        # is off by 0.2-1 % on the CPU (measured), which moves the clip scale
        gnorm = torch.linalg.vector_norm(g, dtype=torch.float64).float()
        ok = torch.isfinite(gnorm)
        apply_it = ok | (self.notfinite_count >= self.max_consecutive_errors)
        scale = apply_it.float()
        if self.clip > 0:
            scale = scale * torch.clamp(self.clip / torch.clamp(gnorm, min=1e-12), max=1.0)
        # a skipped step moves nothing: g is 0 there (a fill, not a multiply by 0, so a
        # NaN cannot pass) and so are the moments' rates
        g.mul_(scale).masked_fill_(~apply_it, 0.0)
        count_new = self.count + apply_it.to(torch.int32)
        # when every step so far was skipped count_new is 0; the lr factor zeroes
        # the update then, and the clamp keeps the bias correction finite
        cf = torch.clamp(count_new, min=1).float()
        bc1 = 1.0 - torch.pow(self.b1, cf)
        bc2 = 1.0 - torch.pow(self.b2, cf)
        lr = self.schedule(self.count) * apply_it.float()
        self.mu.lerp_(g, (1.0 - self.b1) * apply_it.float())
        self.nu.lerp_(g.mul_(g), (1.0 - self.b2) * apply_it.float())
        # g's buffer becomes the update: -lr (m_hat / (sqrt(v_hat) + eps) + wd p)
        update = torch.div(self.nu, bc2, out=g).sqrt_().add_(self.eps)
        update = torch.div(self.mu, bc1).div_(update)
        if self.wd:
            update.add_(torch.cat([p.reshape(-1) for p in self.params]), alpha=self.wd)
        update.mul_(-lr)
        sizes = [p.numel() for p in self.params]
        torch._foreach_add_(self.params, [u.view_as(p) for u, p in
                                          zip(update.split(sizes), self.params)])
        self.notfinite_count = torch.where(ok, 0, self.notfinite_count + 1).to(torch.int32)
        self.count = count_new
        return gnorm

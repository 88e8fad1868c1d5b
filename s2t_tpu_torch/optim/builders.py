"""LR schedules and optimizers of the training step (counterpart of
s2t_tpu/optim/builders.py): the schedules ``inverse_sqrt``, ``cosine``,
``tri_stage``, ``polynomial_decay``, ``fixed``, ``reduce_lr_on_plateau`` /
``reduce_on_plateau`` and ``pass_through`` (a constant base), ``manual``
(``lr_milestones``) and ``triangular``; the optimizers ``adam`` / ``adamw``,
``adafactor``, ``adagrad``, ``sgd``, ``nag``, ``adadelta``, ``adamax`` and ``lamb``.

Plain PyTorch, as the JAX package leaves this to XLA.  Everything stays on
the device: a schedule is evaluated on the optimizer's count tensor and the
skip decision is a device boolean, so a step never waits for the host.

Adam without ``lr_groups`` is ``FusedAdamWSkipNonFinite`` (the JAX trainer's fused
path).  Every other optimizer, and Adam with ``lr_groups``, is JAX's generic chain
``skip_nonfinite(clip_by_global_norm -> optimizer -> lr_groups -> lr scale)``
(``SkipNonFiniteChain``): the optimizers are optax 0.2.6's algorithms with optax's
defaults, not ``torch.optim``'s.  The runtime lr scale (``set_lr_scale``, driven by
``ReduceOnPlateau`` from ``cli.train``) multiplies both paths' updates.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
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


def manual(cfg: OptimizationConfig) -> Callable:
    """Piecewise constant: ``lr_milestones`` maps update boundaries to rates; before
    the first boundary the base lr applies (builders.py:113-133)."""
    stones = sorted((int(k), float(v)) for k, v in (cfg.lr_milestones or {0: cfg.lr}).items())
    if stones[0][0] > 0:
        stones = [(0, float(cfg.lr))] + stones

    def schedule(step) -> torch.Tensor:
        s = torch.as_tensor(step).float()
        rate = torch.full_like(s, stones[0][1])
        for bound, r in stones[1:]:
            rate = torch.where(s >= bound, r, rate)
        return rate

    return schedule


def triangular(cfg: OptimizationConfig) -> Callable:
    """Cyclical: between max(min_lr, lr / 100) and lr with period ``warmup_updates``
    * 2 (max_update / 10 when that is 0), at least 2 (builders.py:136-148)."""
    period = max(cfg.warmup_updates * 2 or cfg.max_update // 10, 2)
    lo = max(cfg.min_lr, cfg.lr * 0.01)

    def schedule(step) -> torch.Tensor:
        phase = torch.remainder(torch.as_tensor(step).float(), period) / (period / 2.0)
        tri = torch.where(phase < 1.0, phase, 2.0 - phase)
        return lo + (cfg.lr - lo) * tri

    return schedule


SCHEDULES = {"inverse_sqrt": inverse_sqrt, "tri_stage": tri_stage,
             "polynomial_decay": polynomial_decay, "cosine": cosine, "fixed": fixed,
             # a constant base: the decay is the runtime lr scale (ReduceOnPlateau)
             "reduce_lr_on_plateau": fixed, "reduce_on_plateau": fixed,
             # no schedule of its own: the base lr, scaled by the optimizer
             "pass_through": fixed, "manual": manual, "triangular": triangular}


def build_lr_schedule(cfg: OptimizationConfig) -> Callable:
    check_supported(cfg)
    return SCHEDULES[cfg.lr_scheduler](cfg)


class ReduceOnPlateau:
    """Host-side plateau controller (builders.py:151-178): the scale shrinks by
    ``shrink`` once the validation loss has not improved by ``threshold`` for more
    than ``patience`` validations, down to ``min_scale``; ``step`` returns the
    cumulative scale, which the trainer hands to ``set_lr_scale``."""

    def __init__(self, shrink: float = 0.1, patience: int = 0, threshold: float = 1e-4,
                 min_scale: float = 1e-8):
        self.shrink = shrink
        self.patience = patience
        self.threshold = threshold
        self.min_scale = min_scale
        self.best: Optional[float] = None
        self.bad = 0
        self.scale = 1.0

    def step(self, val: float) -> float:
        if self.best is None or val < self.best - self.threshold:
            self.best = val
            self.bad = 0
        else:
            self.bad += 1
            if self.bad > self.patience:
                self.scale = max(self.scale * self.shrink, self.min_scale)
                self.bad = 0
        return self.scale


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
        self.lr_scale = 1.0  # the runtime lr scale (set_lr_scale)
        self.norm_fn = None  # the global norm over shards (a sharded Trainer sets it)

    def _flat_grads(self) -> torch.Tensor:
        return _flat_grads(self.params)

    def state_dict(self) -> Dict[str, object]:
        return {"mu": self.mu.to("cpu", copy=True), "nu": self.nu.to("cpu", copy=True),
                "count": int(self.count), "notfinite_count": int(self.notfinite_count),
                "lr_scale": self.lr_scale}

    def load_state_dict(self, state: Dict[str, object]) -> None:
        if state["mu"].shape != self.mu.shape:
            raise ValueError(f"optimizer state of {state['mu'].numel()} entries does not fit "
                             f"the model's {self.mu.numel()} parameters")
        dev = self.mu.device
        self.mu.copy_(state["mu"])
        self.nu.copy_(state["nu"])
        self.count = torch.tensor(state["count"], dtype=torch.int32, device=dev)
        self.notfinite_count = torch.tensor(state["notfinite_count"], dtype=torch.int32,
                                            device=dev)
        self.lr_scale = float(state.get("lr_scale", 1.0))

    @torch.no_grad()
    def step(self, grad_divisor: Union[torch.Tensor, float, None] = None) -> torch.Tensor:
        """Apply one update from the parameters' ``.grad`` (divided by
        ``grad_divisor`` first).  Returns the global norm of those gradients."""
        g = self._flat_grads()
        if grad_divisor is not None:
            g.div_(grad_divisor)
        gnorm = global_norm(g, self.norm_fn)
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
        if self.lr_scale != 1.0:
            update.mul_(self.lr_scale)
        sizes = [p.numel() for p in self.params]
        torch._foreach_add_(self.params, [u.view_as(p) for u, p in
                                          zip(update.split(sizes), self.params)])
        self.notfinite_count = torch.where(ok, 0, self.notfinite_count + 1).to(torch.int32)
        self.count = count_new
        return gnorm


def global_norm(g: torch.Tensor, norm_fn: Optional[Callable] = None) -> torch.Tensor:
    """The global norm of the flat gradients, accumulated in float64: a float32
    reduction over the m model's 79M entries is off by 0.2-1 % on the CPU (measured),
    which moves the clip scale.  ``norm_fn``: the sharded Trainer's, which adds the
    shards' squares over their groups (``parallel/tensor_parallel.sharded_norm``)."""
    if norm_fn is not None:
        return norm_fn(g)
    return torch.linalg.vector_norm(g, dtype=torch.float64).float()


def _flat_grads(params: Sequence[torch.nn.Parameter]) -> torch.Tensor:
    """The parameters' gradients as one float32 buffer (a missing one as zeros)."""
    return torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1).float()
                      for p in params])


def _bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    return 1.0 - torch.pow(decay, count.float())


def _factored_dims(shape: Sequence[int], min_dim_size_to_factor: int = 128
                   ) -> Optional[Tuple[int, int]]:
    """optax's choice of the two largest dims to factor over.  The port's layouts
    transpose flax's, which leaves the pair (and the update, symmetric in it) alike."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class _Algorithm:
    """One optimizer of the chain: ``init`` its state, ``update`` the clipped flat
    gradient into the flat update (the lr applied, the sign flipped) and the new state.
    ``count`` is the applied updates before this one; ``lr`` the schedule there."""

    def __init__(self, cfg: OptimizationConfig):
        self.cfg = cfg

    def init(self, flat: torch.Tensor, params: List[torch.Tensor]) -> Dict[str, object]:
        return {}

    def update(self, g, state, flat_params, params, count, lr):
        raise NotImplementedError


class _Adam(_Algorithm):
    """optax.adamw: scale_by_adam -> + wd p -> -lr."""

    def init(self, flat, params):
        return {"mu": torch.zeros_like(flat), "nu": torch.zeros_like(flat)}

    def _scale(self, g, state, count):
        b1, b2 = self.cfg.adam_betas
        mu = torch.lerp(state["mu"], g, 1 - b1)
        nu = torch.lerp(state["nu"], g * g, 1 - b2)
        c = count + 1
        denom = torch.div(nu, _bias_correction(b2, c)).sqrt_().add_(self.cfg.adam_eps)
        return torch.div(mu, _bias_correction(b1, c)).div_(denom), {"mu": mu, "nu": nu}

    def update(self, g, state, flat_params, params, count, lr):
        u, new = self._scale(g, state, count)
        if self.cfg.weight_decay:
            u.add_(flat_params(), alpha=self.cfg.weight_decay)
        return u.mul_(-lr), new


class _Lamb(_Adam):
    """optax.lamb: scale_by_adam -> + wd p -> the trust ratio ||p|| / ||u|| of each
    parameter (1 where either norm is 0) -> -lr."""

    def update(self, g, state, flat_params, params, count, lr):
        u, new = self._scale(g, state, count)
        p = flat_params()
        u.add_(p, alpha=self.cfg.weight_decay)
        sizes = [q.numel() for q in params]
        pn = torch.stack(torch._foreach_norm(list(p.split(sizes))))
        un = torch.stack(torch._foreach_norm(list(u.split(sizes))))
        ratio = torch.where((pn == 0.0) | (un == 0.0), 1.0, pn / un)
        if getattr(self, "_sizes", None) is None:  # one host-to-device copy, at the first step
            self._sizes = torch.tensor(sizes, device=u.device)
        ratio = torch.repeat_interleave(ratio, self._sizes, output_size=u.numel())
        return u.mul_(ratio).mul_(-lr), new


class _Adamax(_Algorithm):
    """optax.adamax: mu as Adam's, nu = max(|g| + eps, b2 nu), mu_hat / nu -> -lr."""

    def init(self, flat, params):
        return {"mu": torch.zeros_like(flat), "nu": torch.zeros_like(flat)}

    def update(self, g, state, flat_params, params, count, lr):
        b1, b2 = self.cfg.adam_betas
        mu = torch.lerp(state["mu"], g, 1 - b1)
        nu = torch.maximum(g.abs().add_(self.cfg.adam_eps), state["nu"] * b2)
        u = torch.div(mu, _bias_correction(b1, count + 1)).div_(nu)
        return u.mul_(-lr), {"mu": mu, "nu": nu}


class _Adagrad(_Algorithm):
    """optax.adagrad: the sum of squares from 0.1, u = g rsqrt(sum + 1e-7) -> -lr."""

    def init(self, flat, params):
        return {"sum_of_squares": torch.full_like(flat, 0.1)}

    def update(self, g, state, flat_params, params, count, lr):
        ss = torch.addcmul(state["sum_of_squares"], g, g)
        u = torch.add(ss, 1e-7).rsqrt_().masked_fill_(ss <= 0, 0.0)
        return u.mul_(g).mul_(-lr), {"sum_of_squares": ss}


class _SGD(_Algorithm):
    def update(self, g, state, flat_params, params, count, lr):
        return g.mul_(-lr), {}


class _Nesterov(_Algorithm):
    """optax.sgd(momentum=0.99, nesterov=True): t = g + 0.99 t, u = g + 0.99 t -> -lr."""

    MOMENTUM = 0.99

    def init(self, flat, params):
        return {"trace": torch.zeros_like(flat)}

    def update(self, g, state, flat_params, params, count, lr):
        t = torch.add(g, state["trace"], alpha=self.MOMENTUM)
        return torch.add(g, t, alpha=self.MOMENTUM).mul_(-lr), {"trace": t}


class _Adadelta(_Algorithm):
    """optax.adadelta (rho 0.9, eps 1e-6): u = sqrt(E[dx^2] + eps) / sqrt(E[g^2] + eps) g."""

    RHO, EPS = 0.9, 1e-6

    def init(self, flat, params):
        return {"e_g": torch.zeros_like(flat), "e_x": torch.zeros_like(flat)}

    def update(self, g, state, flat_params, params, count, lr):
        rho, eps = self.RHO, self.EPS
        e_g = torch.lerp(state["e_g"], g * g, 1 - rho)
        u = torch.add(state["e_x"], eps).sqrt_().div_(torch.add(e_g, eps).sqrt_()).mul_(g)
        e_x = torch.lerp(state["e_x"], u * u, 1 - rho)
        return u.mul_(-lr), {"e_g": e_g, "e_x": e_x}


class _Adafactor(_Algorithm):
    """optax.adafactor with its defaults: factored second moments over the two largest
    dims of a parameter whose second-largest is >= 128 (else a full one), decay
    1 - (count + 1)^-0.8, eps 1e-30; the update clipped to block RMS 1, times lr, times
    the parameter's RMS (at least 1e-3), negated.  The moments are per parameter."""

    DECAY, EPS, MIN_DIM, CLIP, MIN_SCALE = 0.8, 1e-30, 128, 1.0, 1e-3

    def init(self, flat, params):
        state = {"v_row": [], "v_col": [], "v": []}
        for p in params:
            dims = _factored_dims(p.shape, self.MIN_DIM)
            z = torch.zeros((1,), dtype=torch.float32, device=p.device)
            if dims is None:
                state["v_row"].append(z)
                state["v_col"].append(z)
                state["v"].append(torch.zeros(p.shape, dtype=torch.float32, device=p.device))
            else:
                d1, d0 = dims
                shape = list(p.shape)
                state["v_row"].append(torch.zeros(shape[:d0] + shape[d0 + 1:],
                                                  dtype=torch.float32, device=p.device))
                state["v_col"].append(torch.zeros(shape[:d1] + shape[d1 + 1:],
                                                  dtype=torch.float32, device=p.device))
                state["v"].append(z)
        return state

    def update(self, g, state, flat_params, params, count, lr):
        t = (count + 1).float()
        decay = 1.0 - torch.pow(t, -self.DECAY)
        new = {"v_row": [], "v_col": [], "v": []}
        out = []
        for i, (gi, p) in enumerate(zip(g.split([q.numel() for q in params]), params)):
            gi = gi.view(p.shape)
            dims = _factored_dims(p.shape, self.MIN_DIM)
            sq = gi * gi + self.EPS
            if dims is None:
                v = decay * state["v"][i] + (1.0 - decay) * sq
                u = gi * v.pow(-0.5)
                new["v"].append(v)
                new["v_row"].append(state["v_row"][i])
                new["v_col"].append(state["v_col"][i])
            else:
                d1, d0 = dims
                v_row = decay * state["v_row"][i] + (1.0 - decay) * sq.mean(dim=d0)
                v_col = decay * state["v_col"][i] + (1.0 - decay) * sq.mean(dim=d1)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_factor = (v_row / v_row.mean(dim=reduced_d1, keepdim=True)).pow(-0.5)
                u = gi * row_factor.unsqueeze(d0) * v_col.pow(-0.5).unsqueeze(d1)
                new["v_row"].append(v_row)
                new["v_col"].append(v_col)
                new["v"].append(state["v"][i])
            u = u / torch.clamp(torch.sqrt(torch.mean(u * u)) / self.CLIP, min=1.0)
            u = lr * u
            rms = torch.sqrt(torch.mean(p.detach().float() ** 2))
            u = u * torch.where(rms <= self.MIN_SCALE, self.MIN_SCALE, rms)
            out.append(-u.reshape(-1))
        return torch.cat(out), new


ALGORITHMS = {"adam": _Adam, "adamw": _Adam, "lamb": _Lamb, "adamax": _Adamax,
              "adagrad": _Adagrad, "sgd": _SGD, "nag": _Nesterov, "adadelta": _Adadelta,
              "adafactor": _Adafactor}


def _where_tree(keep: torch.Tensor, new, old):
    """``where(keep, new, old)`` over a state tree (dicts and lists of tensors)."""
    if isinstance(new, dict):
        return {k: _where_tree(keep, new[k], old[k]) for k in new}
    if isinstance(new, list):
        return [_where_tree(keep, a, b) for a, b in zip(new, old)]
    return torch.where(keep, new, old)


def group_scales(names: Sequence[str], groups: Dict[str, float],
                 top_key: Callable[[str], str]) -> List[float]:
    """Each parameter's ``lr_groups`` factor by the first key of its flax path
    (1.0 outside every group); a group that names no parameter raises, where JAX
    silently scales nothing (ROADMAP.md section 3)."""
    keys = [top_key(n) for n in names]
    unknown = sorted(set(groups) - set(keys))
    if unknown:
        raise ValueError(f"lr_groups {unknown} match no parameter (top-level keys: "
                         f"{sorted(set(keys))})")
    return [float(groups.get(k, 1.0)) for k in keys]


class SkipNonFiniteChain:
    """``skip_nonfinite(chain(clip_by_global_norm, optimizer, lr_groups, lr scale))``
    (builders.py:272-313, 415-447) over flat float32 buffers (adafactor's moments per
    parameter):

    * the global norm of the gradients decides finiteness; the clip divides by it
      where it is at least ``clip_norm``;
    * a non-finite step keeps every state and the applied-update count (the schedule's
      and the moments' counts in optax) and applies a zero update; after
      ``max_consecutive_errors`` consecutive bad steps the update is applied anyway;
    * each parameter's update is scaled by its ``lr_groups`` factor (0 freezes it)
      and by the runtime lr scale.
    """

    def __init__(self, params: Iterable[torch.nn.Parameter], cfg: OptimizationConfig,
                 schedule: Callable, scales: Optional[List[float]] = None,
                 max_consecutive_errors: int = 8):
        self.params = [p for p in params if p.requires_grad]
        if not self.params:
            raise ValueError("SkipNonFiniteChain: no parameter requires grad")
        if any(p.dtype != torch.float32 for p in self.params):
            raise ValueError("SkipNonFiniteChain: master parameters must be float32")
        dev = self.params[0].device
        self.cfg = cfg
        self.clip = cfg.clip_norm
        self.schedule = schedule
        self.scales = scales
        self.max_consecutive_errors = max_consecutive_errors
        self.algorithm = ALGORITHMS[cfg.optimizer](cfg)
        n = sum(p.numel() for p in self.params)
        self.state = self.algorithm.init(torch.zeros(n, dtype=torch.float32, device=dev),
                                         self.params)
        self.count = torch.zeros((), dtype=torch.int32, device=dev)  # applied updates
        self.notfinite_count = torch.zeros((), dtype=torch.int32, device=dev)
        self.lr_scale = 1.0
        self.norm_fn = None

    def _flat_params(self) -> torch.Tensor:
        return torch.cat([p.detach().reshape(-1) for p in self.params])

    @torch.no_grad()
    def step(self, grad_divisor: Union[torch.Tensor, float, None] = None) -> torch.Tensor:
        """Apply one update from the parameters' ``.grad`` (divided by ``grad_divisor``
        first).  Returns the global norm of those gradients."""
        g = _flat_grads(self.params)
        if grad_divisor is not None:
            g.div_(grad_divisor)
        gnorm = global_norm(g, self.norm_fn)
        ok = torch.isfinite(gnorm)
        apply_it = ok | (self.notfinite_count >= self.max_consecutive_errors)
        if self.clip > 0:  # optax's (g / norm) * clip where the norm reaches clip
            under = gnorm < self.clip
            g.div_(torch.where(under, 1.0, gnorm)).mul_(torch.where(under, 1.0, self.clip))
        lr = self.schedule(self.count)
        update, new = self.algorithm.update(g, self.state, self._flat_params, self.params,
                                            self.count, lr)
        self.state = _where_tree(apply_it, new, self.state)
        sizes = [p.numel() for p in self.params]
        views = list(update.split(sizes))
        if self.scales is not None:
            torch._foreach_mul_(views, self.scales)
        if self.lr_scale != 1.0:
            update.mul_(self.lr_scale)
        update.masked_fill_(~apply_it, 0.0)
        torch._foreach_add_(self.params, [u.view_as(p) for u, p in
                                          zip(update.split(sizes), self.params)])
        self.count = self.count + apply_it.to(torch.int32)
        self.notfinite_count = torch.where(ok, 0, self.notfinite_count + 1).to(torch.int32)
        return gnorm

    def state_dict(self) -> Dict[str, object]:
        def host(t):
            if isinstance(t, dict):
                return {k: host(v) for k, v in t.items()}
            if isinstance(t, list):
                return [host(v) for v in t]
            return t.to("cpu", copy=True)

        return {"optimizer": self.cfg.optimizer, "state": host(self.state),
                "count": int(self.count), "notfinite_count": int(self.notfinite_count),
                "lr_scale": self.lr_scale}

    def load_state_dict(self, state: Dict[str, object]) -> None:
        if state.get("optimizer") != self.cfg.optimizer:
            raise ValueError(f"optimizer state of {state.get('optimizer')!r} does not fit "
                             f"{self.cfg.optimizer!r}")

        def load(dst, src):
            if isinstance(dst, dict):
                return {k: load(dst[k], src[k]) for k in dst}
            if isinstance(dst, list):
                return [load(a, b) for a, b in zip(dst, src)]
            if dst.shape != src.shape:
                raise ValueError(f"optimizer state of shape {tuple(src.shape)} does not fit "
                                 f"{tuple(dst.shape)}")
            return src.to(dst.device, dst.dtype)

        dev = self.count.device
        self.state = load(self.state, state["state"])
        self.count = torch.tensor(state["count"], dtype=torch.int32, device=dev)
        self.notfinite_count = torch.tensor(state["notfinite_count"], dtype=torch.int32,
                                            device=dev)
        self.lr_scale = float(state.get("lr_scale", 1.0))

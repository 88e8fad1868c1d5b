"""BMUF -- Block-Momentum Update Filtering, periodic model averaging (counterpart of
s2t_tpu/optim/bmuf.py).

The Trainer's BMUF mode keeps one replica a data rank: each trains on its own rows
for ``sync_interval`` updates, then the global model absorbs the replicas' averaged
block delta with block momentum and the optional Nesterov lookahead; ``variant:
"slowmo"`` is SlowMo's outer update.  These functions are the sync itself, over dicts
of tensors (parameter name -> tensor).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from s2t_tpu_torch.config import BMUFConfig

__all__ = ["BMUFConfig", "bmuf_init", "bmuf_sync", "bmuf_restart_point"]

Params = Dict[str, torch.Tensor]


def bmuf_init(params: Params) -> Tuple[Params, Params]:
    """(global_params, momentum_buffer): copies of ``params`` and zeros."""
    return ({k: v.detach().clone() for k, v in params.items()},
            {k: torch.zeros_like(v) for k, v in params.items()})


def bmuf_sync(cfg: BMUFConfig, global_params: Params, avg_local_params: Params,
              momentum: Params) -> Tuple[Params, Params]:
    """One block update (s2t_tpu/optim/bmuf.py:39-73):

    bmuf:   m' = bm m + block_lr (1 - bm) (avg - global);  global' = global + m'
    slowmo: m' = bm m + (avg - global);                    global' = global + slowmo_lr m'
    """
    bm, blr = cfg.block_momentum, cfg.block_lr
    slowmo = getattr(cfg, "variant", "bmuf") == "slowmo"
    slr = getattr(cfg, "slowmo_lr", 1.0)
    new_g, new_m = {}, {}
    for k, g in global_params.items():
        drift = avg_local_params[k] - g
        if slowmo:
            m2 = bm * momentum[k] + drift
            new_g[k] = g + slr * m2
        else:
            m2 = bm * momentum[k] + blr * (1.0 - bm) * drift
            new_g[k] = g + m2
        new_m[k] = m2
    return new_g, new_m


def bmuf_restart_point(cfg: BMUFConfig, global_params: Params, momentum: Params) -> Params:
    """Where replicas resume after a sync: NBM looks ahead by bm m."""
    if not cfg.use_nbm:
        return global_params
    return {k: g + cfg.block_momentum * momentum[k] for k, g in global_params.items()}

"""uint8-threshold dropout (counterpart of s2t_tpu/modules/dropout.py:28-69).

Raw uint8 bits are drawn from an explicit ``torch.Generator`` on the
tensor's device and compared with k = min(round(rate * 256), 255): an element
is kept iff its byte is >= k, and kept elements are rescaled by the effective
keep probability 1 / (1 - k/256), so the estimator stays unbiased.

``generator=None`` means "not training": the input comes back unchanged, as
it does for k = 0.  The keep-mask is saved for the backward (the JAX module
regenerates it from its key instead); the bits differ from JAX's by design.

``shard=(dim, index, count)`` marks ``x`` as the index-th of ``count`` equal
contiguous slices along ``dim`` of one tensor split over tensor-parallel ranks:
its bits are that slice of the whole tensor's draw, so the shards draw the
one-device bits (and not each the same bits) and the shared generator advances
alike on every rank.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def threshold_u8(rate: float) -> int:
    """Dropout rate -> the uint8 threshold k (0 means no dropout)."""
    return min(max(int(round(rate * 256)), 0), 255)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            shard: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    if generator is None or rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    k = threshold_u8(rate)
    if k == 0:
        return x
    shape = list(x.shape)
    if shard is not None:
        dim, index, count = shard
        shape[dim] *= count
    bits = torch.randint(0, 256, shape, dtype=torch.uint8, generator=generator, device=x.device)
    if shard is not None:
        bits = bits.narrow(dim, index * x.shape[dim], x.shape[dim])
    return torch.where(bits >= k, x * (1.0 / (1.0 - k / 256.0)), 0.0)

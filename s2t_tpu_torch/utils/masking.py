"""Length/mask helpers (counterpart of s2t_tpu/utils/masking.py).

Convention: a boolean mask rides with every padded tensor, True = valid.
"""

from __future__ import annotations

import torch


def lengths_to_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) int lengths -> (B, max_len) bool mask, True at valid positions."""
    pos = torch.arange(max_len, dtype=lengths.dtype, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def mask_to_lengths(mask: torch.Tensor) -> torch.Tensor:
    """(B, T) valid-mask -> (B,) int32 lengths."""
    return mask.sum(dim=-1, dtype=torch.int32)


def valid_first(mask: torch.Tensor) -> torch.Tensor:
    """(B, T) valid-mask -> (B, T) permutation: each row's valid positions first, then
    the rest, each in order (as ``ops/levenshtein.compact_tokens`` packs tokens)."""
    T = mask.shape[1]
    pos = torch.arange(T, device=mask.device)[None, :]
    return torch.argsort(torch.where(mask, pos, T + pos), dim=1)

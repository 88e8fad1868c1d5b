"""Sinusoidal positions (counterpart of s2t_tpu/modules/positional.py:26)."""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def fairseq_sinusoidal_encoding(max_len: int, dim: int, padding_idx: int = 1) -> torch.Tensor:
    """(max_len, dim) table matching fairseq's SinusoidalPositionalEmbedding:
    [sin | cos] halves with frequency base exp(-log(1e4)/(half-1)), and row i
    is the embedding of the i-th valid token/frame, i.e. absolute position
    padding_idx+1+i.  Computed in float64, returned as float32."""
    half = dim // 2
    freq = np.exp(np.arange(half, dtype=np.float64) * -(np.log(10000.0) / (half - 1)))
    pos = np.arange(padding_idx + 1, max_len + padding_idx + 1, dtype=np.float64)
    ang = pos[:, None] * freq[None, :]
    pe = np.concatenate([np.sin(ang), np.cos(ang)], axis=1)
    if dim % 2 == 1:
        pe = np.pad(pe, ((0, 0), (0, 1)))
    return torch.from_numpy(pe).to(torch.float32)


@lru_cache(maxsize=128)
def sinusoidal_table(T: int, dim: int, padding_idx: int, dtype: torch.dtype,
                     device: torch.device) -> torch.Tensor:
    """``fairseq_sinusoidal_encoding(T, dim, padding_idx)`` in ``dtype`` on
    ``device``, made once per key: a table at the length a call needs, with no
    cap, as the JAX encoders that build theirs per call (PDS stages)."""
    with torch.inference_mode(False):  # a normal tensor, usable by training after a decode
        return fairseq_sinusoidal_encoding(T, dim, padding_idx).to(device=device, dtype=dtype)

"""Sinusoidal, relative and rotary positions (counterpart of
s2t_tpu/modules/positional.py:26-78)."""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def fairseq_sinusoidal_encoding(max_len: int, dim: int, padding_idx: int = 1) -> torch.Tensor:
    """(max_len, dim) table matching fairseq's SinusoidalPositionalEmbedding:
    [sin | cos] halves with frequency base exp(-log(1e4)/(half-1)), and row i
    is the embedding of the i-th valid token/frame, i.e. absolute position
    padding_idx+1+i.  Computed in float64 once per key, returned as a new float32
    tensor."""
    return torch.from_numpy(_sinusoidal_f32(max_len, dim, padding_idx).copy())


@lru_cache(maxsize=32)
def _sinusoidal_f32(max_len: int, dim: int, padding_idx: int) -> np.ndarray:
    half = dim // 2
    freq = np.exp(np.arange(half, dtype=np.float64) * -(np.log(10000.0) / (half - 1)))
    pos = np.arange(padding_idx + 1, max_len + padding_idx + 1, dtype=np.float64)
    ang = pos[:, None] * freq[None, :]
    pe = np.concatenate([np.sin(ang), np.cos(ang)], axis=1)
    if dim % 2 == 1:
        pe = np.pad(pe, ((0, 0), (0, 1)))
    pe = pe.astype(np.float32)
    pe.flags.writeable = False
    return pe


def relative_encoding(max_len: int, dim: int) -> torch.Tensor:
    """(2 max_len - 1, dim) table of the relative positions max_len - 1 ... -(max_len - 1)
    (ESPnet's layout: positive first, descending), sin at even and cos at odd
    columns.  Computed in float64, returned as float32."""
    pos = np.arange(max_len - 1, -max_len, -1, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float64) * -(np.log(10000.0) / dim))
    pe = np.zeros((2 * max_len - 1, dim), dtype=np.float64)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(pe).to(torch.float32)


@lru_cache(maxsize=128)
def sinusoidal_table(T: int, dim: int, padding_idx: int, dtype: torch.dtype,
                     device: torch.device) -> torch.Tensor:
    """``fairseq_sinusoidal_encoding(T, dim, padding_idx)`` in ``dtype`` on
    ``device``, made once per key: a table at the length a call needs, with no
    cap, as the JAX encoders that build theirs per call (PDS stages)."""
    with torch.inference_mode(False):  # a normal tensor, usable by training after a decode
        return fairseq_sinusoidal_encoding(T, dim, padding_idx).to(device=device, dtype=dtype)


@lru_cache(maxsize=128)
def relative_table(T: int, dim: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``relative_encoding(T, dim)`` in ``dtype`` on ``device``, made once per key
    (the JAX encoders build it per call at the call's T)."""
    with torch.inference_mode(False):
        return relative_encoding(T, dim).to(device=device, dtype=dtype)


def rope_tables(max_len: int, head_dim: int, base: float = 10000.0, dtype=torch.float32):
    """(cos, sin) tables of shape (max_len, head_dim // 2): position t, frequency
    base ** (-2i / head_dim), computed in float64 and rounded once to ``dtype``."""
    inv_freq = 1.0 / (base ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    freqs = np.outer(np.arange(max_len, dtype=np.float64), inv_freq)
    return torch.from_numpy(np.cos(freqs)).to(dtype), torch.from_numpy(np.sin(freqs)).to(dtype)


@lru_cache(maxsize=32)
def rope_table(max_len: int, head_dim: int, dtype: torch.dtype, device: torch.device):
    """``rope_tables(max_len, head_dim)`` in ``dtype`` on ``device``, made once per key."""
    with torch.inference_mode(False):
        return tuple(t.to(device) for t in rope_tables(max_len, head_dim, dtype=dtype))


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs (x[..., 0::2], x[..., 1::2]) of x (B, T, H, Dh) by
    the (T, Dh // 2) angles of ``cos`` / ``sin``."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).reshape(x.shape)

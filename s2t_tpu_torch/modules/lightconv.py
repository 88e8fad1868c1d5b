"""Lightweight and dynamic convolutions (counterpart of s2t_tpu/modules/lightconv.py:24-134).

``LightweightConv``: one softmax-normalised kernel of width k per head, shared by
the channels of that head.  ``DynamicConv``: the kernels predicted per position
from the input by ``weight_linear``.  Both pad causally (past only) or centred
(k // 2 on the left), and take one incremental step over a rolling cache of the
k - 1 previous inputs.  The banded depthwise product is a window gather and an
einsum in float32, as in JAX; the kernel weights take ``weight_dropout``.
``LightConvBlock``: linear1 -> GLU -> padded frames zeroed -> the conv -> linear2,
the sublayer that replaces self-attention in an encoder layer.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from s2t_tpu_torch.modules.cast import Linear
from s2t_tpu_torch.modules.dropout import dropout


def unfold_windows(x: torch.Tensor, k: int, causal: bool) -> torch.Tensor:
    """(B, T, C) -> (B, T, k, C) windows: causal window j holds x[t - (k - 1) + j],
    centred window j holds x[t - k // 2 + j], zeros beyond the ends."""
    pad_l = k - 1 if causal else k // 2
    pad_r = 0 if causal else (k - 1) - k // 2
    return F.pad(x, (0, 0, pad_l, pad_r)).unfold(1, k, 1).transpose(2, 3)


def _windows(x, k, causal, cache):
    """The windows of x, or with a ``cache`` (B, k - 1, C) the one window of a step
    (T == 1) and the next cache."""
    if cache is None:
        return unfold_windows(x, k, causal), None
    full = torch.cat([cache, x], dim=1)
    return full[:, None], full[:, 1:]


def _conv(win: torch.Tensor, w: torch.Tensor, heads: int, dtype) -> torch.Tensor:
    """Windows (B, T, k, C) weighted by w, (H, k) or (B, T, H, k), per head."""
    B, T, k, C = win.shape
    wc = win.reshape(B, T, k, heads, C // heads).float()
    eq = "btkhc,hk->bthc" if w.dim() == 2 else "btkhc,bthk->bthc"
    return torch.einsum(eq, wc, w).reshape(B, T, C).to(dtype)


class LightweightConv(nn.Module):
    def __init__(self, dim: int, kernel_size: int, num_heads: int, weight_softmax: bool = True,
                 causal: bool = False, weight_dropout: float = 0.0):
        super().__init__()
        self.kernel_size, self.num_heads = kernel_size, num_heads
        self.weight_softmax, self.causal, self.weight_dropout = weight_softmax, causal, weight_dropout
        self.weight = nn.Parameter(torch.zeros(num_heads, kernel_size))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                cache: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x (B, T, C) -> (out (B, T, C), the next cache or None)."""
        w = self.weight.float()
        if self.weight_softmax:
            w = torch.softmax(w, dim=-1)
        w = dropout(w, self.weight_dropout, generator)
        win, new_cache = _windows(x, self.kernel_size, self.causal, cache)
        return _conv(win, w, self.num_heads, x.dtype), new_cache


class DynamicConv(nn.Module):
    def __init__(self, dim: int, kernel_size: int, num_heads: int, weight_softmax: bool = True,
                 causal: bool = False, weight_dropout: float = 0.0):
        super().__init__()
        self.kernel_size, self.num_heads = kernel_size, num_heads
        self.weight_softmax, self.causal, self.weight_dropout = weight_softmax, causal, weight_dropout
        self.weight_linear = Linear(dim, num_heads * kernel_size, bias=False)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                cache: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        B, T, _ = x.shape
        w = self.weight_linear(x).reshape(B, T, self.num_heads, self.kernel_size).float()
        if self.weight_softmax:
            w = torch.softmax(w, dim=-1)
        w = dropout(w, self.weight_dropout, generator)
        win, new_cache = _windows(x, self.kernel_size, self.causal, cache)
        return _conv(win, w, self.num_heads, x.dtype), new_cache


class LightConvBlock(nn.Module):
    """linear1 -> [GLU] -> padded frames zeroed -> lightweight or dynamic conv -> linear2
    (s2t_tpu/modules/lightconv.py:101-134)."""

    def __init__(self, dim: int, conv_dim: int, kernel_size: int, num_heads: int,
                 conv_type: str = "lightweight", glu: bool = True, causal: bool = False,
                 weight_dropout: float = 0.0):
        super().__init__()
        if conv_type not in ("lightweight", "dynamic"):
            raise ValueError(f"conv type {conv_type!r} not in ('lightweight', 'dynamic')")
        self.glu = glu
        self.linear1 = Linear(dim, 2 * conv_dim if glu else conv_dim)
        conv_cls = LightweightConv if conv_type == "lightweight" else DynamicConv
        self.conv = conv_cls(conv_dim, kernel_size, num_heads, causal=causal,
                             weight_dropout=weight_dropout)
        self.linear2 = Linear(conv_dim, dim)

    def forward(self, x: torch.Tensor, valid_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                cache: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        h = self.linear1(x)
        if self.glu:
            a, b = h.chunk(2, dim=-1)
            h = a * torch.sigmoid(b)
        if valid_mask is not None:
            h = h.masked_fill(~valid_mask[..., None], 0.0)
        h, new_cache = self.conv(h, generator, cache)
        return self.linear2(h), new_cache

"""Transformer encoder/decoder layers (counterpart of s2t_tpu/modules/layers.py:29-450,
the plain attention + FFN layers, pre- or post-norm).

Every LayerNorm uses epsilon 1e-6, flax's default (torch defaults to 1e-5).
Dropout sits where the JAX layers put it: activation dropout inside the FFN
(:41), residual dropout on each sublayer's output (:228, :307 encoder; :412,
:424, :447 decoder), attention dropout in ``MultiHeadAttention``.  Each
``forward`` takes the step's ``generator``; None means no dropout (serving).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from s2t_tpu_torch.modules.attention import MultiHeadAttention
from s2t_tpu_torch.modules.cast import LayerNorm, Linear
from s2t_tpu_torch.modules.dropout import dropout
from s2t_tpu_torch.modules.subsampling import get_activation

LN_EPS = 1e-6


def layer_norm(dim: int) -> nn.LayerNorm:
    return LayerNorm(dim, eps=LN_EPS)


class FeedForward(nn.Module):
    def __init__(self, dim: int, ffn_dim: int, activation: str = "relu",
                 activation_dropout: float = 0.0):
        super().__init__()
        self.fc1 = Linear(dim, ffn_dim)
        self.fc2 = Linear(ffn_dim, dim)
        self.act = get_activation(activation)
        self.activation_dropout = activation_dropout

    def forward(self, x, generator: Optional[torch.Generator] = None):
        h = dropout(self.act(self.fc1(x)), self.activation_dropout, generator)
        return self.fc2(h)


class S2TEncoderLayer(nn.Module):
    """Self-attention then FFN, each with a residual, pre- or post-norm."""

    def __init__(self, dim: int, ffn_dim: int, num_heads: int,
                 activation: str = "relu", normalize_before: bool = True,
                 dropout: float = 0.0, attention_dropout: float = 0.0,
                 activation_dropout: float = 0.0):
        super().__init__()
        self.normalize_before = normalize_before
        self.dropout = dropout
        self.attn_norm = layer_norm(dim)
        self.self_attn = MultiHeadAttention(dim, num_heads, attention_dropout)
        self.ffn_norm = layer_norm(dim)
        self.ffn = FeedForward(dim, ffn_dim, activation, activation_dropout)

    def forward(self, x: torch.Tensor, valid_mask: torch.Tensor,
                attn_bias: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        res = x
        h = self.attn_norm(x) if self.normalize_before else x
        h, _ = self.self_attn(h, h, h, attn_bias, valid_mask=valid_mask, generator=generator)
        x = res + dropout(h, self.dropout, generator)
        if not self.normalize_before:
            x = self.attn_norm(x)
        res = x
        h = self.ffn_norm(x) if self.normalize_before else x
        x = res + dropout(self.ffn(h, generator), self.dropout, generator)
        if not self.normalize_before:
            x = self.ffn_norm(x)
        return x


class TransformerDecoderLayer(nn.Module):
    """Causal self-attention (cacheable) -> cross-attention -> FFN."""

    def __init__(self, dim: int, ffn_dim: int, num_heads: int,
                 activation: str = "relu", normalize_before: bool = True,
                 dropout: float = 0.0, attention_dropout: float = 0.0,
                 activation_dropout: float = 0.0):
        super().__init__()
        self.normalize_before = normalize_before
        self.dropout = dropout
        self.self_attn_norm = layer_norm(dim)
        self.self_attn = MultiHeadAttention(dim, num_heads, attention_dropout)
        self.cross_attn_norm = layer_norm(dim)
        self.cross_attn = MultiHeadAttention(dim, num_heads, attention_dropout)
        self.ffn_norm = layer_norm(dim)
        self.ffn = FeedForward(dim, ffn_dim, activation, activation_dropout)

    def cross_kv(self, encoder_out):
        """Static cross-attention K/V for this layer."""
        return self.cross_attn.project_kv(encoder_out)

    def forward(
        self,
        x: torch.Tensor,
        encoder_out: torch.Tensor,
        self_bias: Optional[torch.Tensor] = None,
        cross_bias: Optional[torch.Tensor] = None,
        cache: Optional[dict] = None,
        cache_index: Optional[int] = None,
        enc_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Optional[dict]]:
        res = x
        h = self.self_attn_norm(x) if self.normalize_before else x
        h, cache = self.self_attn(h, h, h, self_bias, cache=cache, cache_index=cache_index,
                                  generator=generator)
        x = res + dropout(h, self.dropout, generator)
        if not self.normalize_before:
            x = self.self_attn_norm(x)

        res = x
        h = self.cross_attn_norm(x) if self.normalize_before else x
        h, _ = self.cross_attn(h, encoder_out, encoder_out, cross_bias, kv_override=enc_kv,
                               generator=generator)
        x = res + dropout(h, self.dropout, generator)
        if not self.normalize_before:
            x = self.cross_attn_norm(x)

        res = x
        h = self.ffn_norm(x) if self.normalize_before else x
        x = res + dropout(self.ffn(h, generator), self.dropout, generator)
        if not self.normalize_before:
            x = self.ffn_norm(x)
        return x, cache

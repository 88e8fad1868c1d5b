"""Transformer encoder/decoder layers, optionally Conformer (counterpart of
s2t_tpu/modules/layers.py:29-450: the attention + FFN layers, pre- or post-norm,
with the macaron FFN, the convolution module and relative-position attention).

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

from s2t_tpu_torch.modules.attention import (
    MultiHeadAttention, RelPositionMultiHeadAttention, padding_bias)
from s2t_tpu_torch.modules.cast import Conv1d, LayerNorm, Linear
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


class ConformerConvModule(nn.Module):
    """Pointwise conv -> GLU -> depthwise conv -> norm -> activation -> pointwise
    conv -> dropout (s2t_tpu/modules/layers.py:46-107), at stride 1 and the
    input's width.  Padded frames are zeroed before the first pointwise conv
    and before the depthwise conv, so the conv never mixes padding into valid
    frames.  ``norm_type`` "layer_norm", or "batch_norm": the reference's
    BatchNorm1d as a frozen per-channel affine (``norm_scale``, ``norm_bias``)."""

    def __init__(self, dim: int, kernel_size: int = 31, dropout: float = 0.0,
                 norm_type: str = "layer_norm", use_bias: bool = True,
                 activation: str = "swish"):
        super().__init__()
        if norm_type not in ("layer_norm", "batch_norm"):
            raise ValueError(f"conv-module norm {norm_type!r} not in ('layer_norm', 'batch_norm')")
        self.dropout = dropout
        self.pointwise_conv1 = Linear(dim, 2 * dim, bias=use_bias)
        self.depthwise_conv = Conv1d(dim, dim, kernel_size, padding=(kernel_size - 1) // 2,
                                     groups=dim, bias=use_bias)
        if norm_type == "batch_norm":
            self.norm = None
            self.norm_scale = nn.Parameter(torch.ones(dim))
            self.norm_bias = nn.Parameter(torch.zeros(dim))
        else:
            self.norm = layer_norm(dim)
        self.act = get_activation(activation)
        self.pointwise_conv2 = Linear(dim, dim, bias=use_bias)

    def forward(self, x: torch.Tensor, valid_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        pad = ~valid_mask[..., None]
        a, b = self.pointwise_conv1(x.masked_fill(pad, 0.0)).chunk(2, dim=-1)
        h = (a * torch.sigmoid(b)).masked_fill(pad, 0.0)
        h = self.depthwise_conv(h.transpose(1, 2)).transpose(1, 2)
        if self.norm is None:
            h = h * self.norm_scale.to(h.dtype) + self.norm_bias.to(h.dtype)
        else:
            h = self.norm(h)
        return dropout(self.pointwise_conv2(self.act(h)), self.dropout, generator)


class S2TEncoderLayer(nn.Module):
    """[macaron FFN x 1/2] -> self-attention -> [conv module] -> FFN (x 1/2 with
    macaron) -> [final norm with the conv module], each sublayer with a residual,
    pre- or post-norm (s2t_tpu/modules/layers.py:168-322).  ``attention_type``
    "abs" (the fused kernel under a padding-only mask) or "rel_pos" (dense
    relative-position attention over ``pos_emb``).  The conv residual adds the
    module's output with no dropout of its own, as in JAX."""

    def __init__(self, dim: int, ffn_dim: int, num_heads: int,
                 activation: str = "relu", normalize_before: bool = True,
                 dropout: float = 0.0, attention_dropout: float = 0.0,
                 activation_dropout: float = 0.0, attention_type: str = "abs",
                 macaron_style: bool = False, use_cnn_module: bool = False,
                 cnn_kernel: int = 31, conv_activation: str = "swish",
                 conv_norm_type: str = "layer_norm", conv_bias: bool = True):
        super().__init__()
        if attention_type not in ("abs", "rel_pos"):
            raise ValueError(f"encoder attention {attention_type!r} not in ('abs', 'rel_pos')")
        self.normalize_before = normalize_before
        self.dropout = dropout
        self.rel_pos = attention_type == "rel_pos"
        self.ffn_scale = 0.5 if macaron_style else 1.0
        if macaron_style:
            self.macaron_norm = layer_norm(dim)
            self.macaron_ffn = FeedForward(dim, ffn_dim, activation, activation_dropout)
        else:
            self.macaron_norm = self.macaron_ffn = None
        self.attn_norm = layer_norm(dim)
        attn_cls = RelPositionMultiHeadAttention if self.rel_pos else MultiHeadAttention
        self.self_attn = attn_cls(dim, num_heads, attention_dropout)
        if use_cnn_module:
            self.conv_norm = layer_norm(dim)
            self.conv_module = ConformerConvModule(dim, cnn_kernel, dropout, conv_norm_type,
                                                   conv_bias, conv_activation)
            self.final_norm = layer_norm(dim)
        else:
            self.conv_norm = self.conv_module = self.final_norm = None
        self.ffn_norm = layer_norm(dim)
        self.ffn = FeedForward(dim, ffn_dim, activation, activation_dropout)

    def _ffn(self, x, norm, ffn, generator):
        res = x
        h = norm(x) if self.normalize_before else x
        h = dropout(ffn(h, generator), self.dropout, generator)
        x = res + (h if self.ffn_scale == 1.0 else self.ffn_scale * h)
        return x if self.normalize_before else norm(x)

    def forward(self, x: torch.Tensor, valid_mask: torch.Tensor,
                attn_bias: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                pos_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``pos_emb``: the (2T-1, D) relative table, for rel_pos attention."""
        if self.macaron_ffn is not None:
            x = self._ffn(x, self.macaron_norm, self.macaron_ffn, generator)
        res = x
        h = self.attn_norm(x) if self.normalize_before else x
        if self.rel_pos:
            bias = padding_bias(valid_mask, h.dtype) if attn_bias is None else attn_bias
            h = self.self_attn(h, pos_emb, bias, generator)
        else:
            h, _ = self.self_attn(h, h, h, attn_bias, valid_mask=valid_mask, generator=generator)
        x = res + dropout(h, self.dropout, generator)
        if not self.normalize_before:
            x = self.attn_norm(x)
        if self.conv_module is not None:
            res = x
            h = self.conv_norm(x) if self.normalize_before else x
            x = res + self.conv_module(h, valid_mask, generator)
            if not self.normalize_before:
                x = self.conv_norm(x)
        x = self._ffn(x, self.ffn_norm, self.ffn, generator)
        if self.final_norm is not None:
            x = self.final_norm(x)
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

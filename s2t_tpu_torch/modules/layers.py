"""Transformer encoder/decoder layers, optionally Conformer (counterpart of
s2t_tpu/modules/layers.py:29-450: the attention + FFN layers, pre- or post-norm,
with the macaron FFN, the strided / widening convolution module, every
self-attention type of the JAX layer and the convolutions in its place, and the
dual / multibranch models' cross-stream "league" attention in both layers).

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
    ATTENTION_TYPES, MultiHeadAttention, RelPositionMultiHeadAttention, padding_bias)
from s2t_tpu_torch.modules.cast import LN_EPS, Conv1d, LayerNorm, Linear
from s2t_tpu_torch.modules.dropout import dropout
from s2t_tpu_torch.modules.lightconv import LightConvBlock
from s2t_tpu_torch.modules.subsampling import get_activation


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
        # (index, count): tensor-parallel rank index's 1 / count of the hidden units
        # (set by ``parallel.tensor_parallel``); its dropout bits are that slice's
        self.shard: Optional[Tuple[int, int]] = None

    def forward(self, x, generator: Optional[torch.Generator] = None):
        h = dropout(self.act(self.fc1(x)), self.activation_dropout, generator,
                    None if self.shard is None else (-1, *self.shard))
        return self.fc2(h)


class ConformerConvModule(nn.Module):
    """Pointwise conv -> GLU -> depthwise conv -> norm -> activation -> pointwise
    conv -> dropout (s2t_tpu/modules/layers.py:46-107).  Padded frames are zeroed
    before the first pointwise conv and before the depthwise conv, so the conv
    never mixes padding into valid frames.  ``out_dim`` (0: the input's width)
    widens the module from the first pointwise conv on; a depthwise ``stride``
    above 1 gives T' = (T - 1) // stride + 1 frames, whose padding is zeroed
    again (the caller shrinks the lengths the same way).  ``norm_type``
    "layer_norm", or "batch_norm": the reference's BatchNorm1d as a frozen
    per-channel affine (``norm_scale``, ``norm_bias``)."""

    def __init__(self, dim: int, kernel_size: int = 31, dropout: float = 0.0,
                 norm_type: str = "layer_norm", use_bias: bool = True,
                 activation: str = "swish", out_dim: int = 0, stride: int = 1):
        super().__init__()
        if norm_type not in ("layer_norm", "batch_norm"):
            raise ValueError(f"conv-module norm {norm_type!r} not in ('layer_norm', 'batch_norm')")
        D = out_dim or dim
        self.dropout = dropout
        self.stride = stride
        self.pointwise_conv1 = Linear(dim, 2 * D, bias=use_bias)
        self.depthwise_conv = Conv1d(D, D, kernel_size, stride, padding=(kernel_size - 1) // 2,
                                     groups=D, bias=use_bias)
        if norm_type == "batch_norm":
            self.norm = None
            self.norm_scale = nn.Parameter(torch.ones(D))
            self.norm_bias = nn.Parameter(torch.zeros(D))
        else:
            self.norm = layer_norm(D)
        self.act = get_activation(activation)
        self.pointwise_conv2 = Linear(D, D, bias=use_bias)

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
        h = self.pointwise_conv2(self.act(h))
        if self.stride > 1:
            h = h.masked_fill(~valid_mask[:, ::self.stride, None], 0.0)
        return dropout(h, self.dropout, generator)


# the encoder layer's self-attention types: MultiHeadAttention's, rel_pos and the convolutions
ENCODER_ATTENTION_TYPES = ATTENTION_TYPES + ("rel_pos", "light", "dynamic")
# the cross-stream "league" of the dual / multibranch layers
LEAGUE_MODES = ("none", "parallel", "serial")


class S2TEncoderLayer(nn.Module):
    """[macaron FFN x 1/2] -> self-attention -> [conv module] -> FFN (x 1/2 with
    macaron) -> [final norm with the conv module], each sublayer with a residual,
    pre- or post-norm (s2t_tpu/modules/layers.py:168-322).  ``attention_type``:
    "abs" or "rope" (the fused kernel under a padding-only mask), "relative" /
    "local" (``MultiHeadAttention``'s dense Shaw and Gaussian types; ``attention_stride``
    strides the keys), "rel_pos" (dense relative-position attention over ``pos_emb``),
    or "light" / "dynamic" (a ``LightConvBlock`` of width ``lconv_kernel`` in its
    place).  The conv residual adds the module's output with no dropout of its own,
    as in JAX.  ``conv_expand_dim`` / ``conv_stride``: the conv module widens and
    strides the stream, its residual goes through the strided ``conv_res`` projection
    (or is strided), and the FFN and norms after it run at the new width; the caller
    shrinks the lengths.  ``macaron_ffn_dim`` (0: ``ffn_dim``) is the macaron FFN's
    hidden width.  ``use_se``: the squeeze-excitation gate after the FFN, x *
    sigmoid(fc2(relu(fc1(mean of the valid frames)))) with fc1 to max(dim // 16, 1)
    (s2t_tpu/modules/layers.py:311-317)."""

    def __init__(self, dim: int, ffn_dim: int, num_heads: int,
                 activation: str = "relu", normalize_before: bool = True,
                 dropout: float = 0.0, attention_dropout: float = 0.0,
                 activation_dropout: float = 0.0, attention_type: str = "abs",
                 macaron_style: bool = False, use_cnn_module: bool = False,
                 cnn_kernel: int = 31, conv_activation: str = "swish",
                 conv_norm_type: str = "layer_norm", conv_bias: bool = True,
                 attention_stride: int = 1, max_relative_length: int = 0,
                 gauss_mask_sigma: float = 0.0, init_mask_weight: float = 0.5,
                 lconv_kernel: int = 15, conv_expand_dim: int = 0, conv_stride: int = 1,
                 macaron_ffn_dim: int = 0, collaboration_mode: str = "none",
                 league_s1_ratio: float = 0.5, league_s2_ratio: float = 0.5,
                 s2_apply_norm: bool = False, use_se: bool = False):
        super().__init__()
        if attention_type not in ENCODER_ATTENTION_TYPES:
            raise ValueError(f"encoder attention {attention_type!r} not in "
                             f"{ENCODER_ATTENTION_TYPES}")
        self.normalize_before = normalize_before
        self.dropout = dropout
        self.attention_type = attention_type
        self.ffn_scale = 0.5 if macaron_style else 1.0
        if macaron_style:
            self.macaron_norm = layer_norm(dim)
            self.macaron_ffn = FeedForward(dim, macaron_ffn_dim or ffn_dim, activation,
                                           activation_dropout)
        else:
            self.macaron_norm = self.macaron_ffn = None
        self.attn_norm = layer_norm(dim)
        if attention_type in ("light", "dynamic"):
            self.self_attn = LightConvBlock(
                dim, dim, lconv_kernel, num_heads,
                "lightweight" if attention_type == "light" else "dynamic",
                weight_dropout=attention_dropout)
        elif attention_type == "rel_pos":
            self.self_attn = RelPositionMultiHeadAttention(dim, num_heads, attention_dropout)
        else:
            self.self_attn = MultiHeadAttention(
                dim, num_heads, attention_dropout, attention_type, attention_stride,
                max_relative_length, gauss_mask_sigma, init_mask_weight)
        if collaboration_mode not in LEAGUE_MODES:
            raise ValueError(f"collaboration_mode {collaboration_mode!r} not in {LEAGUE_MODES}")
        self.collaboration_mode = collaboration_mode
        self.league_ratios = (league_s1_ratio, league_s2_ratio)
        # the league's modules exist only where a second stream arrives (flax
        # creates them at the first call that passes one)
        if collaboration_mode != "none":
            self.s2_norm = layer_norm(dim) if s2_apply_norm else None
            self.s2_attn = MultiHeadAttention(dim, num_heads, attention_dropout)
            self.s2_attn_norm = layer_norm(dim) if collaboration_mode == "serial" else None
        out_dim = dim
        self.conv_stride = conv_stride
        self.conv_res = None
        if use_cnn_module:
            out_dim = conv_expand_dim or dim
            # one norm, called on the input (pre-norm) or on the widened sum (post-norm)
            self.conv_norm = layer_norm(dim if normalize_before else out_dim)
            self.conv_module = ConformerConvModule(dim, cnn_kernel, dropout, conv_norm_type,
                                                   conv_bias, conv_activation, out_dim,
                                                   conv_stride)
            if out_dim != dim:
                self.conv_res = Linear(dim, out_dim)
            self.final_norm = layer_norm(out_dim)
        else:
            self.conv_norm = self.conv_module = self.final_norm = None
        self.ffn_norm = layer_norm(out_dim)
        self.ffn = FeedForward(out_dim, ffn_dim, activation, activation_dropout)
        if use_se:
            self.se_fc1 = Linear(dim, max(dim // 16, 1), bias=False)
            self.se_fc2 = Linear(max(dim // 16, 1), dim, bias=False)
        else:
            self.se_fc1 = self.se_fc2 = None

    def _ffn(self, x, norm, ffn, generator):
        res = x
        h = norm(x) if self.normalize_before else x
        h = dropout(ffn(h, generator), self.dropout, generator)
        x = res + (h if self.ffn_scale == 1.0 else self.ffn_scale * h)
        return x if self.normalize_before else norm(x)

    def forward(self, x: torch.Tensor, valid_mask: torch.Tensor,
                attn_bias: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                pos_emb: Optional[torch.Tensor] = None,
                s2: Optional[torch.Tensor] = None,
                s2_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``attn_bias``: an additive bias beyond padding (a window), or None;
        ``pos_emb``: the (2T-1, D) relative table, for rel_pos attention; ``s2``
        (B, T2, D) and its padding bias ``s2_bias``: the second stream the league
        attends (s2t_tpu/modules/layers.py:233-256), densely, from the normed
        input beside the self-attention ("parallel": s1 r1 + s2 r2 before the one
        residual, and no post-norm after it, as in JAX) or in a pre-norm block of
        its own after it ("serial")."""
        if self.macaron_ffn is not None:
            x = self._ffn(x, self.macaron_norm, self.macaron_ffn, generator)
        res = x
        h = self.attn_norm(x) if self.normalize_before else x
        if self.attention_type in ("light", "dynamic"):
            h, _ = self.self_attn(h, valid_mask, generator)
        elif self.attention_type == "rel_pos":
            bias = padding_bias(valid_mask, h.dtype) if attn_bias is None else attn_bias
            h = self.self_attn(h, pos_emb, bias, generator)
        else:
            h, _ = self.self_attn(h, h, h, attn_bias, valid_mask=valid_mask, generator=generator)
        h = dropout(h, self.dropout, generator)
        mode = self.collaboration_mode if s2 is not None else "none"
        if mode == "parallel":
            h2 = self._s2_attend(self.attn_norm(res) if self.normalize_before else res, s2,
                                 s2_bias, generator)
            r1, r2 = self.league_ratios
            x = res + (h * r1 + h2 * r2)
        else:
            x = res + h
            if not self.normalize_before:
                x = self.attn_norm(x)
            if mode == "serial":
                x = x + self._s2_attend(self.s2_attn_norm(x), s2, s2_bias, generator)
        if self.conv_module is not None:
            res = x
            h = self.conv_norm(x) if self.normalize_before else x
            h = self.conv_module(h, valid_mask, generator)
            s = self.conv_stride
            if self.conv_res is not None:
                res = self.conv_res(res[:, ::s])
            elif s > 1:
                res = res[:, ::s]
            x = res + h
            if not self.normalize_before:
                x = self.conv_norm(x)
        x = self._ffn(x, self.ffn_norm, self.ffn, generator)
        if self.se_fc1 is not None:
            m = valid_mask[..., None].to(x.dtype)
            pooled = (x * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
            g = self.se_fc2(torch.relu(self.se_fc1(pooled)))
            x = x * torch.sigmoid(g)[:, None, :]
        if self.final_norm is not None:
            x = self.final_norm(x)
        return x


    def _s2_attend(self, h, s2, s2_bias, generator):
        s2v = self.s2_norm(s2) if self.s2_norm is not None else s2
        out, _ = self.s2_attn(h, s2v, s2v, s2_bias, generator=generator)
        return dropout(out, self.dropout, generator)


class TransformerDecoderLayer(nn.Module):
    """Causal self-attention (cacheable; "abs" or Shaw "relative", whose query
    position in a decode step is the step's index) -> cross-attention (none in a
    decoder-only LM, ``has_cross_attention=False``; over an encoder of width
    ``encoder_dim``, 0 for the decoder's own) -> FFN."""

    def __init__(self, dim: int, ffn_dim: int, num_heads: int,
                 activation: str = "relu", normalize_before: bool = True,
                 dropout: float = 0.0, attention_dropout: float = 0.0,
                 activation_dropout: float = 0.0, self_attn_type: str = "abs",
                 max_relative_length: int = 0, has_cross_attention: bool = True,
                 collaboration_mode: str = "none", league_s1_ratio: float = 0.5,
                 league_s2_ratio: float = 0.5, encoder_dim: int = 0):
        super().__init__()
        if collaboration_mode not in LEAGUE_MODES:
            raise ValueError(f"collaboration_mode {collaboration_mode!r} not in {LEAGUE_MODES}")
        self.normalize_before = normalize_before
        self.dropout = dropout
        self.self_attn_norm = layer_norm(dim)
        self.self_attn = MultiHeadAttention(dim, num_heads, attention_dropout, self_attn_type,
                                            max_relative_length=max_relative_length)
        self.has_cross_attention = has_cross_attention
        if has_cross_attention:
            self.cross_attn_norm = layer_norm(dim)
            self.cross_attn = MultiHeadAttention(dim, num_heads, attention_dropout,
                                                 kv_dim=encoder_dim)
        # the second stream's cross-attention (s2t_tpu/models/transformer_decoder.py:343-380)
        self.collaboration_mode = collaboration_mode if has_cross_attention else "none"
        self.league_ratios = (league_s1_ratio, league_s2_ratio)
        if self.collaboration_mode != "none":
            self.s2_cross_attn = MultiHeadAttention(dim, num_heads, attention_dropout)
            self.s2_cross_norm = layer_norm(dim) if collaboration_mode == "serial" else None
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
        cache_ancestry: Optional[torch.Tensor] = None,
        s2_out: Optional[torch.Tensor] = None,
        s2_bias: Optional[torch.Tensor] = None,
        self_valid: Optional[torch.Tensor] = None,
        self_key_order: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Optional[dict]]:
        """``s2_out`` / ``s2_bias``: a second encoder stream and its padding bias,
        cross-attended beside the first ("parallel", no post-norm after the
        combined residual) or after it in a pre-norm block ("serial").
        ``self_valid`` in place of ``self_bias``: a non-causal self-attention under
        a pure padding mask (the fused kernel's case), its keys taken in
        ``self_key_order`` (``valid_first``) where the mask need not be a prefix."""
        x, cache, _ = self._forward(x, encoder_out, self_bias, cross_bias, cache, cache_index,
                                    enc_kv, generator, cache_ancestry, s2_out, s2_bias,
                                    self_valid, self_key_order)
        return x, cache

    def forward_with_attn(self, x, encoder_out, self_bias=None, cross_bias=None,
                          generator: Optional[torch.Generator] = None,
                          self_valid: Optional[torch.Tensor] = None,
                          self_key_order: Optional[torch.Tensor] = None,
                          s2_out: Optional[torch.Tensor] = None,
                          s2_bias: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """A teacher-forced ``forward``: (output, the cross-attention's (B, H, U, S)
        probabilities before dropout)."""
        x, _, attn = self._forward(x, encoder_out, self_bias, cross_bias, generator=generator,
                                   s2_out=s2_out, s2_bias=s2_bias, self_valid=self_valid,
                                   self_key_order=self_key_order, need_attn=True)
        return x, attn

    def _forward(self, x, encoder_out, self_bias=None, cross_bias=None, cache=None,
                 cache_index=None, enc_kv=None, generator=None, cache_ancestry=None,
                 s2_out=None, s2_bias=None, self_valid=None, self_key_order=None,
                 need_attn: bool = False):
        """``forward``'s body: (output, cache, the cross-attention's probabilities when
        ``need_attn``, else None)."""
        attn = None
        res = x
        h = self.self_attn_norm(x) if self.normalize_before else x
        h, cache = self.self_attn(h, h, h, self_bias, cache=cache, cache_index=cache_index,
                                  generator=generator, cache_ancestry=cache_ancestry,
                                  valid_mask=self_valid, key_order=self_key_order)
        x = res + dropout(h, self.dropout, generator)
        if not self.normalize_before:
            x = self.self_attn_norm(x)

        if self.has_cross_attention:
            res = x
            h = self.cross_attn_norm(x) if self.normalize_before else x
            cross_in = h
            if need_attn:
                h, attn = self.cross_attn.forward_with_weights(h, encoder_out, encoder_out,
                                                               cross_bias, generator)
            else:
                h, _ = self.cross_attn(h, encoder_out, encoder_out, cross_bias,
                                       kv_override=enc_kv, generator=generator)
            h = dropout(h, self.dropout, generator)
            mode = self.collaboration_mode if s2_out is not None else "none"
            if mode == "parallel":
                h2, _ = self.s2_cross_attn(cross_in, s2_out, s2_out, s2_bias, generator=generator)
                r1, r2 = self.league_ratios
                x = res + (h * r1 + dropout(h2, self.dropout, generator) * r2)
            else:
                x = res + h
                if not self.normalize_before:
                    x = self.cross_attn_norm(x)
                if mode == "serial":
                    h2, _ = self.s2_cross_attn(self.s2_cross_norm(x), s2_out, s2_out, s2_bias,
                                               generator=generator)
                    x = x + dropout(h2, self.dropout, generator)

        res = x
        h = self.ffn_norm(x) if self.normalize_before else x
        x = res + dropout(self.ffn(h, generator), self.dropout, generator)
        if not self.normalize_before:
            x = self.ffn_norm(x)
        return x, cache, attn

"""Streaming speech encoder: Emformer-style block processing
(counterpart of s2t_tpu/models/streaming.py).

The subsampled frames are cut into segments of ``segment_size`` frames, each
with ``right_context`` lookahead frames.  In every layer a segment attends to
[memory | left context | itself and its lookahead]: ``max_memory_size``
summaries of past segments (the masked mean of each segment's output frames,
through tanh with ``memory_tanh``) and the last ``left_context`` input frames
of the layer.  The layer's query is its normed input, the keys and values are
[memory | left | normed input] (the memory and left frames un-normed, as in
JAX), and the attention is cross-attention with Tq != Tk, dense as in JAX, with
``attention_std_scale``'s suppression of weak keys.  Then a pre-norm FFN.

``forward`` runs the segments one after the other with carried state (JAX's
``nn.scan``), ``init_stream_state`` and ``_process_segment`` step a stream by
hand, and ``streaming_step`` subsamples one raw-feature segment and returns its
CTC logits and the new state.  The model is encoder-only: its CTC head trains
through the CTC criterion (K3 / K4) and decodes through ``CTCGenerator``.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from s2t_tpu_torch.device import resolve_device, torch_dtype
from s2t_tpu_torch.models.s2t_transformer import init_and_place, seeded_init
from s2t_tpu_torch.modules.attention import NEG, MultiHeadAttention
from s2t_tpu_torch.modules.ctc_head import CTCHead
from s2t_tpu_torch.modules.dropout import dropout
from s2t_tpu_torch.modules.layers import FeedForward, layer_norm
from s2t_tpu_torch.modules.subsampling import Conv1dSubsampling
from s2t_tpu_torch.registry import register_model, register_model_architecture
from s2t_tpu_torch.utils.masking import lengths_to_mask


@dataclass(frozen=True)
class EmformerConfig:
    input_feat_per_channel: int = 80
    input_channels: int = 1
    subsampling_layers: int = 2
    subsampling_filter: int = 1024
    subsampling_kernel: int = 5
    subsampling_stride: int = 2
    encoder_embed_dim: int = 256
    encoder_ffn_embed_dim: int = 2048
    encoder_layers: int = 12
    encoder_attention_heads: int = 4
    segment_size: int = 16
    left_context: int = 8
    right_context: int = 4
    max_memory_size: int = 8
    memory_tanh: bool = False
    attention_std_scale: float = 0.0
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.1  # read by nothing, as in JAX
    activation_fn: str = "relu"
    use_ctc: bool = True
    vocab_size: int = 1000
    src_vocab_size: int = -1
    max_source_positions: int = 6000
    max_target_positions: int = 1024
    pad_id: int = 1
    decoder_layers: int = 0
    dtype_str: str = "float32"

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype_str)

    @property
    def ctc_vocab_size(self) -> int:
        return self.src_vocab_size if self.src_vocab_size > 0 else self.vocab_size


class EmformerLayer(nn.Module):
    """One streaming layer: the segment attends [memory | left | segment + lookahead]
    (streaming.py:81-135)."""

    def __init__(self, dim: int, ffn_dim: int, num_heads: int, dropout_rate: float = 0.1,
                 attention_dropout: float = 0.1, activation: str = "relu",
                 memory_tanh: bool = False, attention_std_scale: float = 0.0):
        super().__init__()
        self.dropout = dropout_rate
        self.memory_tanh = memory_tanh
        self.self_attn = MultiHeadAttention(dim, num_heads, attention_dropout,
                                            attention_std_scale=attention_std_scale)
        self.attn_norm = layer_norm(dim)
        self.ffn = FeedForward(dim, ffn_dim, activation, 0.0)
        self.ffn_norm = layer_norm(dim)

    def forward(self, seg, state, seg_valid, generator=None):
        mem, left = state["memory"], state["left"]
        kv_valid = torch.cat([state["memory_valid"], state["left_valid"], seg_valid], dim=1)
        bias = torch.where(kv_valid[:, None, None, :], 0.0, NEG).to(seg.dtype)
        h = self.attn_norm(seg)
        hk = torch.cat([mem, left, h], dim=1)
        h, _ = self.self_attn(h, hk, hk, bias, generator=generator)
        x = seg + dropout(h, self.dropout, generator)
        h = self.ffn(self.ffn_norm(x), generator)
        return x + dropout(h, self.dropout, generator)

    @staticmethod
    def update_state(state, seg_out, seg_in, seg_valid, S: int, tanh: bool = False):
        """Roll the left context and the memory forward with this segment's S frames:
        the left context keeps the layer's input, a memory slot the masked mean of its
        output (streaming.py:138-165)."""
        valid_main = seg_valid[:, :S]
        L = state["left"].shape[1]
        left = torch.cat([state["left"], seg_in[:, :S]], dim=1)[:, -L:]
        left_valid = torch.cat([state["left_valid"], valid_main], dim=1)[:, -L:]
        m = valid_main[..., None].to(seg_out.dtype)
        summary = (seg_out[:, :S] * m).sum(dim=1, keepdim=True) / torch.clamp(
            m.sum(dim=1, keepdim=True), min=1.0)
        if tanh:
            summary = torch.tanh(summary)
        has = valid_main.any(dim=1, keepdim=True)
        return {"memory": torch.cat([state["memory"], summary], dim=1)[:, 1:],
                "memory_valid": torch.cat([state["memory_valid"], has], dim=1)[:, 1:],
                "left": left, "left_valid": left_valid}


@register_model("emformer")
class EmformerModel(nn.Module):
    """Streaming CTC encoder: ``forward(features, feat_lengths, prev_tokens, train,
    generator)`` -> {"encoder_out", "encoder_lengths", "ctc_logits", ...,
    "decoder_logits": None}; ``encode``; ``streaming_step``."""

    @seeded_init
    def __init__(self, cfg: EmformerConfig, device="cuda", seed: int = 0,
                 for_training: bool = False):
        super().__init__()
        self.cfg = cfg
        D = cfg.encoder_embed_dim
        self.subsample = Conv1dSubsampling(
            cfg.input_feat_per_channel * cfg.input_channels, cfg.subsampling_layers,
            cfg.subsampling_filter, D, cfg.subsampling_kernel, cfg.subsampling_stride,
            "glu", "none", True)
        self.layers = nn.ModuleList([
            EmformerLayer(D, cfg.encoder_ffn_embed_dim, cfg.encoder_attention_heads,
                          cfg.dropout, cfg.attention_dropout, cfg.activation_fn,
                          cfg.memory_tanh, cfg.attention_std_scale)
            for _ in range(cfg.encoder_layers)])
        self.final_norm = layer_norm(D)
        self.ctc_head = CTCHead(D, cfg.ctc_vocab_size, dropout=cfg.dropout) if cfg.use_ctc \
            else None
        init_and_place(self, cfg, resolve_device(device), seed, for_training)

    @property
    def device(self) -> torch.device:
        return self.final_norm.weight.device

    def init_stream_state(self, batch_size: int) -> List[Dict[str, torch.Tensor]]:
        cfg = self.cfg
        D, L, M = cfg.encoder_embed_dim, cfg.left_context, cfg.max_memory_size
        kw = {"device": self.device}
        return [{"memory": torch.zeros((batch_size, M, D), dtype=cfg.dtype, **kw),
                 "memory_valid": torch.zeros((batch_size, M), dtype=torch.bool, **kw),
                 "left": torch.zeros((batch_size, L, D), dtype=cfg.dtype, **kw),
                 "left_valid": torch.zeros((batch_size, L), dtype=torch.bool, **kw)}
                for _ in self.layers]

    def _process_segment(self, seg, seg_valid, states, generator=None):
        """One segment (B, S + R, D) through every layer -> (output, new states)."""
        S = self.cfg.segment_size
        new_states, x = [], seg
        for layer, st in zip(self.layers, states):
            y = layer(x, st, seg_valid, generator)
            new_states.append(EmformerLayer.update_state(st, y, x, seg_valid, S,
                                                         layer.memory_tanh))
            x = y
        return x, new_states

    def _subsample(self, features, lengths):
        cfg = self.cfg
        x, lengths = self.subsample(features.to(cfg.dtype), lengths)
        return x * torch.tensor(math.sqrt(cfg.encoder_embed_dim), dtype=x.dtype), lengths

    def _head(self, x, generator=None):
        return self.ctc_head(x, generator=generator) if self.ctc_head is not None else None

    def forward(self, features, feat_lengths, prev_tokens=None, train: bool = False,
                generator: Optional[torch.Generator] = None, **unused) -> Dict[str, Any]:
        cfg = self.cfg
        if train and generator is None:
            raise ValueError("train=True needs the step's torch.Generator")
        generator = generator if train else None
        x, lengths = self._subsample(features, feat_lengths)
        x = dropout(x, cfg.dropout, generator)
        B, T, D = x.shape
        S, R = cfg.segment_size, cfg.right_context
        n_seg = -(-T // S)
        pad_T = n_seg * S + R
        xp = F.pad(x, (0, 0, 0, pad_T - T))
        valid = lengths_to_mask(lengths, pad_T)
        states = self.init_stream_state(B)
        outs = []
        for i in range(n_seg):
            y, states = self._process_segment(xp[:, i * S:i * S + S + R],
                                              valid[:, i * S:i * S + S + R], states, generator)
            outs.append(y[:, :S])
        x = self.final_norm(torch.cat(outs, dim=1)[:, :T])
        return {"encoder_out": x, "encoder_lengths": lengths, "ctc_logits": self._head(x, generator),
                "inter_ctc_logits": (), "xctc_logits": None, "inter_xctc_logits": (),
                "mixup": None, "decoder_logits": None}

    def encode(self, features, feat_lengths):
        return self(features, feat_lengths)

    def streaming_step(self, seg_features, states):
        """One raw-feature segment covering segment_size + right_context subsampled
        frames -> (CTC logits (B, S, V), states) (streaming.py:272-291)."""
        cfg = self.cfg
        B, n = seg_features.shape[:2]
        lens = torch.full((B,), n, dtype=torch.long, device=seg_features.device)
        x, out_lens = self._subsample(seg_features, lens)
        S, R = cfg.segment_size, cfg.right_context
        x = F.pad(x, (0, 0, 0, max(S + R - x.shape[1], 0)))[:, :S + R]
        seg_valid = torch.arange(S + R, device=x.device)[None, :] < out_lens[:, None]
        y, states = self._process_segment(x, seg_valid, states)
        return self._head(self.final_norm(y[:, :S])), states


@register_model_architecture("emformer", "emformer")
@register_model_architecture("emformer", "emformer_s")
def emformer_s(**kw) -> EmformerConfig:
    return EmformerConfig().replace(**kw)

"""Transformer decoder with an explicit incremental KV cache
(counterpart of s2t_tpu/models/transformer_decoder.py).

Entry points: ``forward`` (teacher-forced, (B, U) tokens -> (B, U, V)
logits; with a ``generator`` it trains: embedding dropout after the
positions, :102/:151, and the layers' dropouts) and ``step`` (one incremental
decode step on a cache from ``init_cache``).  Sinusoidal positions, tied or
separate output projection.  The positions table sets the compute dtype.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from s2t_tpu_torch.modules.attention import causal_bias, padding_bias
from s2t_tpu_torch.modules.cast import Linear
from s2t_tpu_torch.modules.dropout import dropout as drop
from s2t_tpu_torch.modules.layers import TransformerDecoderLayer, layer_norm
from s2t_tpu_torch.modules.positional import fairseq_sinusoidal_encoding


class TransformerDecoder(nn.Module):
    def __init__(self, vocab_size: int, embed_dim: int = 256, ffn_dim: int = 2048,
                 num_layers: int = 6, num_heads: int = 4, activation: str = "relu",
                 normalize_before: bool = True, share_input_output_embed: bool = True,
                 max_positions: int = 1024, pad_id: int = 1, dropout: float = 0.0,
                 attention_dropout: float = 0.0, activation_dropout: float = 0.0):
        super().__init__()
        self.embed_dim = embed_dim
        self.dropout = dropout
        self.num_heads = num_heads
        self.normalize_before = normalize_before
        self.pad_id = pad_id
        self.embed_tokens = nn.Embedding(vocab_size, embed_dim)
        self.layers = nn.ModuleList([
            TransformerDecoderLayer(embed_dim, ffn_dim, num_heads, activation, normalize_before,
                                    dropout, attention_dropout, activation_dropout)
            for _ in range(num_layers)
        ])
        self.final_norm = layer_norm(embed_dim) if normalize_before else None
        self.output_proj = (
            None if share_input_output_embed
            else Linear(embed_dim, vocab_size, bias=False)
        )
        self.register_buffer(
            "positions",
            fairseq_sinusoidal_encoding(max_positions, embed_dim, pad_id),
            persistent=False,
        )

    def _embed(self, tokens: torch.Tensor, pos_offset: int) -> torch.Tensor:
        pos = self.positions[pos_offset:pos_offset + tokens.shape[1]]
        x = self.embed_tokens(tokens).to(pos.dtype) * math.sqrt(self.embed_dim)
        return x + pos[None]

    def _output(self, x: torch.Tensor) -> torch.Tensor:
        if self.output_proj is None:
            return x @ self.embed_tokens.weight.to(x.dtype).t()
        return self.output_proj(x)

    def forward_features(self, prev_tokens: torch.Tensor, encoder_out: torch.Tensor,
                         encoder_valid_mask: torch.Tensor,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Hidden states before the output projection: (B, U, D)."""
        U = prev_tokens.shape[1]
        x = drop(self._embed(prev_tokens, 0), self.dropout, generator)
        self_bias = causal_bias(U, x.dtype, x.device) + padding_bias(prev_tokens != self.pad_id, x.dtype)
        cross_bias = padding_bias(encoder_valid_mask, x.dtype)
        for layer in self.layers:
            x, _ = layer(x, encoder_out, self_bias, cross_bias, generator=generator)
        if self.final_norm is not None:
            x = self.final_norm(x)
        return x

    def forward(self, prev_tokens, encoder_out, encoder_valid_mask,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher-forced forward: (B, U) tokens -> (B, U, V) logits."""
        return self._output(self.forward_features(prev_tokens, encoder_out, encoder_valid_mask,
                                                  generator))

    def init_cache(self, batch_size: int, max_len: int) -> dict:
        """Zeroed KV cache: per layer (B, max_len, H, Dh) k/v tensors in the
        model's compute dtype and device."""
        ref = self.positions
        shape = (batch_size, max_len, self.num_heads, self.embed_dim // self.num_heads)
        return {
            f"layer{i}": {
                "k": ref.new_zeros(shape),
                "v": ref.new_zeros(shape),
            }
            for i in range(len(self.layers))
        }

    def precompute_cross(self, encoder_out: torch.Tensor):
        """Per-layer static cross-attention K/V, projected once."""
        return tuple(layer.cross_kv(encoder_out) for layer in self.layers)

    def step(self, tokens: torch.Tensor, cache: dict, index: int, encoder_out: torch.Tensor,
             encoder_valid_mask: torch.Tensor, cross_kv=None) -> Tuple[torch.Tensor, dict]:
        """One decode step: (B, 1) tokens at position ``index`` -> (B, V)
        logits; the cache is written in place and returned."""
        x = self._embed(tokens, index)
        cross_bias = padding_bias(encoder_valid_mask, x.dtype)
        for i, layer in enumerate(self.layers):
            x, cache[f"layer{i}"] = layer(
                x, encoder_out, None, cross_bias, cache=cache[f"layer{i}"], cache_index=index,
                enc_kv=None if cross_kv is None else cross_kv[i],
            )
        if self.final_norm is not None:
            x = self.final_norm(x)
        return self._output(x)[:, 0], cache

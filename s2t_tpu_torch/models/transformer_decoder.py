"""Transformer decoder with an explicit incremental KV cache
(counterpart of s2t_tpu/models/transformer_decoder.py).

Entry points: ``forward`` (teacher-forced, (B, U) tokens -> (B, U, V)
logits; with a ``generator`` it trains: embedding dropout after the
positions, :102/:151, and the layers' dropouts) and ``step`` (one incremental
decode step on a cache from ``init_cache``: full precision, or int8 with
per-(position, head) scales; with an ``ancestry`` map for the lazy beam
reorder).  Sinusoidal or learned positions, the embedding scaled by sqrt(D)
unless ``no_scale_embedding``, a LayerNorm after the positions with
``layernorm_embedding``, tied or separate output projection, an optional
token-embedding module (the LM's adaptive input); the self-attention is "abs"
or Shaw "relative" (``self_attn_type``, clipped at ``max_relative_length``);
``no_cross_attention`` makes it a decoder-only LM;
``collaboration_mode`` gives every layer the dual / multibranch models'
cross-attention over a second stream (training forward only: a decode step
takes none, as in JAX).
``causal=False`` is the NAT models' bidirectional decoder: its self-attention
carries only the targets' padding (transformer_decoder.py:152-153), so it runs
the fused kernel (K1f, and K1b in training) where JAX attends densely under a
padding bias.  The kernel reads lengths, and a canvas may hold pad anywhere (an
argmax fill can pick it), so the keys go valid-first (``valid_first``) under the
prefix mask of each row's count, the queries in place: attention does not depend
on the order of its keys.  ``forward_features_with_attn(..., layer=i)`` also returns
layer i's cross-attention probabilities (B, H, U, S), before dropout (the
alignment Transformer's).
The sinusoidal table sets the compute dtype.
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
from s2t_tpu_torch.utils.masking import valid_first


ALL_LAYERS = -1  # _features' attn_layer: every layer's cross-attention


class TransformerDecoder(nn.Module):
    def __init__(self, vocab_size: int, embed_dim: int = 256, ffn_dim: int = 2048,
                 num_layers: int = 6, num_heads: int = 4, activation: str = "relu",
                 normalize_before: bool = True, share_input_output_embed: bool = True,
                 max_positions: int = 1024, pad_id: int = 1, dropout: float = 0.0,
                 attention_dropout: float = 0.0, activation_dropout: float = 0.0,
                 self_attn_type: str = "abs", max_relative_length: int = 0,
                 no_cross_attention: bool = False, learned_pos: bool = False,
                 embed_tokens: Optional[nn.Module] = None, collaboration_mode: str = "none",
                 league_s1_ratio: float = 0.5, league_s2_ratio: float = 0.5,
                 no_scale_embedding: bool = False, layernorm_embedding: bool = False,
                 encoder_dim: int = 0, causal: bool = True):
        super().__init__()
        self.causal = causal
        self.no_scale_embedding = no_scale_embedding
        self.embed_dim = embed_dim
        self.dropout = dropout
        self.num_heads = num_heads
        self.normalize_before = normalize_before
        self.pad_id = pad_id
        self.embed_tokens = (nn.Embedding(vocab_size, embed_dim) if embed_tokens is None
                             else embed_tokens)
        self.embed_positions = nn.Embedding(max_positions, embed_dim) if learned_pos else None
        self.emb_norm = layer_norm(embed_dim) if layernorm_embedding else None
        self.no_cross_attention = no_cross_attention
        # criterions/latency.capture_cross_attn: every layer's cross-attention probabilities
        # of the teacher-forced passes while set
        self.capture_cross_attn = False
        self.captured_cross_attn = None
        self.layers = nn.ModuleList([
            TransformerDecoderLayer(embed_dim, ffn_dim, num_heads, activation, normalize_before,
                                    dropout, attention_dropout, activation_dropout,
                                    self_attn_type, max_relative_length,
                                    has_cross_attention=not no_cross_attention,
                                    collaboration_mode=collaboration_mode,
                                    league_s1_ratio=league_s1_ratio,
                                    league_s2_ratio=league_s2_ratio, encoder_dim=encoder_dim)
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
        if self.embed_positions is not None:
            idx = torch.arange(pos_offset, pos_offset + tokens.shape[1], device=tokens.device)
            pos = self.embed_positions(idx).to(pos.dtype)
        x = self.embed_tokens(tokens).to(pos.dtype)
        if not self.no_scale_embedding:
            x = x * math.sqrt(self.embed_dim)
        x = x + pos[None]
        return x if self.emb_norm is None else self.emb_norm(x)

    def _output(self, x: torch.Tensor) -> torch.Tensor:
        if self.output_proj is None:
            return x @ self.embed_tokens.weight.to(x.dtype).t()
        return self.output_proj(x)

    def forward_features(self, prev_tokens: torch.Tensor, encoder_out: torch.Tensor,
                         encoder_valid_mask: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         mix: Optional[dict] = None, s2_out: Optional[torch.Tensor] = None,
                         s2_valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Hidden states before the output projection: (B, U, D).  ``mix`` =
        {"tokens2", "coef", "flag"} blends the embeddings of a second token
        sequence into the flagged rows (encoder mixup,
        s2t_tpu/models/transformer_decoder.py:131-150); ``s2_out`` and its
        ``s2_valid_mask``: the second stream of a league decoder."""
        return self._features(prev_tokens, encoder_out, encoder_valid_mask, generator, mix,
                              s2_out, s2_valid_mask)[0]

    def forward_features_with_attn(self, prev_tokens: torch.Tensor, encoder_out: torch.Tensor,
                                   encoder_valid_mask: torch.Tensor, layer: Optional[int] = None,
                                   generator: Optional[torch.Generator] = None
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(``forward_features``, layer ``layer``'s (B, H, U, S) cross-attention
        probabilities before dropout; with ``layer`` None every layer's, concatenated
        layer-major into (B, H·L, U, S))."""
        return self._features(prev_tokens, encoder_out, encoder_valid_mask, generator,
                              attn_layer=ALL_LAYERS if layer is None else layer)

    def _features(self, prev_tokens, encoder_out, encoder_valid_mask, generator=None, mix=None,
                  s2_out=None, s2_valid_mask=None, attn_layer: Optional[int] = None):
        """(hidden states, layer ``attn_layer``'s cross-attention probabilities, every
        layer's for ``ALL_LAYERS``, or None)."""
        if self.capture_cross_attn and attn_layer is None:
            x, attn = self._features(prev_tokens, encoder_out, encoder_valid_mask, generator,
                                     mix, s2_out, s2_valid_mask, ALL_LAYERS)
            if self.captured_cross_attn is None:  # the first pass's, as JAX reads its sow
                self.captured_cross_attn = attn
            return x, None
        U = prev_tokens.shape[1]
        x = self._embed(prev_tokens, 0)
        tgt_valid = prev_tokens != self.pad_id
        if mix is not None:
            x2 = self._embed(mix["tokens2"], 0)
            c = mix["coef"][:, None, None].to(x.dtype)
            x = torch.where(mix["flag"][:, None, None], c * x + (1.0 - c) * x2, x)
            tgt_valid = tgt_valid | (mix["tokens2"] != self.pad_id)
        x = drop(x, self.dropout, generator)
        self_bias, self_valid, key_order = None, None, None
        if self.causal:
            self_bias = causal_bias(U, x.dtype, x.device) + padding_bias(tgt_valid, x.dtype)
        else:
            self_valid, key_order = tgt_valid, valid_first(tgt_valid)
        cross_bias = None if self.no_cross_attention else padding_bias(encoder_valid_mask, x.dtype)
        s2_bias = None if s2_valid_mask is None else padding_bias(s2_valid_mask, x.dtype)
        attn = []
        for i, layer in enumerate(self.layers):
            if i == attn_layer or (attn_layer == ALL_LAYERS and layer.has_cross_attention):
                x, a = layer.forward_with_attn(x, encoder_out, self_bias, cross_bias,
                                               generator, self_valid, key_order,
                                               s2_out=s2_out, s2_bias=s2_bias)
                attn.append(a)
            else:
                x, _ = layer(x, encoder_out, self_bias, cross_bias, generator=generator,
                             s2_out=s2_out, s2_bias=s2_bias, self_valid=self_valid,
                             self_key_order=key_order)
        if self.final_norm is not None:
            x = self.final_norm(x)
        return x, (torch.cat(attn, dim=1) if attn else None)

    def forward(self, prev_tokens, encoder_out, encoder_valid_mask,
                generator: Optional[torch.Generator] = None, mix: Optional[dict] = None,
                s2_out: Optional[torch.Tensor] = None,
                s2_valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Teacher-forced forward: (B, U) tokens -> (B, U, V) logits."""
        return self._output(self.forward_features(prev_tokens, encoder_out, encoder_valid_mask,
                                                  generator, mix, s2_out, s2_valid_mask))

    def init_cache(self, batch_size: int, max_len: int, kv_int8: bool = False) -> dict:
        """Zeroed KV cache: per layer (B, max_len, H, Dh) k/v tensors in the
        model's compute dtype and device; ``kv_int8``: int8 k/v with (B,
        max_len, H) bf16 scales (s2t_tpu/models/transformer_decoder.py:186-211)."""
        ref = self.positions
        shape = (batch_size, max_len, self.num_heads, self.embed_dim // self.num_heads)
        if kv_int8:
            return {f"layer{i}": {
                "k": ref.new_zeros(shape, dtype=torch.int8),
                "k_scale": ref.new_zeros(shape[:3], dtype=torch.bfloat16),
                "v": ref.new_zeros(shape, dtype=torch.int8),
                "v_scale": ref.new_zeros(shape[:3], dtype=torch.bfloat16),
            } for i in range(len(self.layers))}
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

    def step(self, tokens: torch.Tensor, cache: dict, index: int,
             encoder_out: Optional[torch.Tensor], encoder_valid_mask: Optional[torch.Tensor],
             cross_kv=None, ancestry: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, dict]:
        """One decode step: (B, 1) tokens at position ``index`` -> (B, V)
        logits; the cache is written in place and returned.  ``ancestry``: the
        lazy reorder's (B, K, L) slot map; this step's row is each beam's own slot."""
        x = self._embed(tokens, index)
        cross_bias = None if encoder_valid_mask is None else padding_bias(encoder_valid_mask,
                                                                          x.dtype)
        if ancestry is not None:
            ancestry = ancestry.clone()
            ancestry[:, :, index] = torch.arange(ancestry.shape[1], device=ancestry.device)
        for i, layer in enumerate(self.layers):
            x, cache[f"layer{i}"] = layer(
                x, encoder_out, None, cross_bias, cache=cache[f"layer{i}"], cache_index=index,
                enc_kv=None if cross_kv is None else cross_kv[i], cache_ancestry=ancestry,
            )
        if self.final_norm is not None:
            x = self.final_norm(x)
        return self._output(x)[:, 0], cache

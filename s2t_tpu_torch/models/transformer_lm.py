"""Decoder-only Transformer language model, for shallow fusion in the
generator (``SequenceGenerator(lm_model=, lm_weight=)``) and LM scoring
(counterpart of s2t_tpu/models/transformer_lm.py:21-151).

The port's ``TransformerDecoder`` with no cross-attention; optional learned
positions, adaptive input embeddings and an adaptive softmax
(``modules/adaptive_softmax.py``).  Built and placed as the speech models are
(``init_and_place``: seeded weights, serving dtype or float32 masters).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from s2t_tpu_torch.device import resolve_device
from s2t_tpu_torch.models.s2t_transformer import init_and_place, seeded_init
from s2t_tpu_torch.models.transformer_decoder import TransformerDecoder
from s2t_tpu_torch.modules.adaptive_softmax import AdaptiveInput, AdaptiveSoftmax
from s2t_tpu_torch.registry import register_model, register_model_architecture


@dataclass(frozen=True)
class TransformerLMConfig:
    decoder_embed_dim: int = 512
    decoder_ffn_embed_dim: int = 2048
    decoder_layers: int = 6
    decoder_attention_heads: int = 8
    decoder_normalize_before: bool = True
    decoder_learned_pos: bool = False
    share_decoder_input_output_embed: bool = True
    dropout: float = 0.1
    attention_dropout: float = 0.0
    activation_dropout: float = 0.0
    activation_fn: str = "relu"
    vocab_size: int = 1000
    max_target_positions: int = 1024
    pad_id: int = 1
    adaptive_softmax_cutoff: Tuple[int, ...] = ()
    adaptive_softmax_factor: float = 4.0
    adaptive_input_cutoff: Tuple[int, ...] = ()
    adaptive_input_factor: float = 4.0
    dtype_str: str = "float32"

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype_str == "bfloat16" else torch.float32


@register_model("transformer_lm")
class TransformerLM(nn.Module):
    @seeded_init
    def __init__(self, cfg: TransformerLMConfig, device="cuda", seed: int = 0,
                 for_training: bool = False):
        super().__init__()
        self.cfg = cfg
        embed = None
        share_io = cfg.share_decoder_input_output_embed
        if cfg.adaptive_input_cutoff:
            embed = AdaptiveInput(cfg.vocab_size, cfg.adaptive_input_cutoff,
                                  cfg.decoder_embed_dim, cfg.adaptive_input_factor)
            share_io = False  # no dense table to tie
        # the adaptive softmax replaces the output projection (flax never builds it)
        self.decoder = TransformerDecoder(
            vocab_size=cfg.vocab_size, embed_dim=cfg.decoder_embed_dim,
            ffn_dim=cfg.decoder_ffn_embed_dim, num_layers=cfg.decoder_layers,
            num_heads=cfg.decoder_attention_heads, activation=cfg.activation_fn,
            normalize_before=cfg.decoder_normalize_before,
            share_input_output_embed=share_io or bool(cfg.adaptive_softmax_cutoff),
            max_positions=cfg.max_target_positions, pad_id=cfg.pad_id, dropout=cfg.dropout,
            attention_dropout=cfg.attention_dropout, activation_dropout=cfg.activation_dropout,
            no_cross_attention=True, learned_pos=cfg.decoder_learned_pos, embed_tokens=embed)
        self.adaptive = (AdaptiveSoftmax(cfg.vocab_size, cfg.adaptive_softmax_cutoff,
                                         cfg.decoder_embed_dim, cfg.adaptive_softmax_factor)
                         if cfg.adaptive_softmax_cutoff else None)
        init_and_place(self, cfg, resolve_device(device), seed, for_training)

    @property
    def device(self) -> torch.device:
        return self.decoder.positions.device

    def forward(self, prev_tokens: torch.Tensor, targets: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """(B, U) tokens -> {"decoder_logits": (B, U, V)}; with an adaptive
        softmax {"decoder_features", and "target_logprob" given ``targets``, else
        "decoder_logits" as full log-probs with "logits_are_log_probs"}."""
        if self.adaptive is None:
            return {"decoder_logits": self.decoder(prev_tokens, None, None, generator)}
        feats = self.decoder.forward_features(prev_tokens, None, None, generator)
        out: Dict[str, Any] = {"decoder_features": feats}
        if targets is not None:
            out["target_logprob"] = self.adaptive.target_logprob(feats, targets)
            out["decoder_logits"] = None
        else:
            out["decoder_logits"] = self.adaptive.log_probs(feats)
            out["logits_are_log_probs"] = True
        return out

    def decode_step(self, tokens, cache, index):
        if self.adaptive is not None:
            raise NotImplementedError("adaptive-softmax LMs are for training and scoring; "
                                      "use a softmax LM for shallow fusion")
        return self.decoder.step(tokens, cache, index, None, None)

    def init_cache(self, batch_size: int, max_len: int):
        return self.decoder.init_cache(batch_size, max_len)


@register_model_architecture("transformer_lm", "transformer_lm")
def transformer_lm_base(**kw) -> TransformerLMConfig:
    return TransformerLMConfig().replace(**kw)


@register_model_architecture("transformer_lm", "transformer_lm_big")
def transformer_lm_big(**kw) -> TransformerLMConfig:
    return TransformerLMConfig(decoder_embed_dim=1024, decoder_ffn_embed_dim=4096,
                               decoder_attention_heads=16, decoder_layers=12).replace(**kw)


@register_model_architecture("transformer_lm", "transformer_lm_wiki103")
@register_model_architecture("transformer_lm", "transformer_lm_baevski_wiki103")
def transformer_lm_wiki103(**kw) -> TransformerLMConfig:
    """Adaptive input and adaptive softmax (Baevski & Auli)."""
    return TransformerLMConfig(
        decoder_embed_dim=1024, decoder_ffn_embed_dim=4096, decoder_attention_heads=8,
        decoder_layers=16, dropout=0.3, adaptive_softmax_cutoff=(20000, 60000),
        adaptive_input_cutoff=(20000, 60000)).replace(**kw)

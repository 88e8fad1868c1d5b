"""BART and mBART (counterpart of s2t_tpu/models/bart.py).

The port's ``TransformerTextEncoder`` and ``TransformerDecoder`` over one token
table: the decoder owns it (flax's top-level ``shared``), the encoder embeds with
it, and the decoder's output projection is its transpose.  The presets set
learned positions on both sides, ``layernorm_embedding`` and GELU; ``bart_base`` /
``bart_large`` are post-norm without the embedding scale, ``mbart_large`` pre-norm
with it.  The encoder's self-attention takes a padding-only mask, so it runs the
fused kernel (K1f, and K1b in training), one launch a layer; the causal decoder
attends densely, as in JAX.

``num_classes`` > 0 adds the sentence-classification head (:84-100): the source
tokens run through the decoder too, its features are pooled at each row's last
real token (its EOS), and dropout -> ``cls_dense`` -> tanh -> dropout -> ``cls_out``
give the logits (``classify``, or ``forward(..., classification=True)`` as
``cls_logits``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
from torch import nn

from s2t_tpu_torch.device import resolve_device
from s2t_tpu_torch.models.s2t_transformer import init_and_place, seeded_init
from s2t_tpu_torch.models.transformer import (
    TransformerMTConfig, TransformerModel, TransformerTextEncoder)
from s2t_tpu_torch.models.transformer_decoder import TransformerDecoder
from s2t_tpu_torch.modules.cast import Linear
from s2t_tpu_torch.modules.dropout import dropout
from s2t_tpu_torch.registry import register_model, register_model_architecture
from s2t_tpu_torch.utils.masking import lengths_to_mask


@dataclass(frozen=True)
class BARTConfig(TransformerMTConfig):
    num_classes: int = 0  # > 0 adds the sentence-classification head
    pooler_dropout: float = 0.0


@register_model("bart")
class BARTModel(TransformerModel):
    """``TransformerModel``'s surface (``forward``, ``encode``, ``decode_step``,
    ``init_cache``, ``precompute_cross``) with the shared table and the head."""

    @seeded_init
    def __init__(self, cfg: BARTConfig, device="cuda", seed: int = 0,
                 for_training: bool = False):
        nn.Module.__init__(self)
        self.cfg = cfg
        self.decoder = TransformerDecoder(
            vocab_size=cfg.vocab_size, embed_dim=cfg.decoder_embed_dim,
            ffn_dim=cfg.decoder_ffn_embed_dim, num_layers=cfg.decoder_layers,
            num_heads=cfg.decoder_attention_heads, activation=cfg.activation_fn,
            normalize_before=cfg.decoder_normalize_before, share_input_output_embed=True,
            max_positions=cfg.max_target_positions, pad_id=cfg.pad_id, dropout=cfg.dropout,
            attention_dropout=cfg.attention_dropout, activation_dropout=cfg.activation_dropout,
            learned_pos=cfg.decoder_learned_pos, no_scale_embedding=cfg.no_scale_embedding,
            layernorm_embedding=cfg.layernorm_embedding, encoder_dim=cfg.encoder_embed_dim)
        self.encoder = TransformerTextEncoder(cfg, embed_tokens=self.decoder.embed_tokens)
        if cfg.num_classes > 0:
            self.cls_dense = Linear(cfg.encoder_embed_dim, cfg.encoder_embed_dim)
            self.cls_out = Linear(cfg.encoder_embed_dim, cfg.num_classes)
        init_and_place(self, cfg, resolve_device(device), seed, for_training)

    def forward(self, src_tokens, src_lengths, prev_tokens, train: bool = False,
                generator: Optional[torch.Generator] = None, classification: bool = False,
                **unused) -> Dict[str, Any]:
        out = super().forward(src_tokens, src_lengths, prev_tokens, train, generator)
        if classification and self.cfg.num_classes > 0:
            out["cls_logits"] = self._classify_from(out, src_tokens, src_lengths,
                                                    generator if train else None)
        return out

    def _classify_from(self, enc, src_tokens, src_lengths, generator=None) -> torch.Tensor:
        mask = lengths_to_mask(enc["encoder_lengths"], enc["encoder_out"].shape[1])
        feats = self.decoder.forward_features(src_tokens, enc["encoder_out"], mask, generator)
        last = (torch.as_tensor(src_lengths, device=feats.device).long() - 1).clamp(min=0)
        pooled = feats[torch.arange(feats.shape[0], device=feats.device), last]
        p = self.cfg.pooler_dropout
        h = torch.tanh(self.cls_dense(dropout(pooled, p, generator)))
        return self.cls_out(dropout(h, p, generator))

    def classify(self, src_tokens, src_lengths) -> torch.Tensor:
        return self._classify_from(self.encoder(src_tokens, src_lengths), src_tokens, src_lengths)


def _bart(width: int, ffn: int, layers: int, heads: int, pre_norm: bool) -> BARTConfig:
    return BARTConfig(
        encoder_embed_dim=width, encoder_ffn_embed_dim=ffn, encoder_layers=layers,
        encoder_attention_heads=heads, decoder_embed_dim=width, decoder_ffn_embed_dim=ffn,
        decoder_layers=layers, decoder_attention_heads=heads, activation_fn="gelu",
        encoder_learned_pos=True, decoder_learned_pos=True, layernorm_embedding=True,
        no_scale_embedding=not pre_norm, share_all_embeddings=True,
        encoder_normalize_before=pre_norm, decoder_normalize_before=pre_norm)


@register_model_architecture("bart", "bart_base")
def bart_base(**kw) -> BARTConfig:
    return _bart(768, 3072, 6, 12, pre_norm=False).replace(**kw)


@register_model_architecture("bart", "bart_large")
def bart_large(**kw) -> BARTConfig:
    return _bart(1024, 4096, 12, 16, pre_norm=False).replace(**kw)


@register_model_architecture("bart", "mbart_large")
def mbart_large(**kw) -> BARTConfig:
    """mBART: pre-norm, the embedding scaled by sqrt(D)."""
    return _bart(1024, 4096, 12, 16, pre_norm=True).replace(**kw)

"""Transformer with supervised attention alignment, Garg et al. 2019 (counterpart of
s2t_tpu/models/transformer_align.py).

The text ``TransformerModel`` whose forward also returns ``align_attn`` (B, U, S):
the cross-attention probabilities of decoder layer ``alignment_layer`` (negative:
from the end), before dropout, averaged over its first ``alignment_heads`` heads.
JAX sows them into flax's "intermediates" and the task's forward pulls them out
(``extract_alignment_attn``); here the decoder returns them.  That cross-attention
is dense (Tq != Tk), as in JAX; the encoder's self-attention runs the fused kernel.
``label_smoothed_cross_entropy_with_alignment`` reads them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from s2t_tpu_torch.models.transformer import TransformerModel, TransformerMTConfig
from s2t_tpu_torch.registry import register_model, register_model_architecture
from s2t_tpu_torch.utils.masking import lengths_to_mask


@dataclass(frozen=True)
class TransformerAlignConfig(TransformerMTConfig):
    # the decoder layer whose cross-attention carries the alignment; negative: from the end
    alignment_layer: int = -1
    alignment_heads: int = 1  # average the first N heads


def alignment_layer_index(cfg: TransformerAlignConfig) -> int:
    layer = cfg.alignment_layer if cfg.alignment_layer >= 0 \
        else cfg.decoder_layers + cfg.alignment_layer
    if not 0 <= layer < cfg.decoder_layers:
        raise ValueError(f"alignment_layer {cfg.alignment_layer} is not a layer of a "
                         f"{cfg.decoder_layers}-layer decoder")
    return layer


@register_model("transformer_align")
class TransformerAlignModel(TransformerModel):
    def __init__(self, cfg: TransformerAlignConfig, device="cuda", seed: int = 0,
                 for_training: bool = False):
        self.align_layer = alignment_layer_index(cfg)
        super().__init__(cfg, device=device, seed=seed, for_training=for_training)

    def forward(self, src_tokens, src_lengths, prev_tokens, train: bool = False,
                generator: Optional[torch.Generator] = None, **unused) -> Dict[str, Any]:
        if train and generator is None:
            raise ValueError("train=True needs the step's torch.Generator")
        generator = generator if train else None
        enc = self.encoder(src_tokens, src_lengths, generator)
        mask = lengths_to_mask(enc["encoder_lengths"], enc["encoder_out"].shape[1])
        feats, w = self.decoder.forward_features_with_attn(prev_tokens, enc["encoder_out"], mask,
                                                           self.align_layer, generator)
        h = max(1, min(self.cfg.alignment_heads, w.shape[1]))
        return {"decoder_logits": self.decoder._output(feats), **enc,
                "align_attn": w[:, :h].mean(dim=1)}


@register_model_architecture("transformer_align", "transformer_align")
def transformer_align(**kw) -> TransformerAlignConfig:
    return TransformerAlignConfig().replace(**kw)


@register_model_architecture("transformer_align", "transformer_wmt_en_de_big_align")
def transformer_align_big(**kw) -> TransformerAlignConfig:
    return TransformerAlignConfig(
        encoder_embed_dim=1024, encoder_ffn_embed_dim=4096, encoder_attention_heads=16,
        decoder_embed_dim=1024, decoder_ffn_embed_dim=4096, decoder_attention_heads=16,
        dropout=0.3, alignment_layer=4,
    ).replace(**kw)

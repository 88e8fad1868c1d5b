"""CMLM (Mask-Predict), vanilla NAT and NACRF (counterpart of
s2t_tpu/models/cmlm_transformer.py).

The text Transformer encoder and the shared ``TransformerDecoder`` with
``causal=False``: it fills every <unk> of its canvas in parallel, its
self-attention under the targets' padding only, which runs the fused kernel
(K1f / K1b) as the encoder's does.  A 256-way length head reads the masked mean of
the encoder states.  ``nonautoregressive_transformer`` is the same graph, trained
with ``full_mask`` noise and decoded in one pass.  NACRF adds a low-rank,
beam-restricted CRF (``modules/dynamic_crf.py``) over the word emissions: its NLL
joins the loss beside a ``word_ins_factor``-weighted CE, and Viterbi decodes.
The refinement loop is ``inference/iterative_refinement.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
from torch import nn

from s2t_tpu_torch.device import resolve_device
from s2t_tpu_torch.models.s2t_transformer import init_and_place, seeded_init
from s2t_tpu_torch.models.transformer import TransformerMTConfig, TransformerTextEncoder
from s2t_tpu_torch.models.transformer_decoder import TransformerDecoder
from s2t_tpu_torch.modules.cast import Linear
from s2t_tpu_torch.registry import register_model, register_model_architecture
from s2t_tpu_torch.utils.masking import lengths_to_mask


@dataclass(frozen=True)
class CMLMConfig(TransformerMTConfig):
    length_loss_factor: float = 0.1
    max_length_classes: int = 256  # the length head's arity
    unk_id: int = 3
    bos_id: int = 0
    eos_id: int = 2


def nat_decoder(cfg: TransformerMTConfig, max_positions: Optional[int] = None
                ) -> TransformerDecoder:
    """The NAT models' bidirectional decoder (the JAX models build it alike)."""
    return TransformerDecoder(
        vocab_size=cfg.vocab_size, embed_dim=cfg.decoder_embed_dim,
        ffn_dim=cfg.decoder_ffn_embed_dim, num_layers=cfg.decoder_layers,
        num_heads=cfg.decoder_attention_heads, activation=cfg.activation_fn,
        normalize_before=cfg.decoder_normalize_before,
        share_input_output_embed=cfg.share_decoder_input_output_embed,
        max_positions=max_positions or cfg.max_target_positions, pad_id=cfg.pad_id,
        dropout=cfg.dropout, attention_dropout=cfg.attention_dropout,
        activation_dropout=cfg.activation_dropout, encoder_dim=cfg.encoder_embed_dim,
        causal=False)


class NATModel(nn.Module):
    """The encoder, the non-causal decoder and ``build_heads``' modules, built from
    ``seed`` on ``device``; serving or ``for_training``, as the other models."""

    decoder_positions_extra = 0

    @seeded_init
    def __init__(self, cfg: TransformerMTConfig, device="cuda", seed: int = 0,
                 for_training: bool = False):
        super().__init__()
        self.cfg = cfg
        self.encoder = TransformerTextEncoder(cfg)
        self.decoder = nat_decoder(cfg, cfg.max_target_positions + self.decoder_positions_extra)
        self.build_heads(cfg)
        init_and_place(self, cfg, resolve_device(device), seed, for_training)

    def build_heads(self, cfg) -> None:
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        return self.decoder.positions.device

    def encode(self, src_tokens, src_lengths, generator: Optional[torch.Generator] = None):
        return self.encoder(src_tokens, src_lengths, generator)

    @staticmethod
    def encoder_valid(enc: Dict[str, Any]) -> torch.Tensor:
        return lengths_to_mask(enc["encoder_lengths"], enc["encoder_out"].shape[1])

    @staticmethod
    def _generator(train: bool, generator):
        if train and generator is None:
            raise ValueError("train=True needs the step's torch.Generator")
        return generator if train else None


@register_model("cmlm_transformer")
class CMLMTransformerModel(NATModel):
    """``forward(src_tokens, src_lengths, prev_tokens, tgt_tokens, train, generator)``
    -> {"word_ins_logits", "word_ins_mask", "length_logits", ["length_tgt"], ...}."""

    def build_heads(self, cfg: CMLMConfig) -> None:
        self.length_head = Linear(cfg.encoder_embed_dim, cfg.max_length_classes)

    def _length_logits(self, enc_out, enc_valid):
        m = enc_valid[..., None].to(enc_out.dtype)
        pooled = (enc_out * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
        return self.length_head(pooled)

    def forward(self, src_tokens, src_lengths, prev_tokens, tgt_tokens=None, train: bool = False,
                generator: Optional[torch.Generator] = None, **unused) -> Dict[str, Any]:
        cfg = self.cfg
        generator = self._generator(train, generator)
        enc = self.encoder(src_tokens, src_lengths, generator)
        enc_valid = self.encoder_valid(enc)
        out: Dict[str, Any] = {
            "word_ins_logits": self.decoder(prev_tokens, enc["encoder_out"], enc_valid, generator),
            "word_ins_mask": prev_tokens == cfg.unk_id,
            "length_logits": self._length_logits(enc["encoder_out"], enc_valid), **enc}
        if tgt_tokens is not None:
            n = (tgt_tokens != cfg.pad_id).sum(dim=1)
            out["length_tgt"] = n.clamp(0, cfg.max_length_classes - 1)
        return out

    def predict_length(self, encoder_out, encoder_valid_mask) -> torch.Tensor:
        """Greedy length prediction (B,)."""
        return self._length_logits(encoder_out, encoder_valid_mask).argmax(dim=-1)

    def nat_decode(self, prev_tokens, encoder_out, encoder_valid_mask) -> torch.Tensor:
        """Every position in parallel: (B, T) tokens -> (B, T, V) logits."""
        return self.decoder(prev_tokens, encoder_out, encoder_valid_mask)


@dataclass(frozen=True)
class NACRFConfig(CMLMConfig):
    crf_rank: int = 32
    crf_beam: int = 8
    word_ins_factor: float = 0.5  # the token CE's weight beside the CRF NLL


@register_model("nacrf_transformer")
class NACRFTransformerModel(CMLMTransformerModel):
    """CMLM with the CRF: given targets the output adds "crf_nll" (B,) and
    "word_ins_factor"; ``crf_decode`` is Viterbi."""

    def build_heads(self, cfg: NACRFConfig) -> None:
        super().build_heads(cfg)
        from s2t_tpu_torch.modules.dynamic_crf import DynamicCRF

        self.crf = DynamicCRF(cfg.vocab_size, cfg.crf_rank, cfg.crf_beam)

    def forward(self, src_tokens, src_lengths, prev_tokens, tgt_tokens=None, train: bool = False,
                generator: Optional[torch.Generator] = None, **unused) -> Dict[str, Any]:
        out = super().forward(src_tokens, src_lengths, prev_tokens, tgt_tokens, train, generator)
        if tgt_tokens is not None:
            out["crf_nll"] = self.crf.nll(out["word_ins_logits"], tgt_tokens,
                                          tgt_tokens != self.cfg.pad_id)
            out["word_ins_factor"] = self.cfg.word_ins_factor
        return out

    def crf_decode(self, emissions, nonpad_mask):
        return self.crf.viterbi(emissions, nonpad_mask)


@register_model_architecture("nacrf_transformer", "nacrf_transformer")
def nacrf_transformer(**kw) -> NACRFConfig:
    return NACRFConfig(encoder_normalize_before=False,
                       decoder_normalize_before=False).replace(**kw)


@register_model_architecture("cmlm_transformer", "cmlm_transformer")
def cmlm_transformer(**kw) -> CMLMConfig:
    return CMLMConfig(encoder_normalize_before=False,
                      decoder_normalize_before=False).replace(**kw)


@register_model_architecture("cmlm_transformer", "cmlm_transformer_small")
def cmlm_transformer_small(**kw) -> CMLMConfig:
    return CMLMConfig(
        encoder_embed_dim=256, encoder_ffn_embed_dim=1024, encoder_attention_heads=4,
        decoder_embed_dim=256, decoder_ffn_embed_dim=1024, decoder_attention_heads=4,
    ).replace(**kw)


@register_model_architecture("cmlm_transformer", "nonautoregressive_transformer")
def nonautoregressive_transformer(**kw) -> CMLMConfig:
    """Vanilla single-pass NAT: CMLM's graph, ``full_mask`` noise, one decode pass."""
    return CMLMConfig(encoder_normalize_before=False,
                      decoder_normalize_before=False).replace(**kw)

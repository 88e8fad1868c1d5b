"""Dual-stream speech + text model (counterpart of s2t_tpu/models/s2t_dual.py).

A speech encoder (the port's ``S2TTransformerEncoder``, with its CTC head) and
a text encoder over the transcript whose layers league-attend the speech stream
("parallel": self-attention r1 + speech attention r2 before the residual;
``S2TEncoderLayer``'s ``s2`` inputs, no s2 norm, as in JAX); the Transformer
decoder attends the text stream.  In training the task hands the transcript
over (``consumes_transcript``); without one the text stream reads the greedy
CTC hypothesis of the speech encoder (``ops/ctc.ctc_greedy_decode``, on the
detached logits).

``decoder_attend_speech=False`` (the default) reproduces the reference's dead
branch: the decoder's second-stream attention is never called, so it has no
parameters.  The text encoder's self-attention takes a padding-only mask and
runs the fused attention kernel (K1f / K1b) where the JAX module passes an
explicit padding bias and attends densely; the speech attention is dense in
both.  The model has no incremental decoder (``init_cache`` / ``decode_step``),
as in JAX, so the beam generator refuses it.

The text stream's config is the text Transformer's ``TransformerMTConfig``
(``models/transformer.py``); the dual text encoder reads its encoder fields,
``src_vocab``, ``no_scale_embedding``, ``layernorm_embedding``, the dropouts, the
activation and ``pad_id``.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
from torch import nn

from s2t_tpu_torch.device import resolve_device
from s2t_tpu_torch.models.s2t_transformer import (
    S2TTransformerConfig, S2TTransformerEncoder, S2TTransformerModel, init_and_place,
    s2t_transformer_s, seeded_init)
from s2t_tpu_torch.models.transformer import TransformerMTConfig
from s2t_tpu_torch.models.transformer_decoder import TransformerDecoder
from s2t_tpu_torch.modules.attention import padding_bias
from s2t_tpu_torch.modules.dropout import dropout
from s2t_tpu_torch.modules.layers import S2TEncoderLayer, layer_norm
from s2t_tpu_torch.modules.positional import sinusoidal_table
from s2t_tpu_torch.ops.ctc import ctc_greedy_decode
from s2t_tpu_torch.registry import register_model, register_model_architecture
from s2t_tpu_torch.utils.masking import lengths_to_mask


@dataclass(frozen=True)
class S2TDualConfig:
    speech: S2TTransformerConfig = dataclasses.field(default_factory=S2TTransformerConfig)
    text: TransformerMTConfig = dataclasses.field(default_factory=TransformerMTConfig)
    encoder_collaboration_mode: str = "parallel"
    decoder_collaboration_mode: str = "parallel"
    encoder_league_s1_ratio: float = 0.5
    encoder_league_s2_ratio: float = 0.5
    decoder_league_s1_ratio: float = 0.5
    decoder_league_s2_ratio: float = 0.5
    decoder_attend_speech: bool = False
    consumes_transcript: bool = True

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @property
    def vocab_size(self):
        return self.speech.vocab_size

    @property
    def decoder_layers(self):
        return self.speech.decoder_layers

    @property
    def max_target_positions(self):
        return self.speech.max_target_positions

    @property
    def subsampling_layers(self):
        return self.speech.subsampling_layers

    @property
    def subsampling_stride(self):
        return self.speech.subsampling_stride

    @property
    def dtype(self) -> torch.dtype:
        return self.speech.dtype


class DualTextEncoder(nn.Module):
    """Token embedding (scaled) + sinusoidal positions [+ norm] -> dropout ->
    padding zeroed -> league layers over the speech stream -> final norm
    (s2t_tpu/models/s2t_dual.py:110-149)."""

    def __init__(self, cfg: S2TDualConfig):
        super().__init__()
        tc = cfg.text
        D = tc.encoder_embed_dim
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(tc.src_vocab, D)
        self.emb_norm = layer_norm(D) if tc.layernorm_embedding else None
        self.layers = nn.ModuleList([
            S2TEncoderLayer(D, tc.encoder_ffn_embed_dim, tc.encoder_attention_heads,
                            tc.activation_fn, tc.encoder_normalize_before, tc.dropout,
                            tc.attention_dropout, tc.activation_dropout,
                            collaboration_mode=cfg.encoder_collaboration_mode,
                            league_s1_ratio=cfg.encoder_league_s1_ratio,
                            league_s2_ratio=cfg.encoder_league_s2_ratio)
            for _ in range(tc.encoder_layers)
        ])
        self.final_norm = layer_norm(D) if tc.encoder_normalize_before else None

    def forward(self, tokens, speech_out, speech_bias, generator=None):
        tc = self.cfg.text
        D = tc.encoder_embed_dim
        dtype = speech_out.dtype
        x = self.embed_tokens(tokens).to(dtype)
        if not tc.no_scale_embedding:
            x = x * math.sqrt(D)
        x = x + sinusoidal_table(x.shape[1], D, tc.pad_id, dtype, x.device)[None]
        if self.emb_norm is not None:
            x = self.emb_norm(x)
        x = dropout(x, tc.dropout, generator)
        valid = tokens != tc.pad_id
        x = x.masked_fill(~valid[..., None], 0.0)
        for layer in self.layers:
            x = layer(x, valid, None, generator, s2=speech_out, s2_bias=speech_bias)
        if self.final_norm is not None:
            x = self.final_norm(x)
        return x, valid


@register_model("s2t_dual")
class S2TDualModel(nn.Module):
    @seeded_init
    def __init__(self, cfg: S2TDualConfig, device="cuda", seed: int = 0,
                 for_training: bool = False):
        super().__init__()
        S2TTransformerModel.check_config(cfg.speech, for_training)
        device = resolve_device(device)
        self.cfg = cfg
        sp = cfg.speech
        self.speech_encoder = S2TTransformerEncoder(sp)
        self.text_encoder = DualTextEncoder(cfg)
        self.decoder = TransformerDecoder(
            vocab_size=sp.vocab_size, embed_dim=sp.decoder_embed_dim,
            ffn_dim=sp.decoder_ffn_embed_dim, num_layers=sp.decoder_layers,
            num_heads=sp.decoder_attention_heads, activation=sp.activation_fn,
            normalize_before=sp.decoder_normalize_before,
            share_input_output_embed=sp.share_decoder_input_output_embed,
            max_positions=sp.max_target_positions, dropout=sp.dropout,
            attention_dropout=sp.attention_dropout, activation_dropout=sp.activation_dropout,
            # the second-stream attention exists only where it is called
            collaboration_mode=(cfg.decoder_collaboration_mode if cfg.decoder_attend_speech
                                else "none"),
            league_s1_ratio=cfg.decoder_league_s1_ratio,
            league_s2_ratio=cfg.decoder_league_s2_ratio)
        init_and_place(self, sp, device, seed, for_training)

    @property
    def device(self) -> torch.device:
        return self.decoder.embed_tokens.weight.device

    def _text_stream(self, enc, transcript, generator):
        """The given transcript, else the greedy CTC hypothesis, through the text encoder."""
        if transcript is None:
            if enc["ctc_logits"] is None:
                raise ValueError("the dual model decodes its text stream from CTC: set use_ctc")
            transcript, _ = ctc_greedy_decode(enc["ctc_logits"].detach(), enc["encoder_lengths"])
        speech_mask = lengths_to_mask(enc["encoder_lengths"], enc["encoder_out"].shape[1])
        sp_bias = padding_bias(speech_mask, enc["encoder_out"].dtype)
        text_out, text_valid = self.text_encoder(transcript, enc["encoder_out"], sp_bias,
                                                 generator)
        return text_out, text_valid, speech_mask

    def forward(self, features, feat_lengths, prev_tokens, train: bool = False,
                generator: Optional[torch.Generator] = None, transcript=None,
                transcript_lengths=None, **unused) -> Dict[str, Any]:
        """Teacher-forced forward; ``transcript`` (its lengths are not read: the
        text stream's mask is its non-pad tokens) or the CTC hypothesis."""
        if train and generator is None:
            raise ValueError("train=True needs the step's torch.Generator")
        if not train:
            generator = None
        enc = self.speech_encoder(features, feat_lengths, None, generator)
        text_out, text_valid, speech_mask = self._text_stream(enc, transcript, generator)
        s2 = ({"s2_out": enc["encoder_out"], "s2_valid_mask": speech_mask}
              if self.cfg.decoder_attend_speech else {})
        logits = self.decoder(prev_tokens, text_out, text_valid, generator, **s2)
        return {"decoder_logits": logits, "text_encoder_out": text_out,
                "text_valid_mask": text_valid, **enc}

    def encode(self, features, feat_lengths):
        """The speech encoder's dict with the CTC-driven text stream folded in
        ("text_out", "text_mask"); "encoder_out" stays the speech stream, as in JAX."""
        enc = self.speech_encoder(features, feat_lengths)
        text_out, text_valid, _ = self._text_stream(enc, None, None)
        return {**enc, "text_out": text_out, "text_mask": text_valid}


def _route_dual_ctx(kw):
    sp_kw = {k[len("speech_"):]: v for k, v in kw.items() if k.startswith("speech_")}
    tx_kw = {k[len("text_"):]: v for k, v in kw.items() if k.startswith("text_")}
    rest = {k: v for k, v in kw.items()
            if not k.startswith("speech_") and not k.startswith("text_")}
    for key in ("vocab_size", "src_vocab_size", "input_feat_per_channel", "input_channels",
                "max_source_positions", "max_target_positions"):
        if key in rest:
            v = rest.pop(key)
            sp_kw[key] = v
            if key in ("vocab_size", "src_vocab_size"):
                tx_kw[key] = v
    return sp_kw, tx_kw, rest


@register_model_architecture("s2t_dual", "s2t_dual")
@register_model_architecture("s2t_dual", "s2t_dual_s")
def s2t_dual_s(**kw) -> S2TDualConfig:
    sp_kw, tx_kw, rest = _route_dual_ctx(kw)
    speech = s2t_transformer_s(use_ctc=True, **sp_kw)
    # the text stream's vocabulary is the source (transcript) one
    tx_kw.setdefault("src_vocab_size", speech.ctc_vocab_size)
    text = TransformerMTConfig(
        encoder_embed_dim=speech.encoder_embed_dim,
        encoder_ffn_embed_dim=speech.encoder_ffn_embed_dim,
        encoder_layers=6,
        encoder_attention_heads=speech.encoder_attention_heads,
        encoder_normalize_before=True,
        dropout=speech.dropout,
        attention_dropout=speech.attention_dropout,
        activation_dropout=speech.activation_dropout,
    ).replace(**{k: v for k, v in tx_kw.items() if k != "max_source_positions"})
    return S2TDualConfig(speech=speech, text=text).replace(**rest)

"""S2T with a wav2vec 2.0 front end (counterpart of
s2t_tpu/models/s2t_w2v2_transformer.py).

The encoder: the w2v features of the (B, N) waveform (span-masked in
training; ``freeze_w2v`` stops their gradient), a ``bridge`` projection when
the widths differ, a post-w2v ``S2TEncoderLayer`` stack [+ final norm] and an
optional CTC head; the port's Transformer decoder on top.  ``w2v_*`` keys of
the config route into the nested ``Wav2Vec2Config`` (``S2TW2V2Config.replace``).
The stack's self-attention takes a padding-only mask and runs the fused
attention kernel (K1f / K1b), where the JAX module passes an explicit padding
bias and attends densely.  ``extract_w2v_features`` is the transplant probe
point (the front end alone).

Decoding takes the collated waveforms of a ``use_audio_input`` split as they
are; training through the speech_to_text task's adapter fails as in JAX (its
fbank runs first, and the front end refuses (B, T, C) features), so the
model trains through the ``Trainer`` with ``wav2vec2.waveform_forward``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch
from torch import nn

from s2t_tpu_torch.device import resolve_device, torch_dtype
from s2t_tpu_torch.models.s2t_transformer import init_and_place, seeded_init
from s2t_tpu_torch.models.transformer_decoder import TransformerDecoder
from s2t_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Model
from s2t_tpu_torch.modules.ctc_head import CTCHead
from s2t_tpu_torch.modules.cast import Linear
from s2t_tpu_torch.modules.layers import S2TEncoderLayer, layer_norm
from s2t_tpu_torch.registry import register_model, register_model_architecture
from s2t_tpu_torch.utils.masking import lengths_to_mask


@dataclass(frozen=True)
class S2TW2V2Config:
    w2v: Wav2Vec2Config = field(default_factory=Wav2Vec2Config)
    freeze_w2v: bool = False
    encoder_layers: int = 6
    encoder_embed_dim: int = 512
    encoder_ffn_embed_dim: int = 2048
    encoder_attention_heads: int = 8
    encoder_normalize_before: bool = True
    use_ctc: bool = False
    decoder_layers: int = 6
    decoder_embed_dim: int = 512
    decoder_ffn_embed_dim: int = 2048
    decoder_attention_heads: int = 8
    decoder_normalize_before: bool = True
    share_decoder_input_output_embed: bool = True
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.1
    activation_fn: str = "relu"
    vocab_size: int = 1000
    src_vocab_size: int = -1
    input_feat_per_channel: int = 1
    input_channels: int = 1
    max_source_positions: int = 400000
    max_target_positions: int = 1024
    pad_id: int = 1
    dtype_str: str = "float32"

    def replace(self, **kw):
        w2v_kw = {k[4:]: v for k, v in kw.items() if k.startswith("w2v_")}
        rest = {k: v for k, v in kw.items() if not k.startswith("w2v_")}
        if w2v_kw:
            rest["w2v"] = (rest.get("w2v") or self.w2v).replace(**w2v_kw)
        return dataclasses.replace(self, **rest)

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype_str)

    @property
    def ctc_vocab_size(self):
        return self.src_vocab_size if self.src_vocab_size > 0 else self.vocab_size


class S2TW2V2Encoder(nn.Module):
    def __init__(self, cfg: S2TW2V2Config):
        super().__init__()
        self.cfg = cfg
        D = cfg.encoder_embed_dim
        self.w2v = Wav2Vec2Model(cfg.w2v, pretraining=False, place=False)
        self.bridge = Linear(cfg.w2v.encoder_embed_dim, D) if cfg.w2v.encoder_embed_dim != D \
            else None
        self.layers = nn.ModuleList([
            S2TEncoderLayer(D, cfg.encoder_ffn_embed_dim, cfg.encoder_attention_heads,
                            cfg.activation_fn, cfg.encoder_normalize_before, cfg.dropout,
                            cfg.attention_dropout, cfg.activation_dropout)
            for _ in range(cfg.encoder_layers)])
        self.final_norm = (layer_norm(D) if cfg.encoder_normalize_before and cfg.encoder_layers > 0
                           else None)
        self.ctc_head = CTCHead(D, cfg.ctc_vocab_size, dropout=cfg.dropout) if cfg.use_ctc \
            else None

    def forward(self, source, lengths, generator: Optional[torch.Generator] = None,
                draws=None) -> Dict[str, Any]:
        cfg = self.cfg
        train = generator is not None
        x, out_lengths = self.w2v.extract_features(source, lengths, train, generator,
                                                   apply_mask=train, draws=draws)
        if cfg.freeze_w2v:
            x = x.detach()
        x = x.to(cfg.dtype)
        if self.bridge is not None:
            x = self.bridge(x)
        valid = lengths_to_mask(out_lengths, x.shape[1])
        for layer in self.layers:
            x = layer(x, valid, None, generator)
        if self.final_norm is not None:
            x = self.final_norm(x)
        ctc_logits = self.ctc_head(x, None, generator) if self.ctc_head is not None else None
        return {"encoder_out": x, "encoder_lengths": out_lengths, "ctc_logits": ctc_logits,
                "inter_ctc_logits": (), "xctc_logits": None, "inter_xctc_logits": (),
                "mixup": None}


@register_model("s2t_w2v2_transformer")
class S2TW2V2TransformerModel(nn.Module):
    """The JAX model's ``init_cache`` takes no int8 mode and its ``decode_step`` no
    ancestry map, so the generator keeps its full-precision eager cache here."""

    @seeded_init
    def __init__(self, cfg: S2TW2V2Config, device="cuda", seed: int = 0,
                 for_training: bool = False):
        super().__init__()
        self.cfg = cfg
        self.encoder = S2TW2V2Encoder(cfg)
        self.decoder = TransformerDecoder(
            vocab_size=cfg.vocab_size, embed_dim=cfg.decoder_embed_dim,
            ffn_dim=cfg.decoder_ffn_embed_dim, num_layers=cfg.decoder_layers,
            num_heads=cfg.decoder_attention_heads, activation=cfg.activation_fn,
            normalize_before=cfg.decoder_normalize_before,
            share_input_output_embed=cfg.share_decoder_input_output_embed,
            max_positions=cfg.max_target_positions, pad_id=cfg.pad_id, dropout=cfg.dropout,
            attention_dropout=cfg.attention_dropout, activation_dropout=cfg.activation_dropout)
        init_and_place(self, cfg, resolve_device(device), seed, for_training)

    @property
    def device(self) -> torch.device:
        return self.decoder.embed_tokens.weight.device

    def forward(self, features, feat_lengths, prev_tokens, train: bool = False,
                generator: Optional[torch.Generator] = None, draws=None, **unused
                ) -> Dict[str, Any]:
        if train and generator is None:
            raise ValueError("train=True needs the step's torch.Generator")
        if not train:
            generator = None
        enc = self.encoder(features, feat_lengths, generator, draws)
        mask = lengths_to_mask(enc["encoder_lengths"], enc["encoder_out"].shape[1])
        logits = self.decoder(prev_tokens, enc["encoder_out"], mask, generator)
        return {"decoder_logits": logits, **enc}

    def encode(self, features, feat_lengths):
        return self.encoder(features, feat_lengths)

    def extract_w2v_features(self, source, lengths):
        return self.encoder.w2v.extract_features(source, lengths)

    def decode_step(self, tokens, cache, index, encoder_out, encoder_valid_mask, cross_kv=None):
        return self.decoder.step(tokens, cache, index, encoder_out, encoder_valid_mask,
                                 cross_kv=cross_kv)

    def precompute_cross(self, encoder_out):
        return self.decoder.precompute_cross(encoder_out)

    def init_cache(self, batch_size: int, max_len: int, kv_int8: bool = False):
        return self.decoder.init_cache(batch_size, max_len)


@register_model_architecture("s2t_w2v2_transformer", "s2t_w2v2_transformer")
@register_model_architecture("s2t_w2v2_transformer", "s2t_w2v2_transformer_base")
def s2t_w2v2_transformer_base(**kw) -> S2TW2V2Config:
    return S2TW2V2Config().replace(**kw)

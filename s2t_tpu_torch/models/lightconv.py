"""The LightConv / DynamicConv MT models (counterpart of s2t_tpu/models/lightconv.py).

Encoder and decoder stacks whose self-attention is a ``LightConvBlock`` (a
lightweight or a dynamic convolution, one kernel width a layer:
``encoder_kernel_sizes`` / ``decoder_kernel_sizes``), every sublayer pre-norm
with a residual: the encoder's block zeroes padded frames and pads centred, the
decoder's is causal and then cross-attends to the encoder (densely under a padding
bias, as in JAX: no kernel of the Pallas set runs here).  Embeddings scaled by
sqrt(D) plus sinusoidal positions, a final LayerNorm a side, the output projection
tied to the target table.  ``init_cache`` / ``decode_step`` keep each decoder
layer's window of its last k - 1 block inputs (``conv{i}``, which the beam
reorders whole).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from s2t_tpu_torch.device import resolve_device, torch_dtype
from s2t_tpu_torch.models.s2t_transformer import init_and_place, seeded_init
from s2t_tpu_torch.modules.attention import MultiHeadAttention, padding_bias
from s2t_tpu_torch.modules.dropout import dropout
from s2t_tpu_torch.modules.layers import FeedForward, layer_norm
from s2t_tpu_torch.modules.lightconv import LightConvBlock
from s2t_tpu_torch.modules.positional import sinusoidal_table
from s2t_tpu_torch.registry import register_model, register_model_architecture
from s2t_tpu_torch.utils.masking import lengths_to_mask


@dataclass(frozen=True)
class LightConvConfig:
    conv_type: str = "lightweight"  # lightweight | dynamic
    encoder_kernel_sizes: Tuple[int, ...] = (3, 7, 15, 31, 31, 31, 31)
    decoder_kernel_sizes: Tuple[int, ...] = (3, 7, 15, 31, 31, 31)
    encoder_embed_dim: int = 512
    encoder_conv_dim: int = 512
    encoder_ffn_embed_dim: int = 2048
    encoder_attention_heads: int = 8
    decoder_embed_dim: int = 512
    decoder_conv_dim: int = 512
    decoder_ffn_embed_dim: int = 2048
    decoder_attention_heads: int = 8
    encoder_glu: bool = True
    decoder_glu: bool = True
    dropout: float = 0.1
    attention_dropout: float = 0.1
    weight_dropout: float = 0.1
    share_decoder_input_output_embed: bool = True  # the JAX model always ties
    vocab_size: int = 1000
    src_vocab_size: int = -1
    max_source_positions: int = 1024
    max_target_positions: int = 1024
    pad_id: int = 1
    dtype_str: str = "float32"
    subsampling_layers: int = 0
    subsampling_stride: int = 1

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype_str)

    @property
    def src_vocab(self) -> int:
        return self.src_vocab_size if self.src_vocab_size > 0 else self.vocab_size

    @property
    def encoder_layers(self) -> int:
        return len(self.encoder_kernel_sizes)

    @property
    def decoder_layers(self) -> int:
        return len(self.decoder_kernel_sizes)


class LightConvEncoderLayer(nn.Module):
    def __init__(self, cfg: LightConvConfig, kernel_size: int):
        super().__init__()
        D = cfg.encoder_embed_dim
        self.p = cfg.dropout
        self.conv_norm = layer_norm(D)
        self.conv_block = LightConvBlock(D, cfg.encoder_conv_dim, kernel_size,
                                         cfg.encoder_attention_heads, cfg.conv_type,
                                         cfg.encoder_glu, False, cfg.weight_dropout)
        self.ffn_norm = layer_norm(D)
        self.ffn = FeedForward(D, cfg.encoder_ffn_embed_dim, "relu")

    def forward(self, x, valid, generator=None):
        h, _ = self.conv_block(self.conv_norm(x), valid, generator)
        x = x + dropout(h, self.p, generator)
        return x + dropout(self.ffn(self.ffn_norm(x), generator), self.p, generator)


class LightConvDecoderLayer(nn.Module):
    def __init__(self, cfg: LightConvConfig, kernel_size: int):
        super().__init__()
        D = cfg.decoder_embed_dim
        self.p = cfg.dropout
        self.conv_norm = layer_norm(D)
        self.conv_block = LightConvBlock(D, cfg.decoder_conv_dim, kernel_size,
                                         cfg.decoder_attention_heads, cfg.conv_type,
                                         cfg.decoder_glu, True, cfg.weight_dropout)
        self.cross_norm = layer_norm(D)
        self.cross_attn = MultiHeadAttention(D, cfg.decoder_attention_heads,
                                             cfg.attention_dropout, kv_dim=cfg.encoder_embed_dim)
        self.ffn_norm = layer_norm(D)
        self.ffn = FeedForward(D, cfg.decoder_ffn_embed_dim, "relu")

    def forward(self, x, enc_out, cross_bias, generator=None, cache=None):
        h, new_cache = self.conv_block(self.conv_norm(x), None, generator, cache)
        x = x + dropout(h, self.p, generator)
        h = self.cross_norm(x)
        h, _ = self.cross_attn(h, enc_out, enc_out, cross_bias, generator=generator)
        x = x + dropout(h, self.p, generator)
        x = x + dropout(self.ffn(self.ffn_norm(x), generator), self.p, generator)
        return x, new_cache


@register_model("lightconv")
class LightConvModel(nn.Module):
    kv_int8_cache = False

    @seeded_init
    def __init__(self, cfg: LightConvConfig, device="cuda", seed: int = 0,
                 for_training: bool = False):
        super().__init__()
        self.cfg = cfg
        self.src_embed = nn.Embedding(cfg.src_vocab, cfg.encoder_embed_dim)
        self.tgt_embed = nn.Embedding(cfg.vocab_size, cfg.decoder_embed_dim)
        self.encs = nn.ModuleList([LightConvEncoderLayer(cfg, k)
                                   for k in cfg.encoder_kernel_sizes])
        self.decs = nn.ModuleList([LightConvDecoderLayer(cfg, k)
                                   for k in cfg.decoder_kernel_sizes])
        self.enc_norm = layer_norm(cfg.encoder_embed_dim)
        self.dec_norm = layer_norm(cfg.decoder_embed_dim)
        init_and_place(self, cfg, resolve_device(device), seed, for_training)

    @property
    def device(self) -> torch.device:
        return self.tgt_embed.weight.device

    def encode(self, src_tokens, src_lengths=None,
               generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        cfg = self.cfg
        if src_lengths is None:
            src_lengths = (src_tokens != cfg.pad_id).sum(dim=1)
        dt, D = cfg.dtype, cfg.encoder_embed_dim
        x = self.src_embed(src_tokens).to(dt) * torch.tensor(math.sqrt(D), dtype=dt)
        x = x + sinusoidal_table(x.shape[1], D, cfg.pad_id, dt, x.device)[None]
        x = dropout(x, cfg.dropout, generator)
        valid = src_tokens != cfg.pad_id
        for layer in self.encs:
            x = layer(x, valid, generator)
        return {"encoder_out": self.enc_norm(x), "encoder_lengths": src_lengths,
                "ctc_logits": None, "inter_ctc_logits": (), "xctc_logits": None,
                "inter_xctc_logits": (), "mixup": None}

    def _embed_tgt(self, tokens, offset: int):
        cfg = self.cfg
        dt, D = cfg.dtype, cfg.decoder_embed_dim
        x = self.tgt_embed(tokens).to(dt) * torch.tensor(math.sqrt(D), dtype=dt)
        pe = sinusoidal_table(cfg.max_target_positions, D, cfg.pad_id, dt, x.device)
        return x + pe[offset:offset + tokens.shape[1]][None]

    def _logits(self, x):
        return self.dec_norm(x) @ self.tgt_embed.weight.to(x.dtype).t()

    def forward(self, src_tokens, src_lengths, prev_tokens, train: bool = False,
                generator: Optional[torch.Generator] = None, **unused) -> Dict[str, Any]:
        if train and generator is None:
            raise ValueError("train=True needs the step's torch.Generator")
        generator = generator if train else None
        enc = self.encode(src_tokens, src_lengths, generator)
        valid = lengths_to_mask(enc["encoder_lengths"], enc["encoder_out"].shape[1])
        cross_bias = padding_bias(valid, self.cfg.dtype)
        x = dropout(self._embed_tgt(prev_tokens, 0), self.cfg.dropout, generator)
        for layer in self.decs:
            x, _ = layer(x, enc["encoder_out"], cross_bias, generator)
        return {"decoder_logits": self._logits(x), **enc}

    def init_cache(self, batch_size: int, max_len: int, kv_int8: bool = False) -> dict:
        cfg = self.cfg
        return {f"conv{i}": self.tgt_embed.weight.new_zeros(
            (batch_size, k - 1, cfg.decoder_conv_dim), dtype=cfg.dtype)
            for i, k in enumerate(cfg.decoder_kernel_sizes)}

    def decode_step(self, tokens, cache, index, encoder_out, encoder_valid_mask, **unused):
        """(N, 1) tokens at ``index`` -> ((N, V) logits, cache); the windows are
        replaced in the dict."""
        cross_bias = padding_bias(encoder_valid_mask, self.cfg.dtype)
        x = self._embed_tgt(tokens, int(index))
        for i, layer in enumerate(self.decs):
            x, cache[f"conv{i}"] = layer(x, encoder_out, cross_bias, cache=cache[f"conv{i}"])
        return self._logits(x)[:, 0], cache


@register_model_architecture("lightconv", "lightconv")
@register_model_architecture("lightconv", "lightconv_iwslt_de_en")
def lightconv_iwslt(**kw) -> LightConvConfig:
    return LightConvConfig(
        encoder_embed_dim=512, encoder_conv_dim=512, encoder_ffn_embed_dim=1024,
        encoder_attention_heads=4, decoder_embed_dim=512, decoder_conv_dim=512,
        decoder_ffn_embed_dim=1024, decoder_attention_heads=4).replace(**kw)


@register_model_architecture("lightconv", "dynamicconv")
@register_model_architecture("lightconv", "dynamicconv_iwslt_de_en")
def dynamicconv_iwslt(**kw) -> LightConvConfig:
    return lightconv_iwslt(conv_type="dynamic").replace(**kw)

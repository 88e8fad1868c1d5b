"""Text Transformer for MT and its CTC variant (counterpart of s2t_tpu/models/transformer.py).

``TransformerModel``: token embeddings (scaled by sqrt(D) unless
``no_scale_embedding``) plus sinusoidal or learned pad-aware positions (or the
relative table of "rel_pos" attention), an optional ``layernorm_embedding``, a
stack of ``S2TEncoderLayer``s (pre- or post-norm, "abs" / Shaw "relative" /
"rel_pos" attention, the squeeze-excitation gate, DLCL), and the port's
``TransformerDecoder`` with its KV cache (full precision: the JAX model's
``init_cache`` has no int8 mode, so the generator falls back, as JAX's does).
``share_all_embeddings`` is a field of the JAX config that its model never reads:
the encoder and the decoder keep their own tables here too.

The encoder's self-attention takes a padding-only mask, so "abs" layers run the
fused kernel (K1f, and K1b in training), where the JAX encoder passes an
explicit padding bias and attends densely (transformer.py:177, :184); the two
agree.

``transformer_ctc`` adds a CTC head over the target vocabulary on the encoder,
inter-CTC taps behind a shared ``inter_ctc_norm``, and the token upsampling that
makes the CTC input long enough: every source id is repeated
``ctc_upsampling_ratio`` times before the embedding (:151-156), the encoder runs
at that rate, and with ``ctc_out_downsampling`` its output is pooled back to the
source rate for the decoder (max, mean, or JAX's ``jax.image.resize(...,
"linear")``, whose default antialiasing widens the triangle filter when it
shrinks, :196-210) while the CTC logits and ``ctc_lengths`` stay at the
upsampled rate.
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
from s2t_tpu_torch.models.transformer_decoder import TransformerDecoder
from s2t_tpu_torch.modules.ctc_head import CTCHead
from s2t_tpu_torch.modules.dlcl import DLCL
from s2t_tpu_torch.modules.dropout import dropout
from s2t_tpu_torch.modules.layers import S2TEncoderLayer, layer_norm
from s2t_tpu_torch.modules.positional import relative_encoding, sinusoidal_table
from s2t_tpu_torch.registry import register_model, register_model_architecture
from s2t_tpu_torch.utils.masking import lengths_to_mask

@dataclass(frozen=True)
class TransformerMTConfig:
    encoder_embed_dim: int = 512
    encoder_ffn_embed_dim: int = 2048
    encoder_layers: int = 6
    encoder_attention_heads: int = 8
    encoder_attention_type: str = "abs"
    encoder_normalize_before: bool = False
    encoder_learned_pos: bool = False
    decoder_embed_dim: int = 512
    decoder_ffn_embed_dim: int = 2048
    decoder_layers: int = 6
    decoder_attention_heads: int = 8
    decoder_normalize_before: bool = False
    decoder_learned_pos: bool = False
    share_decoder_input_output_embed: bool = True
    share_all_embeddings: bool = False  # read by nothing, as in JAX
    no_scale_embedding: bool = False
    layernorm_embedding: bool = False
    squeeze_excitation: bool = False
    use_enc_dlcl: bool = False
    max_encoder_relative_length: int = 0
    max_decoder_relative_length: int = 0
    dropout: float = 0.1
    attention_dropout: float = 0.0
    activation_dropout: float = 0.0
    activation_fn: str = "relu"
    use_ctc: bool = False
    inter_ctc_layers: Tuple[int, ...] = ()
    ctc_upsampling_ratio: int = 3
    ctc_out_downsampling: bool = False
    ctc_out_downsampling_method: str = "maxpooling"
    vocab_size: int = 1000
    src_vocab_size: int = -1
    max_source_positions: int = 1024
    max_target_positions: int = 1024
    pad_id: int = 1
    dtype_str: str = "float32"
    # the generator's length bound reads these (no subsampling over tokens)
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


def antialiased_linear_weights(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """(n_in, n_out) weights of ``jax.image.resize(..., method="linear")`` along one
    axis, antialiased as its default: the triangle filter widened by n_in / n_out
    when it shrinks, each column normalised, columns whose sample falls outside
    the input zeroed (jax/_src/image/scale.py ``compute_weight_mat``)."""
    inv_scale = torch.tensor(1.0 / (n_out / n_in), dtype=torch.float32)  # JAX's Python scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs() / kernel_scale
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0).to(device)


class TransformerTextEncoder(nn.Module):
    """(src_tokens (B, S), src_lengths) -> {"encoder_out", "encoder_lengths",
    "ctc_lengths", "ctc_logits", "inter_ctc_logits", ...} (transformer.py:98-219)."""

    def __init__(self, cfg: TransformerMTConfig, embed_tokens: Optional[nn.Module] = None):
        super().__init__()
        self.cfg = cfg
        D = cfg.encoder_embed_dim
        if embed_tokens is None:
            self.embed_tokens = nn.Embedding(cfg.src_vocab, D)
        else:  # a table its parent owns (BART's shared one), kept out of this module's params
            object.__setattr__(self, "embed_tokens", embed_tokens)
        self.embed_positions = (nn.Embedding(cfg.max_source_positions + 2, D)
                                if cfg.encoder_learned_pos else None)
        self.emb_norm = layer_norm(D) if cfg.layernorm_embedding else None
        self.layers = nn.ModuleList([
            S2TEncoderLayer(D, cfg.encoder_ffn_embed_dim, cfg.encoder_attention_heads,
                            cfg.activation_fn, cfg.encoder_normalize_before, cfg.dropout,
                            cfg.attention_dropout, cfg.activation_dropout,
                            cfg.encoder_attention_type,
                            max_relative_length=cfg.max_encoder_relative_length,
                            use_se=cfg.squeeze_excitation)
            for _ in range(cfg.encoder_layers)])
        self.dlcl = DLCL(cfg.encoder_layers, D) if cfg.use_enc_dlcl else None
        self.final_norm = layer_norm(D) if cfg.encoder_normalize_before else None
        self.ctc_head = CTCHead(D, cfg.vocab_size, dropout=cfg.dropout) if cfg.use_ctc else None
        self.inter_ctc_norm = (layer_norm(D) if cfg.use_ctc and cfg.inter_ctc_layers else None)

    def _downsample(self, x: torch.Tensor) -> torch.Tensor:
        r = self.cfg.ctc_upsampling_ratio
        B, Tr, C = x.shape
        m = self.cfg.ctc_out_downsampling_method
        if m == "maxpooling":
            return x.reshape(B, Tr // r, r, C).amax(dim=2)
        if m == "avgpooling":
            return x.reshape(B, Tr // r, r, C).mean(dim=2)
        # any other method ("upsampling", "interpolate") is JAX's linear resize
        w = antialiased_linear_weights(Tr, Tr // r, x.device).to(x.dtype)
        return torch.einsum("btc,ts->bsc", x, w)

    def forward(self, src_tokens: torch.Tensor, src_lengths: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        cfg = self.cfg
        if src_lengths is None:
            src_lengths = (src_tokens != cfg.pad_id).sum(dim=1)
        org_lengths = src_lengths
        upsampled = cfg.use_ctc and cfg.ctc_upsampling_ratio > 1
        if upsampled:
            # pads repeat into pads, so the mask stays the tokens'
            src_tokens = src_tokens.repeat_interleave(cfg.ctc_upsampling_ratio, dim=1)
            src_lengths = src_lengths * cfg.ctc_upsampling_ratio
        dt = cfg.dtype
        x = self.embed_tokens(src_tokens).to(dt)
        if not cfg.no_scale_embedding:
            x = x * torch.tensor(math.sqrt(cfg.encoder_embed_dim), dtype=dt)
        T = x.shape[1]
        pos_emb = None
        if cfg.encoder_attention_type == "rel_pos":
            pos_emb = relative_encoding(T, cfg.encoder_embed_dim).to(x.device, dt)
        elif self.embed_positions is not None:
            v = (src_tokens != cfg.pad_id).long()
            x = x + self.embed_positions(torch.cumsum(v, dim=1) * v + cfg.pad_id).to(dt)
        else:
            x = x + sinusoidal_table(T, cfg.encoder_embed_dim, cfg.pad_id, dt, x.device)[None]
        if self.emb_norm is not None:
            x = self.emb_norm(x)
        x = dropout(x, cfg.dropout, generator)
        valid = src_tokens != cfg.pad_id

        inter = []
        history = [x] if self.dlcl is not None else None
        for i, layer in enumerate(self.layers):
            if self.dlcl is not None:
                x = self.dlcl.combine(history, i)
            x = layer(x, valid, None, generator, pos_emb)
            if self.dlcl is not None:
                history.append(x)
            if self.ctc_head is not None and (i + 1) in cfg.inter_ctc_layers:
                inter.append((i + 1, self.ctc_head(self.inter_ctc_norm(x), generator=generator)))
        if self.dlcl is not None:
            x = self.dlcl.combine(history, cfg.encoder_layers)
        if self.final_norm is not None:
            x = self.final_norm(x)
        ctc_logits = self.ctc_head(x, generator=generator) if self.ctc_head is not None else None
        ctc_lengths = src_lengths
        if upsampled and cfg.ctc_out_downsampling:
            x = self._downsample(x)
            src_lengths = org_lengths
        return {"encoder_out": x, "encoder_lengths": src_lengths, "ctc_lengths": ctc_lengths,
                "ctc_logits": ctc_logits, "inter_ctc_logits": tuple(inter),
                "xctc_logits": None, "inter_xctc_logits": (), "mixup": None}


@register_model("transformer")
class TransformerModel(nn.Module):
    """``forward(src_tokens, src_lengths, prev_tokens, train, generator)`` ->
    {"decoder_logits", **the encoder's outputs}, with the generator's surface
    (``encode``, ``decode_step``, ``init_cache``, ``precompute_cross``).  Weights
    from ``seed``; serving (frozen, stored in ``cfg.dtype``) or ``for_training``
    (float32 masters)."""

    kv_int8_cache = False  # JAX's init_cache here has no int8 mode

    @seeded_init
    def __init__(self, cfg: TransformerMTConfig, device="cuda", seed: int = 0,
                 for_training: bool = False):
        super().__init__()
        self.cfg = cfg
        self.encoder = TransformerTextEncoder(cfg)
        self.decoder = TransformerDecoder(
            vocab_size=cfg.vocab_size, embed_dim=cfg.decoder_embed_dim,
            ffn_dim=cfg.decoder_ffn_embed_dim, num_layers=cfg.decoder_layers,
            num_heads=cfg.decoder_attention_heads, activation=cfg.activation_fn,
            normalize_before=cfg.decoder_normalize_before,
            share_input_output_embed=cfg.share_decoder_input_output_embed,
            max_positions=cfg.max_target_positions, pad_id=cfg.pad_id, dropout=cfg.dropout,
            attention_dropout=cfg.attention_dropout, activation_dropout=cfg.activation_dropout,
            self_attn_type="relative" if cfg.max_decoder_relative_length > 0 else "abs",
            max_relative_length=cfg.max_decoder_relative_length,
            learned_pos=cfg.decoder_learned_pos, no_scale_embedding=cfg.no_scale_embedding,
            layernorm_embedding=cfg.layernorm_embedding, encoder_dim=cfg.encoder_embed_dim)
        init_and_place(self, cfg, resolve_device(device), seed, for_training)

    @property
    def device(self) -> torch.device:
        return self.decoder.embed_tokens.weight.device

    def forward(self, src_tokens, src_lengths, prev_tokens, train: bool = False,
                generator: Optional[torch.Generator] = None, **unused) -> Dict[str, Any]:
        if train and generator is None:
            raise ValueError("train=True needs the step's torch.Generator")
        generator = generator if train else None
        enc = self.encoder(src_tokens, src_lengths, generator)
        mask = lengths_to_mask(enc["encoder_lengths"], enc["encoder_out"].shape[1])
        logits = self.decoder(prev_tokens, enc["encoder_out"], mask, generator)
        return {"decoder_logits": logits, **enc}

    def encode(self, src_tokens, src_lengths):
        return self.encoder(src_tokens, src_lengths)

    def decode(self, prev_tokens, encoder_out, encoder_valid_mask):
        return self.decoder(prev_tokens, encoder_out, encoder_valid_mask)

    def decode_step(self, tokens, cache, index, encoder_out, encoder_valid_mask, cross_kv=None):
        return self.decoder.step(tokens, cache, index, encoder_out, encoder_valid_mask,
                                 cross_kv=cross_kv)

    def precompute_cross(self, encoder_out):
        return self.decoder.precompute_cross(encoder_out)

    def init_cache(self, batch_size: int, max_len: int, kv_int8: bool = False):
        return self.decoder.init_cache(batch_size, max_len)


def text_forward(model, batch: Dict[str, Any], train: bool = False,
                 generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
    """The forward adapter of the translation tasks (s2t_tpu/tasks/translation.py:104-140)."""
    return model(batch["src_tokens"], batch["src_lengths"], batch["prev_tokens"], train=train,
                 generator=generator)


@register_model_architecture("transformer", "transformer")
def transformer_base(**kw) -> TransformerMTConfig:
    return TransformerMTConfig().replace(**kw)


@register_model_architecture("transformer", "transformer_iwslt_de_en")
def transformer_iwslt(**kw) -> TransformerMTConfig:
    return TransformerMTConfig(
        encoder_embed_dim=512, encoder_ffn_embed_dim=1024, encoder_attention_heads=4,
        decoder_embed_dim=512, decoder_ffn_embed_dim=1024, decoder_attention_heads=4,
    ).replace(**kw)


@register_model_architecture("transformer", "transformer_wmt_en_de_big")
def transformer_big(**kw) -> TransformerMTConfig:
    return TransformerMTConfig(
        encoder_embed_dim=1024, encoder_ffn_embed_dim=4096, encoder_attention_heads=16,
        decoder_embed_dim=1024, decoder_ffn_embed_dim=4096, decoder_attention_heads=16,
        dropout=0.3,
    ).replace(**kw)


@register_model_architecture("transformer", "transformer_wmt_en_de_big_t2t")
def transformer_big_t2t(**kw) -> TransformerMTConfig:
    """tensor2tensor's variant: pre-norm, attention and relu dropout."""
    return transformer_big(
        encoder_normalize_before=True, decoder_normalize_before=True,
        attention_dropout=0.1, activation_dropout=0.1,
    ).replace(**kw)


@register_model_architecture("transformer", "transformer_ctc")
def transformer_ctc(**kw) -> TransformerMTConfig:
    """MT with a target-vocabulary CTC head on the encoder."""
    return TransformerMTConfig(
        use_ctc=True, encoder_normalize_before=True, decoder_normalize_before=True,
    ).replace(**kw)

"""The multilingual Transformer: one encoder a source language and one decoder a
target language, shared as configured (counterpart of
s2t_tpu/models/multilingual_transformer.py:41-249).

The modules are the port's ``TransformerTextEncoder`` and ``TransformerDecoder``,
named as flax names them: ``encoder_{lang}`` (``encoder_shared`` with
``share_encoders``), ``decoder_{lang}`` (``decoder_shared``), and the shared tables
``shared_embed`` (``share_all_embeddings``, both sides; the widths must agree),
``shared_encoder_embed`` (``share_encoder_embeddings``, implied by
``share_encoders``) and ``shared_decoder_embed`` (``share_decoder_embeddings``,
implied by ``share_decoders``).  A shared module or table is one parameter: the model
registers it once and the others borrow it unregistered, so the state dict, the
optimizer and ``from_flax`` see it once.  Unlike the text Transformer's, this model
reads ``share_all_embeddings``.

A table that is not shared has ``lang_vocab_sizes``' entry for its language, else
the target ``vocab_size``, on the encoder side too (JAX's ``_vocab``, :76-80); the
task passes the source dictionary's size as ``src_vocab_size``, which only a shared
encoder table takes.  A source id past an encoder's table is a NaN row in JAX (flax's
``Embed`` gathers in fill mode); here it raises ``ValueError`` (ROADMAP.md section 3).

``forward(pairs, train, generator)`` takes a round-robin zip batch ``{pair:
{"src_tokens", "src_lengths", "prev_tokens", ...}}`` and returns ``{"pairs": {pair:
{"decoder_logits", **the encoder's outputs}}}``, every pair in one step.
``pair_view(pair)`` is a single-pair model over the same modules with the generator's
surface (``forward_pair``, ``encode``, ``decode``, ``decode_step``,
``precompute_cross``, ``init_cache``), so ``SequenceGenerator`` drives it unchanged.
The encoders' self-attention takes a padding-only mask: the fused kernel, K1f (and
K1b in training) once a layer a pair; the causal decoders attend densely, as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from s2t_tpu_torch.device import resolve_device
from s2t_tpu_torch.models.s2t_transformer import init_and_place, seeded_init
from s2t_tpu_torch.models.transformer import TransformerMTConfig, TransformerTextEncoder
from s2t_tpu_torch.models.transformer_decoder import TransformerDecoder
from s2t_tpu_torch.registry import register_model, register_model_architecture
from s2t_tpu_torch.utils.masking import lengths_to_mask


@dataclass(frozen=True)
class MultilingualTransformerConfig(TransformerMTConfig):
    lang_pairs: Tuple[str, ...] = ()  # "src-tgt"; the task passes them
    share_encoder_embeddings: bool = False
    share_decoder_embeddings: bool = False
    share_encoders: bool = False
    share_decoders: bool = False
    # per-language table sizes of separate dictionaries, (("en", 32000), ...); empty:
    # vocab_size for every language
    lang_vocab_sizes: Tuple[Tuple[str, int], ...] = ()


def _uniq(seq):
    return list(dict.fromkeys(seq))


def _borrow(module: nn.Module, name: str, table: nn.Module) -> None:
    """``module.name`` becomes ``table`` without registering it (its owner does)."""
    module._modules.pop(name, None)
    object.__setattr__(module, name, table)


@register_model("multilingual_transformer")
class MultilingualTransformerModel(nn.Module):
    kv_int8_cache = False  # the decoders' init_cache has no int8 mode, as in JAX

    @seeded_init
    def __init__(self, cfg: MultilingualTransformerConfig, device="cuda", seed: int = 0,
                 for_training: bool = False):
        super().__init__()
        if not cfg.lang_pairs:
            raise ValueError("multilingual_transformer needs lang_pairs")
        self.cfg = cfg
        src_langs = _uniq(p.split("-")[0] for p in cfg.lang_pairs)
        tgt_langs = _uniq(p.split("-")[1] for p in cfg.lang_pairs)
        share_enc_emb = cfg.share_encoder_embeddings or cfg.share_all_embeddings \
            or cfg.share_encoders
        share_dec_emb = cfg.share_decoder_embeddings or cfg.share_all_embeddings \
            or cfg.share_decoders
        enc_table = dec_table = None
        if cfg.share_all_embeddings:
            if cfg.encoder_embed_dim != cfg.decoder_embed_dim:
                raise ValueError("share_all_embeddings requires encoder_embed_dim == "
                                 "decoder_embed_dim")
            self.shared_embed = enc_table = dec_table = nn.Embedding(cfg.vocab_size,
                                                                     cfg.encoder_embed_dim)
        else:
            if share_enc_emb:
                self.shared_encoder_embed = enc_table = nn.Embedding(cfg.src_vocab,
                                                                     cfg.encoder_embed_dim)
            if share_dec_emb:
                self.shared_decoder_embed = dec_table = nn.Embedding(cfg.vocab_size,
                                                                     cfg.decoder_embed_dim)

        def encoder(lang):
            sub = cfg.replace(src_vocab_size=cfg.src_vocab if share_enc_emb
                              else self._vocab(lang))
            return TransformerTextEncoder(sub, embed_tokens=enc_table)

        def decoder(lang):
            dec = TransformerDecoder(
                vocab_size=cfg.vocab_size if share_dec_emb else self._vocab(lang),
                embed_dim=cfg.decoder_embed_dim, ffn_dim=cfg.decoder_ffn_embed_dim,
                num_layers=cfg.decoder_layers, num_heads=cfg.decoder_attention_heads,
                activation=cfg.activation_fn, normalize_before=cfg.decoder_normalize_before,
                share_input_output_embed=cfg.share_decoder_input_output_embed,
                max_positions=cfg.max_target_positions, pad_id=cfg.pad_id, dropout=cfg.dropout,
                attention_dropout=cfg.attention_dropout,
                activation_dropout=cfg.activation_dropout, learned_pos=cfg.decoder_learned_pos,
                no_scale_embedding=cfg.no_scale_embedding,
                layernorm_embedding=cfg.layernorm_embedding, encoder_dim=cfg.encoder_embed_dim,
                embed_tokens=dec_table)
            if dec_table is not None:
                _borrow(dec, "embed_tokens", dec_table)
            return dec

        # one module a language, or one for all; a plain dict keeps the lookup unregistered
        self.encoders: Dict[str, TransformerTextEncoder] = {}
        self.decoders: Dict[str, TransformerDecoder] = {}
        for langs, make, side, shared, table in (
                (src_langs, encoder, "encoder", cfg.share_encoders, self.encoders),
                (tgt_langs, decoder, "decoder", cfg.share_decoders, self.decoders)):
            for lang in langs:
                name = f"{side}_shared" if shared else f"{side}_{lang}"
                if name not in self._modules:
                    self.add_module(name, make(lang))
                table[lang] = self._modules[name]
        init_and_place(self, cfg, resolve_device(device), seed, for_training)

    def _vocab(self, lang: str) -> int:
        return dict(self.cfg.lang_vocab_sizes).get(lang, self.cfg.vocab_size)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def encode_lang(self, lang: str, src_tokens, src_lengths, generator=None) -> Dict[str, Any]:
        enc = self.encoders[lang]
        rows = enc.embed_tokens.num_embeddings
        if rows < self.cfg.src_vocab:  # only a table sized below the source dictionary
            top = int(src_tokens.max())
            if top >= rows:
                raise ValueError(
                    f"source id {top} is past encoder {lang!r}'s table of {rows} rows (its "
                    f"size is the target vocab_size or lang_vocab_sizes'; JAX reads a NaN row "
                    f"there); share the encoder embeddings or set lang_vocab_sizes")
        return enc(src_tokens, src_lengths, generator)

    def forward_pair(self, pair: str, src_tokens, src_lengths, prev_tokens,
                     generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        src, tgt = pair.split("-")
        enc = self.encode_lang(src, src_tokens, src_lengths, generator)
        mask = lengths_to_mask(enc["encoder_lengths"], enc["encoder_out"].shape[1])
        logits = self.decoders[tgt](prev_tokens, enc["encoder_out"], mask, generator)
        return {"decoder_logits": logits, **enc}

    def forward(self, pairs: Dict[str, Dict[str, torch.Tensor]], train: bool = False,
                generator: Optional[torch.Generator] = None, **unused) -> Dict[str, Any]:
        """Every configured pair present in ``pairs``, in ``lang_pairs`` order."""
        if not isinstance(pairs, dict):
            raise ValueError("the all-pairs forward takes a {pair: batch} dict; use "
                             "pair_view(pair) for one pair")
        if train and generator is None:
            raise ValueError("train=True needs the step's torch.Generator")
        generator = generator if train else None
        out = {}
        for pair in self.cfg.lang_pairs:
            if pair in pairs:
                b = pairs[pair]
                out[pair] = self.forward_pair(pair, b["src_tokens"], b["src_lengths"],
                                              b["prev_tokens"], generator)
        return {"pairs": out}

    def pair_view(self, pair: str) -> "PairView":
        if pair not in self.cfg.lang_pairs:
            raise KeyError(f"unknown lang pair {pair!r} (the model's: {self.cfg.lang_pairs})")
        return PairView(self, pair)


class PairView:
    """One pair of a ``MultilingualTransformerModel``: its modules, copied nowhere."""

    kv_int8_cache = False

    def __init__(self, model: MultilingualTransformerModel, pair: str):
        self.model, self.pair, self.cfg = model, pair, model.cfg
        self.src, self.tgt = pair.split("-")

    @property
    def device(self) -> torch.device:
        return self.model.device

    @property
    def decoder(self) -> TransformerDecoder:
        return self.model.decoders[self.tgt]

    def forward_pair(self, src_tokens, src_lengths, prev_tokens, train: bool = False,
                     generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        return self.model.forward_pair(self.pair, src_tokens, src_lengths, prev_tokens,
                                       generator if train else None)

    def encode(self, src_tokens, src_lengths):
        return self.model.encode_lang(self.src, src_tokens, src_lengths)

    def decode(self, prev_tokens, encoder_out, encoder_valid_mask):
        return self.decoder(prev_tokens, encoder_out, encoder_valid_mask)

    def decode_step(self, tokens, cache, index, encoder_out, encoder_valid_mask, cross_kv=None):
        return self.decoder.step(tokens, cache, index, encoder_out, encoder_valid_mask,
                                 cross_kv=cross_kv)

    def precompute_cross(self, encoder_out):
        return self.decoder.precompute_cross(encoder_out)

    def init_cache(self, batch_size: int, max_len: int, kv_int8: bool = False):
        return self.decoder.init_cache(batch_size, max_len)


@register_model_architecture("multilingual_transformer", "multilingual_transformer")
def multilingual_transformer(**kw) -> MultilingualTransformerConfig:
    return MultilingualTransformerConfig().replace(**kw)


@register_model_architecture("multilingual_transformer", "multilingual_transformer_iwslt_de_en")
def multilingual_transformer_iwslt(**kw) -> MultilingualTransformerConfig:
    """512 / 1024, 4 heads a side (:235-249)."""
    return MultilingualTransformerConfig(
        encoder_embed_dim=512, encoder_ffn_embed_dim=1024, encoder_attention_heads=4,
        decoder_embed_dim=512, decoder_ffn_embed_dim=1024, decoder_attention_heads=4,
    ).replace(**kw)

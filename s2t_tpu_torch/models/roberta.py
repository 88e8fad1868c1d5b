"""RoBERTa / BERT: a post-norm Transformer encoder with a masked-LM head and an
optional sentence-classification head (counterpart of s2t_tpu/models/roberta.py:25-173).

Token embeddings plus learned positions offset past pad (``cumsum(valid) * valid +
pad_id``, :101-102), optional segment embeddings (``num_segments``, BERT's sentence
pairs), ``emb_norm`` and dropout, then ``encoder_layers`` post-norm
``S2TEncoderLayer``s.  The LM head is ``lm_dense`` -> GELU (flax's default, the tanh
form) -> ``lm_norm`` -> the token table's transpose + ``lm_bias``; with
``num_classes`` > 0 the classification head is tanh(``cls_dense(x[:, 0])``) ->
dropout -> ``cls_out``.  Tables are N(0, 0.02), as flax initialises them.

The layers' self-attention takes a padding-only mask, so it runs the fused kernel
(K1f, and K1b in training), one launch a layer, where JAX attends densely under a
padding bias on the CPU and through ``_pallas_attention_padded`` on its chip.  The
kernel reads each row's count of valid tokens: the tokens go valid-first
(``utils/masking.valid_first``, the identity for a padded-at-the-end block) through
the layers and back, so a pad inside a row cannot shift the mask.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from s2t_tpu_torch.device import resolve_device, torch_dtype
from s2t_tpu_torch.models.s2t_transformer import init_and_place, seeded_init
from s2t_tpu_torch.modules.cast import Linear
from s2t_tpu_torch.modules.dropout import dropout
from s2t_tpu_torch.modules.layers import S2TEncoderLayer, layer_norm
from s2t_tpu_torch.registry import register_model, register_model_architecture
from s2t_tpu_torch.utils.masking import valid_first

TABLE_STD = 0.02


@dataclass(frozen=True)
class RobertaConfig:
    encoder_embed_dim: int = 768
    encoder_ffn_embed_dim: int = 3072
    encoder_layers: int = 12
    encoder_attention_heads: int = 12
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.0
    activation_fn: str = "gelu"
    max_positions: int = 512
    vocab_size: int = 50265
    pad_id: int = 1
    num_classes: int = 0  # > 0 adds the sentence-classification head
    num_segments: int = 0  # > 0 adds segment (token-type) embeddings
    dtype_str: str = "float32"
    max_target_positions: int = 512  # the LM tasks' plumbing

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype_str)


def _table(rows: int, dim: int) -> nn.Embedding:
    table = nn.Embedding(rows, dim)
    table.init_std = TABLE_STD
    return table


@register_model("roberta")
class RobertaModel(nn.Module):
    @seeded_init
    def __init__(self, cfg: RobertaConfig, device="cuda", seed: int = 0,
                 for_training: bool = False):
        super().__init__()
        self.cfg = cfg
        D = cfg.encoder_embed_dim
        self.embed_tokens = _table(cfg.vocab_size, D)
        self.embed_positions = _table(cfg.max_positions + 2, D)
        self.embed_segments = _table(cfg.num_segments, D) if cfg.num_segments > 0 else None
        self.emb_norm = layer_norm(D)
        self.layers = nn.ModuleList([
            S2TEncoderLayer(D, cfg.encoder_ffn_embed_dim, cfg.encoder_attention_heads,
                            cfg.activation_fn, False, cfg.dropout, cfg.attention_dropout,
                            cfg.activation_dropout)
            for _ in range(cfg.encoder_layers)])
        self.lm_dense = Linear(D, D)
        self.lm_norm = layer_norm(D)
        self.lm_bias = nn.Parameter(torch.zeros(cfg.vocab_size))
        if cfg.num_classes > 0:
            self.cls_dense = Linear(D, D)
            self.cls_out = Linear(D, cfg.num_classes)
        init_and_place(self, cfg, resolve_device(device), seed, for_training)

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.weight.device

    def encode(self, tokens: torch.Tensor, generator: Optional[torch.Generator] = None,
               segments: Optional[torch.Tensor] = None):
        """(B, L) tokens -> ((B, L, D) features, (B, L) valid mask)."""
        cfg = self.cfg
        dt = cfg.dtype
        valid = tokens != cfg.pad_id
        v = valid.long()
        x = self.embed_tokens(tokens).to(dt) + \
            self.embed_positions(torch.cumsum(v, dim=1) * v + cfg.pad_id).to(dt)
        if self.embed_segments is not None and segments is not None:
            x = x + self.embed_segments(segments.long()).to(dt)
        x = dropout(self.emb_norm(x), cfg.dropout, generator)
        order = valid_first(valid)
        rows = torch.arange(x.shape[0], device=x.device)[:, None]
        x, packed = x[rows, order], valid[rows, order]
        for layer in self.layers:
            x = layer(x, packed, None, generator)
        return x[rows, torch.argsort(order, dim=1)], valid

    def forward(self, tokens: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None, classification: bool = False,
                segments: Optional[torch.Tensor] = None, **unused) -> Dict[str, Any]:
        """{"encoder_out", "lm_logits" (B, L, V), and with ``classification`` and a
        head "cls_logits" (B, num_classes)}."""
        if train and generator is None:
            raise ValueError("train=True needs the step's torch.Generator")
        generator = generator if train else None
        x, _ = self.encode(tokens, generator, segments)
        h = self.lm_norm(F.gelu(self.lm_dense(x), approximate="tanh"))
        out: Dict[str, Any] = {
            "encoder_out": x,
            "lm_logits": h @ self.embed_tokens.weight.to(h.dtype).t() + self.lm_bias.to(h.dtype)}
        if classification and self.cfg.num_classes > 0:
            cls = torch.tanh(self.cls_dense(x[:, 0]))
            out["cls_logits"] = self.cls_out(dropout(cls, self.cfg.dropout, generator))
        return out


@register_model_architecture("roberta", "roberta_base")
def roberta_base(**kw) -> RobertaConfig:
    return RobertaConfig().replace(**kw)


@register_model_architecture("roberta", "bert_base")
def bert_base(**kw) -> RobertaConfig:
    """BERT's sentence pairs: segment embeddings and the 2-way (next sentence) head."""
    return RobertaConfig(num_segments=2, num_classes=2).replace(**kw)


@register_model_architecture("roberta", "roberta_large")
def roberta_large(**kw) -> RobertaConfig:
    return RobertaConfig(encoder_embed_dim=1024, encoder_ffn_embed_dim=4096, encoder_layers=24,
                         encoder_attention_heads=16).replace(**kw)


# the language-specific variants are RoBERTa over other corpora and tables
@register_model_architecture("roberta", "camembert")
def camembert(**kw) -> RobertaConfig:
    return RobertaConfig(vocab_size=32005).replace(**kw)


@register_model_architecture("roberta", "gottbert")
def gottbert(**kw) -> RobertaConfig:
    return RobertaConfig(vocab_size=52009).replace(**kw)


@register_model_architecture("roberta", "xlmr_base")
def xlmr_base(**kw) -> RobertaConfig:
    return RobertaConfig(vocab_size=250002).replace(**kw)


@register_model_architecture("roberta", "xlmr_large")
def xlmr_large(**kw) -> RobertaConfig:
    return roberta_large(vocab_size=250002).replace(**kw)

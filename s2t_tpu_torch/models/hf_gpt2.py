"""GPT-2 as a decoder-only language model (counterpart of s2t_tpu/models/hf_gpt2.py:29-103).

GPT-2's graph on the port's ``TransformerDecoder``: pre-norm, no cross-attention,
tanh GELU (Hugging Face's "gelu_new"), learned positions, the output tied to the
token table, no embedding scale.  It trains through ``language_modeling``
(``forward(prev_tokens)`` -> ``decoder_logits``) and decodes incrementally
(``decode_step`` / ``init_cache``).  Its causal self-attention is dense, in JAX too:
no kernel of the port runs.  The Hugging Face checkpoint import of the JAX package
(``interop/hf_import.py``) is not ported; ``interop/from_flax`` carries JAX's
weights.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
from torch import nn

from s2t_tpu_torch.device import resolve_device, torch_dtype
from s2t_tpu_torch.models.s2t_transformer import init_and_place, seeded_init
from s2t_tpu_torch.models.transformer_decoder import TransformerDecoder
from s2t_tpu_torch.registry import register_model, register_model_architecture


@dataclass(frozen=True)
class HFGPT2Config:
    decoder_embed_dim: int = 768
    decoder_ffn_embed_dim: int = 3072
    decoder_layers: int = 12
    decoder_attention_heads: int = 12
    dropout: float = 0.1
    attention_dropout: float = 0.1
    vocab_size: int = 50257
    max_target_positions: int = 1024
    pad_id: int = 1
    dtype_str: str = "float32"

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype_str)


@register_model("hf_gpt2")
class HFGPT2Model(nn.Module):
    @seeded_init
    def __init__(self, cfg: HFGPT2Config, device="cuda", seed: int = 0,
                 for_training: bool = False):
        super().__init__()
        self.cfg = cfg
        self.decoder = TransformerDecoder(
            vocab_size=cfg.vocab_size, embed_dim=cfg.decoder_embed_dim,
            ffn_dim=cfg.decoder_ffn_embed_dim, num_layers=cfg.decoder_layers,
            num_heads=cfg.decoder_attention_heads, activation="gelu_tanh",
            normalize_before=True, share_input_output_embed=True,
            max_positions=cfg.max_target_positions, pad_id=cfg.pad_id, dropout=cfg.dropout,
            attention_dropout=cfg.attention_dropout, no_cross_attention=True, learned_pos=True,
            no_scale_embedding=True)
        init_and_place(self, cfg, resolve_device(device), seed, for_training)

    @property
    def device(self) -> torch.device:
        return self.decoder.positions.device

    def forward(self, prev_tokens: torch.Tensor, targets: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """(B, U) tokens -> {"decoder_logits": (B, U, V)}."""
        return {"decoder_logits": self.decoder(prev_tokens, None, None, generator)}

    def decode_step(self, tokens, cache, index):
        return self.decoder.step(tokens, cache, index, None, None)

    def init_cache(self, batch_size: int, max_len: int):
        return self.decoder.init_cache(batch_size, max_len)


@register_model_architecture("hf_gpt2", "hf_gpt2")
def hf_gpt2(**kw) -> HFGPT2Config:
    return HFGPT2Config().replace(**kw)


@register_model_architecture("hf_gpt2", "hf_gpt2_medium")
def hf_gpt2_medium(**kw) -> HFGPT2Config:
    return HFGPT2Config(decoder_embed_dim=1024, decoder_ffn_embed_dim=4096, decoder_layers=24,
                        decoder_attention_heads=16).replace(**kw)


@register_model_architecture("hf_gpt2", "hf_gpt2_large")
def hf_gpt2_large(**kw) -> HFGPT2Config:
    return HFGPT2Config(decoder_embed_dim=1280, decoder_ffn_embed_dim=5120, decoder_layers=36,
                        decoder_attention_heads=20).replace(**kw)

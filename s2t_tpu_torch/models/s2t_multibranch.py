"""Multi-branch speech model (counterpart of s2t_tpu/models/s2t_multibranch.py).

A junior acoustic encoder (the port's ``S2TTransformerEncoder`` with its CTC
head) feeds a senior acoustic branch and a textual branch, each through an
optional PAE ``Adapter`` over the junior's CTC posterior.  The senior input
path is adapter -> padding zeroed -> [its own embed norm] -> scale ->
sinusoidal positions -> dropout; the textual one adapter -> positions ->
dropout; both are zeroed at padding before the loop.  The branches advance in
the reference's interleaved order (``collaboration_direction`` acoustic /
textual / both / none, ``collaboration_start``, ``collaboration_step``), each
collaborating layer league-attending the other branch's current state through
an s2 norm (``S2TEncoderLayer``'s ``s2`` inputs).  The decoder attends the
senior stream and, through its league, the textual one.

Each branch layer's self-attention takes a padding-only mask and runs the
fused attention kernel (K1f / K1b), where the JAX module passes an explicit
padding bias and attends densely; the cross-branch attention is dense in both.
A layer that never collaborates has no league modules, as flax creates them
only when a second stream is passed.  The model has no incremental decoder,
as in JAX, so the beam generator refuses it.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from s2t_tpu_torch.device import resolve_device
from s2t_tpu_torch.models.s2t_transformer import (
    S2TTransformerConfig, S2TTransformerEncoder, S2TTransformerModel, init_and_place,
    s2t_transformer_s, seeded_init)
from s2t_tpu_torch.models.transformer_decoder import TransformerDecoder
from s2t_tpu_torch.modules.adapter import Adapter
from s2t_tpu_torch.modules.attention import padding_bias
from s2t_tpu_torch.modules.dropout import dropout
from s2t_tpu_torch.modules.layers import S2TEncoderLayer, layer_norm
from s2t_tpu_torch.modules.positional import sinusoidal_table
from s2t_tpu_torch.registry import register_model, register_model_architecture
from s2t_tpu_torch.utils.masking import lengths_to_mask


@dataclass(frozen=True)
class S2TMultiBranchConfig:
    junior: S2TTransformerConfig = dataclasses.field(default_factory=S2TTransformerConfig)
    senior_layers: int = 6
    textual_layers: int = 6
    collaboration_direction: str = "both"  # none | acoustic | textual | both
    collaboration_start: Tuple[int, int] = (0, 0)
    collaboration_step: Tuple[int, int] = (1, 1)
    encoder_collaboration_mode: str = "parallel"  # none | serial | parallel
    decoder_collaboration_mode: str = "parallel"
    encoder_league_s1_ratio: float = 0.5
    encoder_league_s2_ratio: float = 0.5
    decoder_league_s1_ratio: float = 0.5
    decoder_league_s2_ratio: float = 0.5
    acoustic_adapter: str = "none"
    textual_adapter: str = "none"
    consumes_transcript: bool = False

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @property
    def dtype(self) -> torch.dtype:
        return self.junior.dtype

    @property
    def vocab_size(self):
        return self.junior.vocab_size

    @property
    def ctc_vocab_size(self):
        return self.junior.ctc_vocab_size

    @property
    def decoder_layers(self):
        return self.junior.decoder_layers

    @property
    def max_target_positions(self):
        return self.junior.max_target_positions

    @property
    def subsampling_layers(self):
        return self.junior.subsampling_layers

    @property
    def subsampling_stride(self):
        return self.junior.subsampling_stride


def collab_schedule(cfg: S2TMultiBranchConfig) -> List[Tuple[str, int, bool]]:
    """("senior" | "textual", layer, collaborates) in the reference's interleaved
    order (s2t_tpu/models/s2t_multibranch.py:146-183)."""
    s_i = t_i = -1
    order = []
    while s_i < cfg.senior_layers - 1 or t_i < cfg.textual_layers - 1:
        if cfg.collaboration_direction == "acoustic":
            for _ in range(cfg.collaboration_step[1]):
                t_i += 1
                if t_i < cfg.textual_layers:
                    order.append(("textual", t_i, False))
            for _ in range(cfg.collaboration_step[0]):
                s_i += 1
                if s_i < cfg.senior_layers:
                    order.append(("senior", s_i, s_i >= cfg.collaboration_start[0]))
        else:
            for _ in range(cfg.collaboration_step[0]):
                s_i += 1
                if s_i < cfg.senior_layers:
                    order.append(("senior", s_i, cfg.collaboration_direction == "both"
                                  and s_i >= cfg.collaboration_start[0]))
            for _ in range(cfg.collaboration_step[1]):
                t_i += 1
                if t_i < cfg.textual_layers:
                    order.append(("textual", t_i, cfg.collaboration_direction
                                  in ("textual", "both") and t_i >= cfg.collaboration_start[1]))
    return order


class S2TMultiBranchEncoder(nn.Module):
    def __init__(self, cfg: S2TMultiBranchConfig):
        super().__init__()
        jc = cfg.junior
        D = jc.encoder_embed_dim
        self.cfg = cfg
        self.schedule = collab_schedule(cfg)
        collab = {(b, i) for b, i, c in self.schedule if c}
        self.junior = S2TTransformerEncoder(jc)
        self.ae_adapter = (Adapter(D, cfg.ctc_vocab_size, cfg.acoustic_adapter)
                           if cfg.acoustic_adapter != "none" else None)
        self.te_adapter = (Adapter(D, cfg.ctc_vocab_size, cfg.textual_adapter)
                           if cfg.textual_adapter != "none" else None)
        self.senior_embed_norm = layer_norm(D) if jc.encoder_embed_norm else None

        def branch(n, name):
            return nn.ModuleList([
                S2TEncoderLayer(
                    D, jc.encoder_ffn_embed_dim, jc.encoder_attention_heads, jc.activation_fn,
                    jc.encoder_normalize_before, jc.dropout, jc.attention_dropout,
                    jc.activation_dropout,
                    collaboration_mode=(cfg.encoder_collaboration_mode
                                        if (name, i) in collab else "none"),
                    league_s1_ratio=cfg.encoder_league_s1_ratio,
                    league_s2_ratio=cfg.encoder_league_s2_ratio,
                    # both branches norm the incoming stream (s2_need_norm=True upstream)
                    s2_apply_norm=True)
                for i in range(n)])

        self.senior_stack = branch(cfg.senior_layers, "senior")
        self.textual_stack = branch(cfg.textual_layers, "textual")
        pre = jc.encoder_normalize_before
        self.senior_final_norm = layer_norm(D) if pre else None
        self.textual_final_norm = layer_norm(D) if pre else None

    def forward(self, features, lengths, generator: Optional[torch.Generator] = None
                ) -> Dict[str, Any]:
        jc = self.cfg.junior
        D = jc.encoder_embed_dim
        jout = self.junior(features, lengths, None, generator)
        jx, jlen, ctc_logits = jout["encoder_out"], jout["encoder_lengths"], jout["ctc_logits"]
        T = jx.shape[1]
        valid = lengths_to_mask(jlen, T)
        bias = padding_bias(valid, jx.dtype)
        pad = ~valid[..., None]

        ae = jx if self.ae_adapter is None else self.ae_adapter(jx, ctc_logits)
        ae = ae.masked_fill(pad, 0.0)
        if self.senior_embed_norm is not None:
            ae = self.senior_embed_norm(ae)
        if not jc.encoder_no_scale_embedding:
            ae = ae * math.sqrt(D)
        pe = sinusoidal_table(T, D, jc.pad_id, ae.dtype, ae.device)[None]
        ae = dropout(ae + pe, jc.dropout, generator)
        te = jx if self.te_adapter is None else self.te_adapter(jx, ctc_logits)
        te = dropout(te + pe.to(te.dtype), jc.dropout, generator)
        ae, te = ae.masked_fill(pad, 0.0), te.masked_fill(pad, 0.0)

        for branch, idx, collab in self.schedule:
            if branch == "senior":
                ae = self.senior_stack[idx](ae, valid, None, generator,
                                            s2=te if collab else None,
                                            s2_bias=bias if collab else None)
            else:
                te = self.textual_stack[idx](te, valid, None, generator,
                                             s2=ae if collab else None,
                                             s2_bias=bias if collab else None)
        if self.senior_final_norm is not None:
            ae = self.senior_final_norm(ae)
            te = self.textual_final_norm(te)
        return {**jout, "encoder_out": ae, "s2_encoder_out": te, "junior_out": jx,
                "encoder_lengths": jlen, "ctc_logits": ctc_logits, "mixup": None}


@register_model("s2t_multibranch")
class S2TMultiBranchModel(nn.Module):
    @seeded_init
    def __init__(self, cfg: S2TMultiBranchConfig, device="cuda", seed: int = 0,
                 for_training: bool = False):
        super().__init__()
        S2TTransformerModel.check_config(cfg.junior, for_training)
        device = resolve_device(device)
        self.cfg = cfg
        jc = cfg.junior
        self.encoder = S2TMultiBranchEncoder(cfg)
        self.decoder = TransformerDecoder(
            vocab_size=jc.vocab_size, embed_dim=jc.decoder_embed_dim,
            ffn_dim=jc.decoder_ffn_embed_dim, num_layers=jc.decoder_layers,
            num_heads=jc.decoder_attention_heads, activation=jc.activation_fn,
            normalize_before=jc.decoder_normalize_before,
            share_input_output_embed=jc.share_decoder_input_output_embed,
            max_positions=jc.max_target_positions, dropout=jc.dropout,
            attention_dropout=jc.attention_dropout, activation_dropout=jc.activation_dropout,
            collaboration_mode=cfg.decoder_collaboration_mode,
            league_s1_ratio=cfg.decoder_league_s1_ratio,
            league_s2_ratio=cfg.decoder_league_s2_ratio)
        init_and_place(self, jc, device, seed, for_training)

    @property
    def device(self) -> torch.device:
        return self.decoder.embed_tokens.weight.device

    def forward(self, features, feat_lengths, prev_tokens, train: bool = False,
                generator: Optional[torch.Generator] = None, **unused) -> Dict[str, Any]:
        if train and generator is None:
            raise ValueError("train=True needs the step's torch.Generator")
        if not train:
            generator = None
        enc = self.encoder(features, feat_lengths, generator)
        valid = lengths_to_mask(enc["encoder_lengths"], enc["encoder_out"].shape[1])
        s2 = ({"s2_out": enc["s2_encoder_out"], "s2_valid_mask": valid}
              if self.cfg.decoder_collaboration_mode != "none" else {})
        logits = self.decoder(prev_tokens, enc["encoder_out"], valid, generator, **s2)
        return {"decoder_logits": logits, **enc}

    def encode(self, features, feat_lengths):
        return self.encoder(features, feat_lengths)


def _route_mb_ctx(kw):
    kw = dict(kw)
    junior_layers = kw.pop("junior_layers", None)
    j_kw = {k[len("junior_"):]: v for k, v in kw.items() if k.startswith("junior_")}
    rest = {k: v for k, v in kw.items() if not k.startswith("junior_")}
    if junior_layers is not None:
        j_kw["encoder_layers"] = junior_layers
    for key in ("vocab_size", "src_vocab_size", "input_feat_per_channel", "input_channels",
                "max_source_positions", "max_target_positions", "encoder_embed_dim",
                "encoder_ffn_embed_dim", "encoder_attention_heads", "subsampling_filter",
                "decoder_layers", "decoder_embed_dim", "decoder_ffn_embed_dim",
                "decoder_attention_heads", "dropout", "attention_dropout",
                "activation_dropout", "encoder_embed_norm", "encoder_no_scale_embedding",
                "dtype_str"):
        if key in rest:
            j_kw[key] = rest.pop(key)
    return j_kw, rest


@register_model_architecture("s2t_multibranch", "s2t_multibranch")
@register_model_architecture("s2t_multibranch", "s2t_multibranch_s")
def s2t_multibranch_s(**kw) -> S2TMultiBranchConfig:
    j_kw, rest = _route_mb_ctx(kw)
    junior = s2t_transformer_s(use_ctc=True, **j_kw)
    return S2TMultiBranchConfig(junior=junior).replace(**{
        k: (tuple(v) if isinstance(v, list) else v) for k, v in rest.items()})

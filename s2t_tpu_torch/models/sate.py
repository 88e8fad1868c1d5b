"""SATE: Stacked Acoustic-and-Textual Encoding (counterpart of s2t_tpu/models/sate.py).

The encoder stacks an acoustic encoder (the port's ``S2TTransformerEncoder``,
or ``PDSEncoder`` with ``acoustic_encoder: pds``) with its CTC head, a bridge
(an ``Adapter`` over the CTC posterior, or the CTC shrink: segment pooling as
a matmul that left-packs the kept CTC segments), and a textual encoder of
plain layers with its own positions.  ``S2TSATEModel`` puts the port's
Transformer decoder on top; ``S2TCTCModel`` (``s2t_ctc_sate``) takes the
encoder alone.  ``freeze_*`` stops the gradient at an encoder's output.

The textual encoder's self-attention takes a padding-only mask, so its "abs"
layers run the fused attention kernel (K1f / K1b), where the JAX module passes
an explicit padding bias and attends densely: the two agree, a 0-length row
(every frame of a row the CTC shrink calls blank) included, where both attend
uniformly over all T keys.

The acoustic encoder's CTC research stack (inter-CTC taps, PAE and its
oracle from the transcript, mixup) comes with it, and its keys pass through
the encoder's dict, as in JAX (``**enc``).

``SATEConfig`` keeps the JAX field names and defaults.  What the port does not
have raises ``NotImplementedError`` naming the field and its ROADMAP.md item
(``check_supported``): the textual XCTC taps, their PAE and ground-truth
curriculum, and the CTC-Aug cross-attention layers (item 8b); textual
attention other than abs and rel_pos (item 7).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from s2t_tpu_torch.models import pds as pds_mod
from s2t_tpu_torch.models.s2t_transformer import (
    ITEM7, ITEM8B, S2TTransformerConfig, S2TTransformerEncoder, S2TTransformerModel,
    _check_trainable, s2t_transformer_s)
from s2t_tpu_torch.models.s2t_transformer import check_supported as check_acoustic
from s2t_tpu_torch.modules.adapter import ADAPTER_TYPES, Adapter, ctc_shrink_matrix
from s2t_tpu_torch.modules.dropout import dropout
from s2t_tpu_torch.modules.layers import S2TEncoderLayer, layer_norm
from s2t_tpu_torch.modules.positional import relative_table, sinusoidal_table
from s2t_tpu_torch.registry import register_model, register_model_architecture
from s2t_tpu_torch.utils.masking import lengths_to_mask


@dataclass(frozen=True)
class SATEConfig:
    """Field for field the JAX SATEConfig (same names, same defaults); see there
    for what each field means."""

    acoustic: S2TTransformerConfig = dataclasses.field(default_factory=S2TTransformerConfig)
    acoustic_encoder: str = "transformer"
    pds: Optional[pds_mod.PDSConfig] = None
    adapter_type: str = "league"
    adapter_shrink_strategy: str = "avg"
    adapter_temperature: float = 1.0
    text_encoder_layers: int = 6
    text_attention_heads: int = 4
    text_ffn_embed_dim: int = 2048
    text_attention_type: str = "abs"
    text_use_xctc: bool = False
    text_no_pos_emb: bool = False
    textual_encoder_embed_norm: bool = False
    textual_encoder_no_scale_embedding: bool = True
    inter_xctc_layers: Tuple[int, ...] = ()
    xctc_pae: str = "none"
    share_inter_xctc_norm: bool = False
    xctc_pae_ground_truth_ratio: float = 0.0
    xctc_pae_ground_truth_only_mistake: bool = False
    pae_oracle_smooth: bool = False
    pae_unnorm_input: bool = False
    xctc_cross_attn: bool = False
    cross_attn_start_layer: int = 0
    cross_attn_layer: int = 0
    cross_attn_collaboration_mode: str = "serial"
    cross_attn_league_drop_net: bool = False
    cross_attn_league_drop_net_prob: float = 0.0
    freeze_acoustic_encoder: bool = False
    freeze_textual_encoder: bool = False

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    # the pass-throughs the generator, the task and the trainer read
    @property
    def vocab_size(self):
        return self.acoustic.vocab_size

    @property
    def decoder_layers(self):
        return self.acoustic.decoder_layers

    @property
    def max_target_positions(self):
        return self.acoustic.max_target_positions

    @property
    def subsampling_layers(self):
        return self.acoustic.subsampling_layers

    @property
    def subsampling_stride(self):
        return self.acoustic.subsampling_stride

    @property
    def dtype(self) -> torch.dtype:
        return self.acoustic.dtype

    @property
    def ctc_pae_ground_truth_ratio(self):
        return self.acoustic.ctc_pae_ground_truth_ratio


def _unported(field: str, value, item: str):
    return NotImplementedError(f"SATEConfig.{field}={value!r} is not ported to s2t_tpu_torch "
                               f"({item})")


def check_supported(cfg: SATEConfig, for_training: bool = False) -> None:
    """Raise NotImplementedError on the first field that selects a branch the port
    does not have, naming the field and the ROADMAP.md item that ports it."""
    for name, off in (("text_use_xctc", False), ("inter_xctc_layers", ()),
                      ("xctc_pae", "none"), ("xctc_cross_attn", False),
                      ("xctc_pae_ground_truth_ratio", 0.0)):
        if getattr(cfg, name) != off:
            raise _unported(name, getattr(cfg, name), ITEM8B)
    if cfg.text_attention_type not in ("abs", "rel_pos"):
        raise _unported("text_attention_type", cfg.text_attention_type, ITEM7)
    if cfg.adapter_type not in ADAPTER_TYPES + ("shrink",):
        raise ValueError(f"SATEConfig.adapter_type {cfg.adapter_type!r} not supported")
    a = cfg.acoustic
    check_acoustic(a)
    if for_training:
        _check_trainable(a)
    if cfg.acoustic_encoder == "pds":
        if cfg.pds is None:
            raise ValueError("acoustic_encoder=pds needs a pds config")
        if cfg.pds.pds_embed_dims[-1] != a.encoder_embed_dim:
            raise ValueError("the PDS final stage dim must equal acoustic.encoder_embed_dim")
        # the PDS config's own decoder fields build nothing here
        pds_mod.check_supported(cfg.pds.replace(decoder_layers=0))
    if a.decoder_layers > 0 and a.encoder_embed_dim != a.decoder_embed_dim:
        raise NotImplementedError(
            f"a SATE encoder of width {a.encoder_embed_dim} under a decoder of width "
            f"{a.decoder_embed_dim}: the port's cross-attention projects keys of the "
            "decoder's width")


class TextualEncoder(nn.Module):
    """The textual stack over the bridge's output (s2t_tpu/models/sate.py:215-344):
    [embed norm] -> [x sqrt(D)] -> fairseq pad-aware sinusoidal positions (or the
    relative table under rel_pos) and dropout, unless ``text_no_pos_emb`` ->
    plain layers (the acoustic config's activation, norm placement and dropouts)
    -> final norm under pre-norm."""

    def __init__(self, cfg: SATEConfig):
        super().__init__()
        self.cfg = cfg
        a = cfg.acoustic
        D = a.encoder_embed_dim
        self.embed_norm = layer_norm(D) if cfg.textual_encoder_embed_norm else None
        self.layers = nn.ModuleList([
            S2TEncoderLayer(D, cfg.text_ffn_embed_dim, cfg.text_attention_heads, a.activation_fn,
                            a.encoder_normalize_before, a.dropout, a.attention_dropout,
                            a.activation_dropout, cfg.text_attention_type)
            for _ in range(cfg.text_encoder_layers)])
        self.final_norm = layer_norm(D) if a.encoder_normalize_before else None

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        a = cfg.acoustic
        T, D = x.shape[1], a.encoder_embed_dim
        if self.embed_norm is not None:
            x = self.embed_norm(x)
        if not cfg.textual_encoder_no_scale_embedding:
            x = x * math.sqrt(D)
        pos_emb = None
        if not cfg.text_no_pos_emb:
            if cfg.text_attention_type == "rel_pos":
                pos_emb = relative_table(T, D, x.dtype, x.device)
            else:
                # valid frame i -> position pad + 1 + i (sate.py:375-377)
                x = x + sinusoidal_table(T, D, a.pad_id, x.dtype, x.device)[None]
            x = dropout(x, a.dropout, generator)
        valid = lengths_to_mask(lengths, T)
        for layer in self.layers:
            x = layer(x, valid, generator=generator, pos_emb=pos_emb)
        return x if self.final_norm is None else self.final_norm(x)


class S2TSATEEncoder(nn.Module):
    """Acoustic encoder -> CTC -> bridge -> textual encoder (s2t_tpu/models/sate.py:347-408).
    Returns the acoustic encoder's keys with ``encoder_out`` and
    ``encoder_lengths`` the textual encoder's (the shrunk lengths under
    ``shrink``) and ``ctc_logits`` the acoustic CTC head's."""

    def __init__(self, cfg: SATEConfig):
        super().__init__()
        self.cfg = cfg
        a = cfg.acoustic
        if cfg.acoustic_encoder == "pds":
            self.acoustic = pds_mod.PDSEncoder(cfg.pds)
        else:
            # no decoder table reaches the acoustic encoder: its CTC heads have their own
            # projections
            self.acoustic = S2TTransformerEncoder(a.replace(share_ctc_and_embed=False,
                                                            share_xctc_and_embed=False))
        self.adapter = (Adapter(a.encoder_embed_dim, a.ctc_vocab_size, cfg.adapter_type,
                                cfg.adapter_temperature)
                        if cfg.adapter_type not in ("none", "shrink") else None)
        self.textual = TextualEncoder(cfg)

    def forward(self, features: torch.Tensor, lengths: torch.Tensor,
                embedding: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                transcript: Optional[torch.Tensor] = None,
                transcript_lengths: Optional[torch.Tensor] = None,
                target: Optional[torch.Tensor] = None,
                target_lengths: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """``embedding`` is unused: neither CTC head of SATE is tied.  The
        transcript reaches the acoustic encoder's oracle; the target is the
        textual oracle's (item 8b), so it reaches nothing here."""
        cfg = self.cfg
        if cfg.acoustic_encoder == "pds":
            enc = self.acoustic(features, lengths, generator=generator)
        else:
            enc = self.acoustic(features, lengths, generator=generator, transcript=transcript,
                                transcript_lengths=transcript_lengths)
        x, enc_lengths, ctc_logits = enc["encoder_out"], enc["encoder_lengths"], enc["ctc_logits"]
        if cfg.freeze_acoustic_encoder:
            x = x.detach()
        if cfg.adapter_type == "shrink":
            W, enc_lengths = ctc_shrink_matrix(ctc_logits, enc_lengths, blank_id=0,
                                               strategy=cfg.adapter_shrink_strategy)
            x = torch.einsum("bst,btd->bsd", W.to(x.dtype), x)
        elif self.adapter is not None:
            x = self.adapter(x, ctc_logits)
        x = self.textual(x, enc_lengths, generator)
        if cfg.freeze_textual_encoder:
            x = x.detach()
        return {"inter_ctc_logits": (), **enc, "encoder_out": x, "encoder_lengths": enc_lengths,
                "xctc_logits": None, "inter_xctc_logits": ()}


@register_model("s2t_sate")
class S2TSATEModel(S2TTransformerModel):
    """The SATE encoder under the port's Transformer decoder (built from the
    acoustic config's decoder fields), with the signatures, build and placement
    of ``S2TTransformerModel``."""

    @staticmethod
    def check_config(cfg: SATEConfig, for_training: bool) -> None:
        check_supported(cfg, for_training)

    @staticmethod
    def decoder_config(cfg: SATEConfig) -> S2TTransformerConfig:
        return cfg.acoustic

    build_encoder = S2TSATEEncoder
    decoder_mixup = False  # the JAX SATE model hands its decoder the tokens as they are


@register_model_architecture("s2t_sate", "s2t_sate")
@register_model_architecture("s2t_sate", "s2t_sate_s")
def s2t_sate_s(**kw) -> SATEConfig:
    """The JAX preset's routing (s2t_tpu/models/sate.py:461-502): ``acoustic_*`` keys
    to the acoustic config (an s2t_transformer_s with no inter-CTC layers),
    ``acoustic_encoder`` to the family field, the task's context keys to the
    acoustic config, ``pds_*`` keys to a ``PDSConfig`` that inherits the
    acoustic config's shared fields, the rest to ``SATEConfig``."""
    enc_family = kw.pop("acoustic_encoder", "transformer")
    acoustic_kw = {k[len("acoustic_"):]: v for k, v in kw.items() if k.startswith("acoustic_")}
    rest = {k: v for k, v in kw.items() if not k.startswith("acoustic_")}
    rest["acoustic_encoder"] = enc_family
    for key in ("vocab_size", "src_vocab_size", "input_feat_per_channel", "input_channels",
                "max_source_positions", "max_target_positions"):
        if key in rest:
            acoustic_kw[key] = rest.pop(key)
    acoustic_kw.setdefault("inter_ctc_layers", ())
    pds_kw = {k: v for k, v in rest.items() if k.startswith("pds_")}
    for k in pds_kw:
        rest.pop(k)
    acoustic = s2t_transformer_s(**acoustic_kw)
    pds_cfg = None
    if rest.get("acoustic_encoder") == "pds":
        pds_cfg = pds_mod.PDSConfig(
            vocab_size=acoustic.vocab_size,
            src_vocab_size=acoustic.src_vocab_size,
            input_feat_per_channel=acoustic.input_feat_per_channel,
            input_channels=acoustic.input_channels,
            max_source_positions=acoustic.max_source_positions,
            max_target_positions=acoustic.max_target_positions,
            encoder_embed_dim=acoustic.encoder_embed_dim,
            dropout=acoustic.dropout,
            attention_dropout=acoustic.attention_dropout,
            activation_dropout=acoustic.activation_dropout,
            activation_fn=acoustic.activation_fn,
            dtype_str=acoustic.dtype_str,
        ).replace(**pds_kw)
    return SATEConfig(acoustic=acoustic, pds=pds_cfg).replace(**rest)

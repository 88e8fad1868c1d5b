"""SATE: Stacked Acoustic-and-Textual Encoding (counterpart of s2t_tpu/models/sate.py).

The encoder stacks an acoustic encoder (the port's ``S2TTransformerEncoder``,
or ``PDSEncoder`` with ``acoustic_encoder: pds``) with its CTC head, a bridge
(an ``Adapter`` over the CTC posterior, or the CTC shrink: segment pooling as
a matmul that left-packs the kept CTC segments), and a textual encoder of
plain layers with its own positions.  ``S2TSATEModel`` puts the port's
Transformer decoder on top; ``S2TCTCModel`` (``s2t_ctc_sate``) takes the
encoder alone.  ``freeze_*`` stops the gradient at an encoder's output.

The textual encoder's self-attention takes a padding-only mask, so its "abs"
and "rope" layers run the fused attention kernel (K1f / K1b), where the JAX module passes
an explicit padding bias and attends densely: the two agree, a 0-length row
(every frame of a row the CTC shrink calls blank) included, where both attend
uniformly over all T keys.

The textual encoder carries the rest of the CTC research stack: XCTC on its
output (``text_use_xctc``), inter-XCTC taps through the same head with a
per-tap or the final norm, the XCTC PAE (``xpae``) with its ground-truth oracle
from the EOS-stripped target, and CTC-Aug's cross-stream layers
(``CrossStreamTextLayer``): from ``cross_attn_start_layer`` on, each layer also
attends to the normed snapshot taken after ``cross_attn_layer``, serially
(self-attention, then the cross-attention, then the FFN) or in league (both
from the same normed input, summed 0.5 / 0.5, with drop-net in training).  Both
attentions take the padding mask, so they run K1f / K1b too.  The oracle's
uniform draws and drop-net's are made on the host from numpy generators seeded
by the step's generator seed (``host_uniform``), so the card and the CPU draw
alike.

The acoustic encoder's CTC research stack (inter-CTC taps, PAE and its
oracle from the transcript, mixup) comes with it, and its keys pass through
the encoder's dict, as in JAX (``**enc``).

``SATEConfig`` keeps the JAX field names and defaults.  ``text_attention_type``
takes every type the JAX layer builds from the type alone (abs, rope, local,
rel_pos, light, dynamic; the textual positions are sinusoidal for all but
rel_pos, rope included, as in JAX); "relative" raises ``ValueError``, as the
layers get no clip length (the JAX layer asserts one).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from s2t_tpu_torch.models import pds as pds_mod
from s2t_tpu_torch.models.s2t_transformer import (
    DROPNET_STREAM, ORACLE_STREAM, S2TTransformerConfig, S2TTransformerEncoder, S2TTransformerModel,
    _check_trainable, _taps, s2t_transformer_s)
from s2t_tpu_torch.models.s2t_transformer import check_supported as check_acoustic
from s2t_tpu_torch.modules.adapter import (
    ADAPTER_TYPES, Adapter, ctc_oracle_probs, ctc_shrink_matrix, host_uniform)
from s2t_tpu_torch.modules.attention import MultiHeadAttention
from s2t_tpu_torch.modules.ctc_head import CTCHead
from s2t_tpu_torch.modules.dropout import dropout
from s2t_tpu_torch.modules.layers import FeedForward, S2TEncoderLayer, layer_norm
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


def check_supported(cfg: SATEConfig, for_training: bool = False) -> None:
    """Raise NotImplementedError on the first field that selects a branch the port
    does not have, naming the field and the ROADMAP.md item that ports it."""
    if cfg.adapter_type not in ADAPTER_TYPES + ("shrink",):
        raise ValueError(f"SATEConfig.adapter_type {cfg.adapter_type!r} not supported")
    a = cfg.acoustic
    if cfg.share_inter_xctc_norm and _taps(cfg.inter_xctc_layers, cfg.text_encoder_layers) \
            and not a.encoder_normalize_before:
        # the JAX encoder has no final norm to share under post-norm and fails
        raise ValueError("share_inter_xctc_norm needs the textual encoder's final norm "
                         "(encoder_normalize_before)")
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


class CrossStreamTextLayer(nn.Module):
    """CTC-Aug's textual layer with a cross-attention onto a second stream s2
    (s2t_tpu/models/sate.py:133-212): abs attention with no positions, whatever
    ``text_attention_type`` says.  serial: self-attention -> cross-attention onto
    s2 (its own norm, ``cross_norm``) -> FFN, each a residual; league: the
    self- and s2-attention of the same normed input summed 0.5 / 0.5, and in
    training with ``drop_net`` one stream dropped with probability
    ``drop_net_prob``, either one equally likely (drop-net acts only here).
    Built ``with_s2=False`` (a layer that runs before the snapshot exists) it is
    a plain layer, with no s2 modules, as flax creates none."""

    def __init__(self, dim: int, ffn_dim: int, num_heads: int, activation: str = "relu",
                 normalize_before: bool = True, dropout: float = 0.0,
                 attention_dropout: float = 0.0, activation_dropout: float = 0.0,
                 collaboration_mode: str = "serial", drop_net: bool = False,
                 drop_net_prob: float = 0.0, with_s2: bool = True, layer: int = 0):
        super().__init__()
        self.normalize_before = normalize_before
        self.dropout = dropout
        self.league = collaboration_mode == "league"
        self.drop_net = drop_net and drop_net_prob > 0
        self.drop_net_prob = np.float32(drop_net_prob)
        self.layer = layer
        self.attn_norm = layer_norm(dim)
        self.self_attn = MultiHeadAttention(dim, num_heads, attention_dropout)
        self.s2_attn = MultiHeadAttention(dim, num_heads, attention_dropout) if with_s2 else None
        self.cross_norm = layer_norm(dim) if with_s2 and not self.league else None
        self.ffn_norm = layer_norm(dim)
        self.ffn = FeedForward(dim, ffn_dim, activation, activation_dropout)

    def _weights(self, generator):
        """(self, s2) weights of the league sum."""
        if not (self.drop_net and generator is not None):
            return 0.5, 0.5
        # two draws for this layer of the step: whether a stream drops, and which one
        dropped, pick_first = host_uniform(
            (2,), (generator.initial_seed(), DROPNET_STREAM, self.layer)).tolist()
        if not dropped < self.drop_net_prob:
            return 0.5, 0.5
        return (1.0, 0.0) if pick_first < 0.5 else (0.0, 1.0)

    def forward(self, x: torch.Tensor, valid_mask: torch.Tensor,
                s2: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``s2`` (B, T, D): the snapshot, over the same frames as ``x`` (both
        attentions take ``valid_mask``, so both run the fused kernel)."""
        res = x
        h = self.attn_norm(x) if self.normalize_before else x
        out, _ = self.self_attn(h, h, h, valid_mask=valid_mask, generator=generator)
        if self.league and s2 is not None:
            cross, _ = self.s2_attn(h, s2, s2, valid_mask=valid_mask, generator=generator)
            w1, w2 = self._weights(generator)
            out = w1 * out + w2 * cross
        x = res + dropout(out, self.dropout, generator)
        if not self.normalize_before:
            x = self.attn_norm(x)
        if s2 is not None and not self.league:
            res = x
            h = self.cross_norm(x) if self.normalize_before else x
            cross, _ = self.s2_attn(h, s2, s2, valid_mask=valid_mask, generator=generator)
            x = res + dropout(cross, self.dropout, generator)
            if not self.normalize_before:
                x = self.cross_norm(x)
        res = x
        h = self.ffn_norm(x) if self.normalize_before else x
        x = res + dropout(self.ffn(h, generator), self.dropout, generator)
        return x if self.normalize_before else self.ffn_norm(x)


class TextualEncoder(nn.Module):
    """The textual stack over the bridge's output (s2t_tpu/models/sate.py:215-344):
    [embed norm] -> [x sqrt(D)] -> fairseq pad-aware sinusoidal positions (or the
    relative table under rel_pos) and dropout, unless ``text_no_pos_emb`` ->
    layers (the acoustic config's activation, norm placement and dropouts; a
    ``CrossStreamTextLayer`` from ``cross_attn_start_layer`` on under
    ``xctc_cross_attn``), the snapshot after ``cross_attn_layer``, the inter-XCTC
    taps with their PAE -> final norm under pre-norm -> the XCTC head.

    Only the modules a forward calls are built, as flax creates parameters only
    for those: no ``cross_attn_norm`` without a snapshot, no s2 modules in a
    cross layer that runs before it, a tap's norm only where a tap sits (never
    after the last layer)."""

    def __init__(self, cfg: SATEConfig):
        super().__init__()
        self.cfg = cfg
        a = cfg.acoustic
        D, L = a.encoder_embed_dim, cfg.text_encoder_layers
        self.embed_norm = layer_norm(D) if cfg.textual_encoder_embed_norm else None
        use_cross = cfg.xctc_cross_attn and cfg.cross_attn_start_layer > 0
        self.snapshot = cfg.cross_attn_layer if use_cross and 1 <= cfg.cross_attn_layer <= L \
            else None
        layers = []
        for i in range(1, L + 1):
            if use_cross and i >= cfg.cross_attn_start_layer:
                layers.append(CrossStreamTextLayer(
                    D, cfg.text_ffn_embed_dim, cfg.text_attention_heads, a.activation_fn,
                    a.encoder_normalize_before, a.dropout, a.attention_dropout,
                    a.activation_dropout, cfg.cross_attn_collaboration_mode,
                    cfg.cross_attn_league_drop_net, cfg.cross_attn_league_drop_net_prob,
                    with_s2=self.snapshot is not None and self.snapshot < i, layer=i))
            else:
                layers.append(S2TEncoderLayer(
                    D, cfg.text_ffn_embed_dim, cfg.text_attention_heads, a.activation_fn,
                    a.encoder_normalize_before, a.dropout, a.attention_dropout,
                    a.activation_dropout, cfg.text_attention_type))
        self.layers = nn.ModuleList(layers)
        self.cross_attn_norm = layer_norm(D) if self.snapshot is not None else None
        self.final_norm = layer_norm(D) if a.encoder_normalize_before else None
        self.xctc_taps = _taps(cfg.inter_xctc_layers, L)
        self.xctc_head = (CTCHead(D, a.vocab_size, dropout=a.dropout)
                          if cfg.text_use_xctc or cfg.inter_xctc_layers else None)
        self.inter_xctc_norms = (nn.ModuleDict({str(l): layer_norm(D) for l in self.xctc_taps})
                                 if self.xctc_taps and not cfg.share_inter_xctc_norm else None)
        self.xpae = (Adapter(D, a.vocab_size, cfg.xctc_pae, cfg.adapter_temperature)
                     if self.xctc_taps and cfg.xctc_pae != "none" else None)

    def _oracle(self, logits, lengths, target, target_lengths, generator, layer):
        """The XCTC PAE's oracle at a tap (s2t_tpu/models/sate.py:271-284, :326-338), its
        uniform draws from the host by (step seed, layer, stream 2)."""
        cfg = self.cfg
        uniform = host_uniform(logits.shape[:2], (generator.initial_seed(), ORACLE_STREAM,
                                                  layer, 2))
        return ctc_oracle_probs(logits, lengths, target, target_lengths, uniform,
                                cfg.xctc_pae_ground_truth_ratio,
                                temperature=cfg.adapter_temperature,
                                smooth=cfg.pae_oracle_smooth,
                                only_mistake=cfg.xctc_pae_ground_truth_only_mistake)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                target: Optional[torch.Tensor] = None,
                target_lengths: Optional[torch.Tensor] = None):
        """Returns (x, XCTC logits or None, ((layer, inter-XCTC logits), ...)).  In
        training (a ``generator``) with a ``target`` (EOS-stripped) and a ground-truth
        ratio the XCTC PAE re-embeds the oracle's probabilities."""
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
        s2, inter = None, []
        for i, layer in enumerate(self.layers, 1):
            if isinstance(layer, CrossStreamTextLayer):
                x = layer(x, valid, s2, generator)
            else:
                x = layer(x, valid, generator=generator, pos_emb=pos_emb)
            if i == self.snapshot:
                s2 = self.cross_attn_norm(x)
            if i in self.xctc_taps:
                h = (self.final_norm if cfg.share_inter_xctc_norm
                     else self.inter_xctc_norms[str(i)])(x)
                xlogits = self.xctc_head(h, generator=generator)
                inter.append((i, xlogits))
                if self.xpae is not None:
                    probs = None
                    if cfg.xctc_pae_ground_truth_ratio > 0 and generator is not None \
                            and target is not None:
                        probs = self._oracle(xlogits, lengths, target, target_lengths,
                                             generator, i)
                    x = self.xpae(x if cfg.pae_unnorm_input else h, xlogits, probs=probs)
        if self.final_norm is not None:
            x = self.final_norm(x)
        xctc = None if self.xctc_head is None else self.xctc_head(x, generator=generator)
        return x, xctc, tuple(inter)


class S2TSATEEncoder(nn.Module):
    """Acoustic encoder -> CTC -> bridge -> textual encoder (s2t_tpu/models/sate.py:347-408).
    Returns the acoustic encoder's keys with ``encoder_out`` and
    ``encoder_lengths`` the textual encoder's (the shrunk lengths under
    ``shrink``), ``ctc_logits`` the acoustic CTC head's and ``xctc_logits`` /
    ``inter_xctc_logits`` the textual encoder's."""

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
        transcript reaches the acoustic encoder's oracle (a Transformer one; the
        PDS encoder has none), the EOS-stripped target the textual XCTC PAE's."""
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
        x, xctc_logits, inter_xctc_logits = self.textual(x, enc_lengths, generator, target,
                                                          target_lengths)
        if cfg.freeze_textual_encoder:
            x = x.detach()
        return {"inter_ctc_logits": (), **enc, "encoder_out": x, "encoder_lengths": enc_lengths,
                "xctc_logits": xctc_logits, "inter_xctc_logits": inter_xctc_logits}


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

    @staticmethod
    def encoder_out_dim(cfg: SATEConfig) -> int:
        return cfg.acoustic.encoder_embed_dim

    build_encoder = S2TSATEEncoder
    decoder_mixup = False  # the JAX SATE model hands its decoder the tokens as they are
    lazy_reorder = False  # its decode_step takes no ancestry (s2t_tpu/models/sate.py:447-456)

    @staticmethod
    def decoder_self_attention(dec) -> Dict[str, Any]:
        """abs: the JAX SATE decoder takes no relative length (s2t_tpu/models/sate.py:417-428)."""
        return {}


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

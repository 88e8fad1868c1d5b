"""PDS: the Progressive Down-Sampling encoder (counterpart of s2t_tpu/models/pds.py).

The encoder runs in stages; each stage is a strided-conv ``Downsampling`` (or
the Conv1d or Conv2d subsampler for a ratio of -1), that stage's sinusoidal
positions at its own length and width (its relative-position table under
rel_pos, none under rope), dropout, and pre- or post-norm layers, Conformer ones
with ``macaron_style`` / ``use_cnn_module``, of any self-attention type the JAX
layer takes from ``encoder_attention_type`` alone.  With ``pds_conv_strides`` the
last layer of a stage strides its conv module and widens the stream to the next
stage's width (EffecientConformer): the lengths shrink there.  With ``pds_fusion``
every stage's output is carried to the last stage's length by a ``FusionBlock``
and the results are summed with learned or fixed weights.  ``pds_final_layers``,
the final norm and the top CTC head follow.

The stage taps of the CTC research stack sit after a stage's last layer:
inter-CTC (``pds_ctc``: the stage's ``ctc_norm{i}``, then the shared
``inter_ctc_head`` when every tapped stage has the encoder's width and
``share_inter_ctc``, else the stage's own head) with its PAE (shared or per
stage, never after the last stage), and inter-XCTC (``pds_xctc``: always the
shared ``inter_xctc_head`` and ``xpae``).  A tap records (layer, logits, the
stage's lengths): it is scored at its own time scale.  The PAE rewrites the
stream after the stage's output is kept, so the fusion sees it unchanged.  The
top CTC head is the shared inter head when ``ctc_layer`` is 0; at an inner
``ctc_layer`` / ``xctc_layer`` (a global layer index) a head with its own
LayerNorm reads that layer's output, which is then returned as ``ctc_logits`` /
``xctc_logits`` and scored with the final lengths, as in JAX.

``PDSS2TTransformerModel`` puts the port's Transformer decoder on top;
``S2TCTCModel`` (``s2t_ctc_pds``) takes the encoder alone.

``PDSConfig`` keeps the JAX config's field names and defaults.  What fails in
JAX raises ``ValueError``: Shaw relative attention (the config carries no clip
length, so the layer's attention refuses it), conv strides without the conv
module (``check_supported``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from s2t_tpu_torch.device import torch_dtype
from s2t_tpu_torch.models.s2t_transformer import S2TTransformerModel
from s2t_tpu_torch.modules.adapter import Adapter
from s2t_tpu_torch.modules.cast import Conv1d
from s2t_tpu_torch.modules.ctc_head import CTCHead
from s2t_tpu_torch.modules.dropout import dropout
from s2t_tpu_torch.modules.layers import S2TEncoderLayer, layer_norm
from s2t_tpu_torch.modules.positional import relative_table, sinusoidal_table
from s2t_tpu_torch.modules.subsampling import (
    Conv1dSubsampling, Conv2dSubsampling, check_features)
from s2t_tpu_torch.registry import register_model, register_model_architecture
from s2t_tpu_torch.utils.masking import lengths_to_mask


@dataclass(frozen=True)
class PDSConfig:
    """Field for field the JAX PDSConfig (same names, same defaults); see
    there for what each field means."""

    input_feat_per_channel: int = 80
    input_channels: int = 1
    pds_stages: int = 4
    pds_ratios: Tuple[int, ...] = (2, 2, 2, 2)
    pds_layers: Tuple[int, ...] = (2, 2, 6, 2)
    pds_kernel_sizes: Tuple[int, ...] = (5, 5, 5, 5)
    pds_embed_dims: Tuple[int, ...] = (256, 256, 256, 256)
    pds_attn_heads: Tuple[int, ...] = (4, 4, 4, 4)
    pds_ffn_ratios: Tuple[int, ...] = (8, 8, 8, 8)
    pds_position_embed: Tuple[int, ...] = (1, 1, 1, 1)
    pds_ctc: Tuple[int, ...] = ()
    pds_xctc: Tuple[int, ...] = ()
    pds_embed_norm: bool = True
    pds_ds_method: str = "conv"
    pds_conv_strides: Tuple[int, ...] = ()
    pds_cnn_kernel_sizes: Tuple[int, ...] = ()
    pds_dropout: float = -1.0
    pds_fusion: bool = False
    pds_fusion_method: str = "all_conv"
    pds_fusion_layers: Tuple[int, ...] = ()
    pds_fusion_weight: Tuple[float, ...] = ()
    pds_final_layers: int = 0
    subsampling_type: str = "conv1d"
    subsampling_layers: int = 2
    subsampling_filter: int = 1024
    subsampling_kernel: int = 5
    subsampling_stride: int = 2
    subsampling_norm: str = "none"
    subsampling_activation: str = "glu"
    subsampling_ref_pad_semantics: bool = True
    encoder_embed_dim: int = 256
    encoder_attention_type: str = "abs"
    encoder_normalize_before: bool = True
    activation_fn: str = "relu"
    encoder_activation_fn: str = ""
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.1
    macaron_style: bool = False
    use_cnn_module: bool = False
    cnn_module_kernel: int = 31
    cnn_module_norm: str = "layer_norm"
    conv_module_bias: bool = False
    use_ctc: bool = True
    ctc_layer: int = 0
    use_xctc: bool = False
    xctc_layer: int = 0
    ctc_pae: str = "none"
    xctc_pae: str = "none"
    pae_ctc_temperature: float = 1.0
    pae_unnorm_input: bool = False
    pae_embed_norm: bool = False
    pae_out_norm: bool = False
    share_inter_ctc: bool = True
    decoder_embed_dim: int = 256
    decoder_ffn_embed_dim: int = 2048
    decoder_layers: int = 6
    decoder_attention_heads: int = 4
    decoder_normalize_before: bool = True
    decoder_learned_pos: bool = False
    share_decoder_input_output_embed: bool = True
    vocab_size: int = 1000
    src_vocab_size: int = -1
    max_source_positions: int = 6000
    max_target_positions: int = 1024
    pad_id: int = 1
    dtype_str: str = "float32"
    compat_subsampling_layers: int = 0

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype_str)

    @property
    def enc_act(self):
        return self.encoder_activation_fn or self.activation_fn

    @property
    def ctc_vocab_size(self):
        return self.src_vocab_size if self.src_vocab_size > 0 else self.vocab_size

    @property
    def downsample_ratio(self):
        """Exact end-to-end T reduction, which the generator bounds its output by."""
        return self.total_ratio

    @property
    def total_ratio(self):
        r = 1
        for x in self.pds_ratios:
            # ratio -1: the shared subsampler downsamples by stride ** layers
            r *= self.subsampling_stride ** self.subsampling_layers if x == -1 else max(x, 1)
        for s in self.pds_conv_strides:
            r *= max(s, 1)
        return r

    @property
    def pad_multiple(self) -> int:
        """T is padded to a multiple of the product of the conv ratios before stage 0."""
        r = 1
        for x in self.pds_ratios:
            r *= max(1, x)
        return r

    def stage_conv_stride(self, i: int) -> int:
        return max(1, self.pds_conv_strides[i]) if self.pds_conv_strides else 1

    def stage_expand_dim(self, i: int) -> int:
        """Output dim of stage i's last layer."""
        if self.stage_conv_stride(i) != 1 and i != self.pds_stages - 1:
            return self.pds_embed_dims[i + 1]
        return self.pds_embed_dims[i]

    def stage_cnn_kernel(self, i: int) -> int:
        return self.pds_cnn_kernel_sizes[i] if self.pds_cnn_kernel_sizes else self.cnn_module_kernel

    @property
    def fusion_stages(self) -> Tuple[int, ...]:
        """Stage indices whose outputs are fused (none unless at least two)."""
        if not self.pds_fusion or self.pds_fusion_method in ("none", ""):
            return ()
        method = self.pds_fusion_method.split("_")[0]
        flags = self.pds_fusion_layers or tuple(1 for _ in range(self.pds_stages))
        idx = [i for i in range(self.pds_stages) if flags[i] and (
            method == "all"
            or (method == "same" and self.stage_expand_dim(i) == self.encoder_embed_dim))]
        return tuple(idx) if len(idx) > 1 else ()

    @property
    def fusion_transform(self) -> str:
        parts = self.pds_fusion_method.split("_")
        return parts[1] if len(parts) == 2 else "conv"

    @property
    def ctc_stages(self) -> Tuple[int, ...]:
        """Stages with an inter-CTC tap (none without ``use_ctc``)."""
        return tuple(i for i, f in enumerate(self.pds_ctc[:self.pds_stages]) if f) \
            if self.use_ctc else ()

    @property
    def xctc_stages(self) -> Tuple[int, ...]:
        """Stages with an inter-XCTC tap."""
        return tuple(i for i, f in enumerate(self.pds_xctc[:self.pds_stages]) if f)

    @property
    def share_ctc(self) -> bool:
        """The stage taps share one head: every tapped stage has the encoder's width."""
        return self.share_inter_ctc and len(
            {self.stage_expand_dim(i) for i in self.ctc_stages} | {self.encoder_embed_dim}) == 1

    def dim_at_layer(self, layer: int) -> int:
        """Width of the stream after global layer ``layer`` (1-indexed over the stages'
        layers; a stage's last layer may widen it); past them, the encoder output's."""
        end = 0
        for i, n in enumerate(self.pds_layers[:self.pds_stages]):
            end += n
            if 1 <= layer <= end:
                return self.stage_expand_dim(i) if layer == end else self.pds_embed_dims[i]
        return self.out_dim

    @property
    def out_dim(self) -> int:
        """Width of the encoder's output: the fusion's, else the last stage's."""
        return self.encoder_embed_dim if self.fusion_stages else self.stage_expand_dim(
            self.pds_stages - 1)


def check_supported(cfg: PDSConfig) -> None:
    """Raise NotImplementedError on the first field that selects a branch the
    port does not have, naming the field and the ROADMAP.md item that ports it,
    and ValueError where a shared stage head or adapter would meet a second
    width (where flax's shape check fails)."""
    if cfg.pds_conv_strides and not cfg.use_cnn_module:
        raise ValueError("pds_conv_strides downsample inside the conv module: use_cnn_module "
                         "must be on")
    # the shapes flax checks when a shared head or adapter meets a second width
    xdims = {cfg.stage_expand_dim(i) for i in cfg.xctc_stages}
    if len(xdims) > 1:
        raise ValueError(f"pds_xctc taps stages of widths {sorted(xdims)}: their shared "
                         "inter_xctc_head needs one width")
    last = cfg.pds_embed_dims[cfg.pds_stages - 1]
    for flag, stages, pae in (("ctc_pae", cfg.ctc_stages if cfg.share_ctc else (), cfg.ctc_pae),
                              ("xctc_pae", cfg.xctc_stages, cfg.xctc_pae)):
        if pae != "none" and any(cfg.stage_expand_dim(i) != last
                                 for i in stages if i != cfg.pds_stages - 1):
            raise ValueError(f"a shared {flag} adapter has the last stage's width {last}")
    if cfg.use_ctc and cfg.ctc_stages and cfg.share_ctc and cfg.ctc_layer == 0 and \
            cfg.out_dim != cfg.encoder_embed_dim:
        raise ValueError("the top CTC head tied to the shared inter head needs an encoder "
                         "output of encoder_embed_dim")
    if cfg.use_xctc and xdims and cfg.xctc_layer == 0 and xdims != {cfg.out_dim}:
        raise ValueError("the top XCTC head tied to inter_xctc_head needs the tapped stages' "
                         "width at the encoder output")
    if cfg.fusion_stages and cfg.fusion_transform != "conv":
        raise NotImplementedError(
            f"fusion transform {cfg.fusion_transform!r}: only 'conv' is implemented (the "
            "reference's conv2/conv3/pool variants appear in no recipe that enables fusion)")


class Downsampling(nn.Module):
    """A stage's strided conv: mask, Conv1d(k, stride max(ratio, 1), padding
    (k - 1) // 2), optional LayerNorm, mask.  Ratio 0 is the identity; ratio 1
    still applies the conv; lengths shrink only for a ratio above 1."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int = 5, stride: int = 2,
                 embed_norm: bool = True):
        super().__init__()
        self.stride = stride
        if stride == 0:
            return
        self.conv = Conv1d(in_dim, out_dim, kernel_size, max(stride, 1),
                           padding=(kernel_size - 1) // 2)
        self.norm = layer_norm(out_dim) if embed_norm else None

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        if self.stride == 0:
            return x, lengths
        x = x.masked_fill(~lengths_to_mask(lengths, x.shape[1])[..., None], 0.0)
        x = self.conv(x.transpose(1, 2)).transpose(1, 2)
        if self.stride > 1:
            lengths = (lengths - 1) // self.stride + 1
        if self.norm is not None:
            x = self.norm(x)
        return x.masked_fill(~lengths_to_mask(lengths, x.shape[1])[..., None], 0.0), lengths


class FusionBlock(nn.Module):
    """A stage's output carried to the last stage's length and width: pre-norm,
    Conv1d(k = stride = ratio, no padding), the frozen per-channel affine that
    stands for the reference's BatchNorm (``norm_scale``, ``norm_bias``),
    ReLU, post-norm."""

    def __init__(self, in_dim: int, out_dim: int, ratio: int):
        super().__init__()
        self.pre_norm = layer_norm(in_dim)
        self.conv = Conv1d(in_dim, out_dim, ratio, ratio)
        self.norm_scale = nn.Parameter(torch.ones(out_dim))
        self.norm_bias = nn.Parameter(torch.zeros(out_dim))
        self.post_norm = layer_norm(out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(self.pre_norm(x).transpose(1, 2)).transpose(1, 2)
        x = x * self.norm_scale.to(x.dtype) + self.norm_bias.to(x.dtype)
        return self.post_norm(F.relu(x))


class PDSEncoder(nn.Module):
    """Returns the JAX encoder's keys: {"encoder_out" (B, T', D), "encoder_lengths"
    (B,), "ctc_logits" (B, T', V_src) or None, "inter_ctc_logits" ((layer, logits,
    lengths), ...), "xctc_logits" (B, T', V) or None, "inter_xctc_logits" (...)}.
    Only the modules a forward calls are built, as flax creates parameters only
    for those (the tied top heads are the shared inter heads, so they are not
    built twice)."""

    def __init__(self, cfg: PDSConfig):
        super().__init__()
        self.cfg = cfg
        dims = cfg.pds_embed_dims
        # the width of each stage's output: its last layer may widen the stream
        outs = [cfg.stage_expand_dim(i) for i in range(cfg.pds_stages)]
        in_dim = cfg.input_feat_per_channel * cfg.input_channels
        downs, stages = [], []
        for i in range(cfg.pds_stages):
            if cfg.pds_ratios[i] == -1:
                downs.append(self._subsampler(in_dim, dims[i]))
            else:
                downs.append(Downsampling(in_dim, dims[i], cfg.pds_kernel_sizes[i],
                                          cfg.pds_ratios[i], cfg.pds_embed_norm))
            # a stage's conv modules take the encoder activation (s2t_tpu/models/pds.py:298)
            stages.append(nn.ModuleList([
                self._stage_layer(i, j == cfg.pds_layers[i] - 1)
                for j in range(cfg.pds_layers[i])]))
            in_dim = outs[i]
        self.downsamplers = nn.ModuleList(downs)
        self.stages = nn.ModuleList(stages)
        fusion = cfg.fusion_stages
        self.fusion_blocks = nn.ModuleDict()
        for i in fusion:
            ratio = 1
            for v in cfg.pds_ratios[i + 1:]:
                ratio *= max(v, 1)
            for v in cfg.pds_conv_strides[i + 1:]:
                ratio *= max(v, 1)
            self.fusion_blocks[str(i)] = FusionBlock(outs[i], cfg.encoder_embed_dim, ratio)
        self.fusion_weight = (nn.Parameter(torch.full((len(fusion),), 1.0 / len(fusion)))
                              if fusion and not cfg.pds_fusion_weight else None)
        D = cfg.encoder_embed_dim
        # the final layers' conv modules take activation_fn (s2t_tpu/models/pds.py:472)
        self.final_layers = nn.ModuleList([
            self._layer(D, D * cfg.pds_ffn_ratios[-1], cfg.pds_attn_heads[-1],
                        cfg.stage_cnn_kernel(cfg.pds_stages - 1), cfg.activation_fn)
            for _ in range(cfg.pds_final_layers)])
        self.final_norm = layer_norm(cfg.out_dim) if cfg.encoder_normalize_before else None
        n, Vs, drop = cfg.pds_stages, cfg.ctc_vocab_size, cfg.dropout

        def adapter(dim, vocab, kind):
            return Adapter(dim, vocab, kind, cfg.pae_ctc_temperature, cfg.pae_embed_norm,
                           cfg.pae_out_norm)

        # the stage taps (s2t_tpu/models/pds.py:350-405)
        taps, xtaps = cfg.ctc_stages, cfg.xctc_stages
        self.ctc_norms = nn.ModuleDict({str(i): layer_norm(outs[i]) for i in taps})
        self.inter_ctc_head = CTCHead(D, Vs, dropout=drop) if taps and cfg.share_ctc else None
        self.ctc_heads = nn.ModuleDict({} if cfg.share_ctc else {
            str(i): CTCHead(outs[i], Vs, dropout=drop) for i in taps})
        pae_stages = [i for i in taps if i != n - 1] if cfg.ctc_pae != "none" else []
        self.pae = adapter(dims[-1], Vs, cfg.ctc_pae) if pae_stages and cfg.share_ctc else None
        self.paes = nn.ModuleDict({} if cfg.share_ctc else {
            str(i): adapter(outs[i], Vs, cfg.ctc_pae) for i in pae_stages})
        self.xctc_norms = nn.ModuleDict({str(i): layer_norm(outs[i]) for i in xtaps})
        self.inter_xctc_head = (CTCHead(outs[xtaps[0]], cfg.vocab_size, dropout=drop)
                                if xtaps else None)
        self.xpae = (adapter(dims[-1], cfg.vocab_size, cfg.xctc_pae)
                     if cfg.xctc_pae != "none" and any(i != n - 1 for i in xtaps) else None)
        # the top heads (:389-405): the shared inter head at ctc_layer 0, else a head of
        # its own, normed when it reads an inner layer
        self.ctc_tied = cfg.use_ctc and self.inter_ctc_head is not None and cfg.ctc_layer == 0
        self.ctc_head = (CTCHead(cfg.dim_at_layer(cfg.ctc_layer), Vs, dropout=drop,
                                 norm=cfg.ctc_layer != 0)
                         if cfg.use_ctc and not self.ctc_tied else None)
        self.xctc_tied = cfg.use_xctc and self.inter_xctc_head is not None and cfg.xctc_layer == 0
        self.xctc_head = (CTCHead(cfg.dim_at_layer(cfg.xctc_layer), cfg.vocab_size,
                                  dropout=drop, norm=cfg.xctc_layer != 0)
                          if cfg.use_xctc and not self.xctc_tied else None)

    def _subsampler(self, in_dim: int, out_dim: int) -> nn.Module:
        """The shared subsampler of a ratio of -1 (s2t_tpu/models/pds.py:311-329): the
        Conv1d one with ``subsampling_norm`` and the pad semantics, or the Conv2d one
        at its defaults (valid padding, masked between layers; no norm reaches it)."""
        cfg = self.cfg
        if cfg.subsampling_type == "conv1d":
            return Conv1dSubsampling(
                in_dim, cfg.subsampling_layers, cfg.subsampling_filter, out_dim,
                cfg.subsampling_kernel, cfg.subsampling_stride, cfg.subsampling_activation,
                cfg.subsampling_norm, not cfg.subsampling_ref_pad_semantics)
        return Conv2dSubsampling(in_dim, cfg.subsampling_layers, cfg.subsampling_filter, out_dim,
                                 cfg.subsampling_kernel, cfg.subsampling_stride,
                                 cfg.subsampling_activation)

    def _stage_layer(self, i: int, last: bool) -> S2TEncoderLayer:
        """Layer of stage i (s2t_tpu/models/pds.py:282-305): the last one carries the
        stage's conv stride and widens to ``stage_expand_dim``, with an FFN as wide as
        the new width times the stage's ratio; the macaron FFN keeps the stage's."""
        cfg = self.cfg
        dim, ratio = cfg.pds_embed_dims[i], cfg.pds_ffn_ratios[i]
        expand = cfg.stage_expand_dim(i) if last else dim
        return self._layer(dim, expand * ratio, cfg.pds_attn_heads[i], cfg.stage_cnn_kernel(i),
                           cfg.enc_act, conv_expand_dim=expand if expand != dim else 0,
                           conv_stride=cfg.stage_conv_stride(i) if last else 1,
                           macaron_ffn_dim=dim * ratio)

    def _layer(self, dim: int, ffn_dim: int, heads: int, cnn_kernel: int, conv_act: str,
               **conv):
        cfg = self.cfg
        return S2TEncoderLayer(dim, ffn_dim, heads, cfg.enc_act,
                               cfg.encoder_normalize_before, cfg.dropout, cfg.attention_dropout,
                               cfg.activation_dropout, cfg.encoder_attention_type,
                               cfg.macaron_style, cfg.use_cnn_module, cnn_kernel,
                               conv_activation=conv_act, conv_norm_type=cfg.cnn_module_norm,
                               conv_bias=cfg.conv_module_bias, **conv)

    def _top_ctc(self, x, generator):
        return (self.inter_ctc_head if self.ctc_tied else self.ctc_head)(x, generator=generator)

    def _top_xctc(self, x, generator):
        return (self.inter_xctc_head if self.xctc_tied else self.xctc_head)(x,
                                                                            generator=generator)

    def _positions(self, x: torch.Tensor):
        """(x, None) with the fairseq pad-aware table at this length and width added
        (valid frame i -> pad + 1 + i), (x, the relative table) under rel_pos, or
        (x, None) under rope."""
        if self.cfg.encoder_attention_type == "rel_pos":
            return x, relative_table(x.shape[1], x.shape[2], x.dtype, x.device)
        if self.cfg.encoder_attention_type == "rope":
            return x, None
        return x + sinusoidal_table(x.shape[1], x.shape[2], self.cfg.pad_id, x.dtype,
                                    x.device)[None], None

    def forward(self, features: torch.Tensor, lengths: torch.Tensor,
                embedding: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """``embedding`` is None: a PDS encoder's CTC head has its own projection."""
        cfg = self.cfg
        check_features(features)
        x = features.to(cfg.dtype)
        mult = cfg.pad_multiple
        if mult > 1 and x.shape[1] % mult:
            # every stage conv sees a length its ratio divides
            x = F.pad(x, (0, 0, 0, mult - x.shape[1] % mult))
        stage_drop = cfg.dropout if cfg.pds_dropout < 0 else cfg.pds_dropout
        stage_outs, inter_ctc, inter_xctc = [], [], []
        ctc_logits = xctc_logits = None
        layer_idx = 0
        for i in range(cfg.pds_stages):
            x, lengths = self.downsamplers[i](x, lengths)
            pos_emb = None
            if cfg.pds_position_embed[i]:
                x, pos_emb = self._positions(x)
            x = dropout(x, cfg.dropout if i == 0 else stage_drop, generator)
            valid = lengths_to_mask(lengths, x.shape[1])
            for layer in self.stages[i]:
                x = layer(x, valid, generator=generator, pos_emb=pos_emb)
                layer_idx += 1
                if layer.conv_stride > 1:  # a stage's strided last layer (:536-540)
                    lengths = (lengths - 1) // layer.conv_stride + 1
                    valid = lengths_to_mask(lengths, x.shape[1])
                # the global-layer heads (s2t_tpu/models/pds.py:549-552)
                if cfg.use_ctc and cfg.ctc_layer == layer_idx:
                    ctc_logits = self._top_ctc(x, generator)
                if cfg.use_xctc and cfg.xctc_layer == layer_idx:
                    xctc_logits = self._top_xctc(x, generator)
            stage_outs.append((x, lengths))
            key = str(i)
            if key in self.ctc_norms:  # the stage taps and their PAE (:557-574)
                h = self.ctc_norms[key](x)
                head = self.ctc_heads[key] if key in self.ctc_heads else self.inter_ctc_head
                logits = head(h, generator=generator)
                inter_ctc.append((layer_idx, logits, lengths))
                pae = self.paes[key] if key in self.paes else self.pae
                if pae is not None and i != cfg.pds_stages - 1:
                    x = pae(x if cfg.pae_unnorm_input else h, logits)
            if key in self.xctc_norms:
                h = self.xctc_norms[key](x)
                logits = self.inter_xctc_head(h, generator=generator)
                inter_xctc.append((layer_idx, logits, lengths))
                if self.xpae is not None and i != cfg.pds_stages - 1:
                    x = self.xpae(x if cfg.pae_unnorm_input else h, logits)

        fusion = cfg.fusion_stages
        if fusion:
            Tf = x.shape[1]
            weights = (self.fusion_weight.to(x.dtype) if self.fusion_weight is not None
                       else torch.tensor(cfg.pds_fusion_weight, dtype=x.dtype, device=x.device))
            fused = torch.zeros_like(x)
            for k, i in enumerate(fusion):
                out, lens = stage_outs[i]
                # padded frames are zeroed before the strided fusion conv
                y = self.fusion_blocks[str(i)](
                    out.masked_fill(~lengths_to_mask(lens, out.shape[1])[..., None], 0.0))
                y = y[:, :Tf] if y.shape[1] >= Tf else F.pad(y, (0, 0, 0, Tf - y.shape[1]))
                fused = fused + weights[k] * y
            x = fused

        if len(self.final_layers):
            x, pos_emb = self._positions(x)
            x = dropout(x, stage_drop, generator)
            valid = lengths_to_mask(lengths, x.shape[1])
            for layer in self.final_layers:
                x = layer(x, valid, generator=generator, pos_emb=pos_emb)
        if self.final_norm is not None:
            x = self.final_norm(x)
        if cfg.use_ctc and ctc_logits is None:
            ctc_logits = self._top_ctc(x, generator)
        if cfg.use_xctc and xctc_logits is None:
            xctc_logits = self._top_xctc(x, generator)
        return {"encoder_out": x, "encoder_lengths": lengths, "ctc_logits": ctc_logits,
                "inter_ctc_logits": tuple(inter_ctc), "xctc_logits": xctc_logits,
                "inter_xctc_logits": tuple(inter_xctc)}


@register_model("pdss2t_transformer")
class PDSS2TTransformerModel(S2TTransformerModel):
    """The PDS encoder under the port's Transformer decoder, with the
    signatures, build and placement of ``S2TTransformerModel``."""

    @staticmethod
    def check_config(cfg: PDSConfig, for_training: bool) -> None:
        check_supported(cfg)

    build_encoder = PDSEncoder

    @staticmethod
    def encoder_out_dim(cfg: PDSConfig) -> int:
        return cfg.out_dim

    # the JAX PDS model's init_cache / decode_step take neither (s2t_tpu/models/pds.py:651-660)
    kv_int8_cache = False
    lazy_reorder = False


# --------------------------------------------------------------------------- #
# architecture presets (same values as the JAX package's, s2t_tpu/models/pds.py:663-763)
# --------------------------------------------------------------------------- #


def _pds_preset(stages, ratios, layers, kernels, dims, heads, ffn_ratios, **kw) -> PDSConfig:
    # the last stage dim is the encoder width; when the caller overrides the
    # stage plan, the global dims follow it unless set explicitly
    dims = tuple(kw.get("pds_embed_dims", dims))
    kw.setdefault("encoder_embed_dim", dims[-1])
    kw.setdefault("decoder_embed_dim", dims[-1])
    kw.setdefault("decoder_ffn_embed_dim", dims[-1] * 8)
    cfg = PDSConfig(
        pds_stages=stages, pds_ratios=ratios, pds_layers=layers, pds_kernel_sizes=kernels,
        pds_embed_dims=dims, pds_attn_heads=heads, pds_ffn_ratios=ffn_ratios,
        pds_position_embed=tuple(1 for _ in range(stages)),
        pds_ctc=tuple(0 for _ in range(stages)),
    )
    return cfg.replace(**kw)


@register_model_architecture("pdss2t_transformer", "pdss2t_transformer_s")
@register_model_architecture("pdss2t_transformer", "pdss2t_transformer_s_16")
def pdss2t_transformer_s_16(**kw) -> PDSConfig:
    return _pds_preset(4, (2, 2, 2, 2), (2, 2, 6, 2), (5, 5, 5, 5), (256, 256, 256, 256),
                       (4, 4, 4, 4), (8, 8, 8, 8), **kw)


@register_model_architecture("pdss2t_transformer", "pdss2t_transformer_s_4")
def pdss2t_transformer_s_4(**kw) -> PDSConfig:
    return _pds_preset(3, (2, 2, 1), (4, 4, 4), (5, 5, 5), (256, 256, 256), (4, 4, 4),
                       (8, 8, 8), **kw)


@register_model_architecture("pdss2t_transformer", "pdss2t_transformer_s_8")
def pdss2t_transformer_s_8(**kw) -> PDSConfig:
    return _pds_preset(4, (2, 2, 1, 2), (3, 3, 3, 3), (5, 5, 5, 5), (256, 256, 256, 256),
                       (4, 4, 4, 4), (8, 8, 8, 8), **kw)


@register_model_architecture("pdss2t_transformer", "pdss2t_transformer_s_32")
def pdss2t_transformer_s_32(**kw) -> PDSConfig:
    return _pds_preset(5, (2, 2, 2, 2, 2), (2, 2, 3, 3, 2), (5, 5, 5, 5, 5),
                       (256, 256, 256, 256, 256), (4, 4, 4, 4, 4), (8, 8, 8, 8, 8), **kw)


@register_model_architecture("pdss2t_transformer", "pdss2t_transformer_sd")
@register_model_architecture("pdss2t_transformer", "pdss2t_transformer_sd_8")
def pdss2t_transformer_sd_8(**kw) -> PDSConfig:
    # deep-and-thin: the set_pds_deep_8 layer plan
    return _pds_preset(4, (2, 2, 1, 2), (7, 7, 7, 9), (5, 5, 5, 5), (256, 256, 256, 256),
                       (4, 4, 4, 4), (8, 8, 8, 8), **kw)


@register_model_architecture("pdss2t_transformer", "pdss2t_transformer_sd_16")
def pdss2t_transformer_sd_16(**kw) -> PDSConfig:
    return _pds_preset(4, (2, 2, 2, 2), (5, 5, 12, 8), (5, 5, 5, 5), (256, 256, 256, 256),
                       (4, 4, 4, 4), (8, 8, 8, 8), **kw)


@register_model_architecture("pdss2t_transformer", "pdss2t_transformer_sd_32")
def pdss2t_transformer_sd_32(**kw) -> PDSConfig:
    return _pds_preset(5, (2, 2, 2, 2, 2), (5, 5, 7, 7, 6), (5, 5, 5, 5, 5),
                       (256, 256, 256, 256, 256), (4, 4, 4, 4, 4), (8, 8, 8, 8, 8), **kw)


@register_model_architecture("pdss2t_transformer", "pdss2t_transformer_m")
@register_model_architecture("pdss2t_transformer", "pdss2t_transformer_m_16")
def pdss2t_transformer_m(**kw) -> PDSConfig:
    return _pds_preset(4, (2, 2, 2, 2), (2, 2, 6, 2), (5, 5, 5, 5), (512, 512, 512, 512),
                       (8, 8, 8, 8), (4, 4, 4, 4), **kw)


@register_model_architecture("pdss2t_transformer", "pdss2t_transformer_m_8")
def pdss2t_transformer_m_8(**kw) -> PDSConfig:
    return _pds_preset(4, (2, 2, 1, 2), (3, 3, 3, 3), (5, 5, 5, 5), (512, 512, 512, 512),
                       (8, 8, 8, 8), (4, 4, 4, 4), **kw)


@register_model_architecture("pdss2t_transformer", "pdss2t_transformer_m_32")
def pdss2t_transformer_m_32(**kw) -> PDSConfig:
    return _pds_preset(5, (2, 2, 2, 2, 2), (2, 2, 3, 3, 2), (5, 5, 5, 5, 5),
                       (512, 512, 512, 512, 512), (8, 8, 8, 8, 8), (4, 4, 4, 4, 4), **kw)

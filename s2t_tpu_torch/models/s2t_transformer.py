"""S2T Transformer encoder-decoder (counterpart of s2t_tpu/models/s2t_transformer.py).

The plain path of the s/m/l presets: Conv1d-GLU subsampler -> scaled
features + sinusoidal positions -> pre- or post-norm Transformer encoder with
"abs" attention -> CTC head, and a Transformer decoder on top, for serving
and for training (``forward(..., train=True, generator=g)``: every dropout
site of the JAX modules, drawn from the step's generator).
``S2TTransformerConfig`` keeps the JAX config's field names and defaults so a
config crosses over field by field; a field that selects a branch the port
does not have raises ``NotImplementedError`` naming it.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from s2t_tpu_torch.device import resolve_device, torch_dtype
from s2t_tpu_torch.models.transformer_decoder import TransformerDecoder
from s2t_tpu_torch.modules.ctc_head import CTCHead
from s2t_tpu_torch.modules.dropout import dropout
from s2t_tpu_torch.modules.layers import S2TEncoderLayer, layer_norm
from s2t_tpu_torch.modules.positional import fairseq_sinusoidal_encoding
from s2t_tpu_torch.modules.subsampling import Conv1dSubsampling
from s2t_tpu_torch.utils.masking import lengths_to_mask


@dataclass(frozen=True)
class S2TTransformerConfig:
    """Field for field the JAX S2TTransformerConfig (same names, same
    defaults); see there for what each field means."""

    input_feat_per_channel: int = 80
    input_channels: int = 1
    subsampling_type: str = "conv1d"
    subsampling_layers: int = 2
    subsampling_filter: int = 1024
    subsampling_kernel: int = 5
    subsampling_stride: int = 2
    subsampling_norm: str = "none"
    subsampling_activation: str = "glu"
    subsampling_ref_pad_semantics: bool = False
    subsampling_padding: str = "valid"
    encoder_apply_final_norm: bool = True
    encoder_embed_dim: int = 256
    encoder_ffn_embed_dim: int = 2048
    encoder_layers: int = 12
    encoder_attention_heads: int = 4
    encoder_attention_type: str = "abs"
    max_encoder_relative_length: int = 0
    max_decoder_relative_length: int = 0
    encoder_lconv_kernels: Tuple[int, ...] = ()
    encoder_attention_window: int = 0
    hard_mask_window: float = 0.0
    gauss_mask_sigma: float = 0.0
    init_mask_weight: float = 0.5
    encoder_attention_stride: int = 1
    checkpoint_activations: bool = False
    remat_policy: str = "full"
    encoder_layerdrop: float = 0.0
    encoder_normalize_before: bool = True
    encoder_no_scale_embedding: bool = False
    encoder_embed_linear: bool = False
    encoder_embed_norm: bool = False
    macaron_style: bool = False
    use_cnn_module: bool = False
    cnn_module_kernel: int = 31
    cnn_module_norm: str = "layer_norm"
    conv_module_bias: bool = False
    use_enc_dlcl: bool = False
    seq_parallel: bool = False
    pipeline_parallel: int = 1
    pipeline_microbatches: int = 0
    decoder_embed_dim: int = 256
    decoder_ffn_embed_dim: int = 2048
    decoder_layers: int = 6
    decoder_attention_heads: int = 4
    decoder_normalize_before: bool = True
    decoder_learned_pos: bool = False
    share_decoder_input_output_embed: bool = True
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.1
    activation_fn: str = "relu"
    encoder_activation_fn: str = ""
    use_ctc: bool = True
    ctc_layer: int = 0
    share_ctc_and_embed: bool = False
    inter_ctc_layers: Tuple[int, ...] = ()
    share_inter_ctc: bool = True
    share_inter_ctc_norm: bool = False
    share_inter_xctc_norm: bool = False
    ctc_pae: str = "none"
    pae_ctc_temperature: float = 1.0
    share_pae_and_ctc: bool = False
    ctc_pae_ground_truth_ratio: float = 0.0
    xctc_pae_ground_truth_ratio: float = 0.0
    xctc_pae_ground_truth_only_mistake: bool = False
    pae_oracle_smooth: bool = False
    pae_unnorm_input: bool = False
    use_xctc: bool = False
    xctc_layer: int = 0
    inter_xctc_layers: Tuple[int, ...] = ()
    xctc_pae: str = "none"
    share_xctc_and_embed: bool = False
    use_axctc: bool = False
    inter_axctc_layers: Tuple[int, ...] = ()
    compression_layers: Tuple[int, ...] = ()
    compression_threshold: float = 0.95
    compression_norm: bool = False
    compression_pos: bool = False
    inter_mixup: bool = False
    inter_mixup_layer: int = 0
    inter_mixup_beta: float = 0.5
    inter_mixup_prob: float = 1.0
    inter_mixup_ratio: float = 0.3
    inter_mixup_keep_org: bool = False
    inter_mixup_ratio_decay: bool = False
    inter_mixup_ratio_decay_params: Tuple[float, float, float] = (20000.0, 40000.0, 0.0)
    layer_out_norm: bool = False
    layer_out_norm_interval: int = 1
    vocab_size: int = 1000
    src_vocab_size: int = -1
    max_source_positions: int = 6000
    max_target_positions: int = 1024
    pad_id: int = 1
    dtype_str: str = "float32"

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @property
    def enc_act(self):
        return self.encoder_activation_fn or self.activation_fn

    @property
    def ctc_vocab_size(self):
        return self.src_vocab_size if self.src_vocab_size > 0 else self.vocab_size

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype_str)


# fields the port reads, plus knobs that only act when a switch that must keep its
# default is on (mixup / oracle / compression / inter-CTC sharing, remat_policy);
# encoder_layerdrop > 0 and checkpoint_activations raise when training
# (_check_trainable); every other field must keep its default
_PORTED_FIELDS = frozenset({
    "input_feat_per_channel", "input_channels", "subsampling_layers", "subsampling_filter",
    "subsampling_kernel", "subsampling_stride", "subsampling_activation",
    "encoder_apply_final_norm", "encoder_embed_dim", "encoder_ffn_embed_dim",
    "encoder_layers", "encoder_attention_heads", "encoder_normalize_before",
    "encoder_no_scale_embedding", "decoder_embed_dim", "decoder_ffn_embed_dim",
    "decoder_layers", "decoder_attention_heads", "decoder_normalize_before",
    "share_decoder_input_output_embed", "activation_fn", "encoder_activation_fn",
    "use_ctc", "share_ctc_and_embed", "vocab_size", "src_vocab_size",
    "max_source_positions", "max_target_positions", "pad_id", "dtype_str",
    "dropout", "attention_dropout", "activation_dropout", "checkpoint_activations",
    "remat_policy", "encoder_layerdrop", "share_inter_ctc", "share_inter_ctc_norm",
    "share_inter_xctc_norm", "pae_ctc_temperature", "share_pae_and_ctc",
    "ctc_pae_ground_truth_ratio", "xctc_pae_ground_truth_ratio",
    "xctc_pae_ground_truth_only_mistake", "pae_oracle_smooth", "pae_unnorm_input",
    "compression_threshold", "inter_mixup_layer", "inter_mixup_beta", "inter_mixup_prob",
    "inter_mixup_ratio", "inter_mixup_keep_org", "inter_mixup_ratio_decay",
    "inter_mixup_ratio_decay_params", "layer_out_norm_interval", "cnn_module_kernel",
    "cnn_module_norm", "conv_module_bias", "pipeline_microbatches", "init_mask_weight",
    "subsampling_padding", "ctc_layer", "xctc_layer", "compression_norm", "compression_pos",
})


def _check_trainable(cfg: S2TTransformerConfig) -> None:
    """Training knobs the port has not ported raise instead of being ignored."""
    if cfg.encoder_layerdrop > 0:
        raise NotImplementedError(
            f"S2TTransformerConfig.encoder_layerdrop={cfg.encoder_layerdrop} is not ported to "
            "s2t_tpu_torch training")
    if cfg.checkpoint_activations:
        raise NotImplementedError(
            "S2TTransformerConfig.checkpoint_activations=True (remat) is not ported to "
            "s2t_tpu_torch training")


def check_supported(cfg: S2TTransformerConfig) -> None:
    """Raise NotImplementedError on the first field that selects a branch
    the port does not have."""
    for f in dataclasses.fields(cfg):
        if f.name not in _PORTED_FIELDS and getattr(cfg, f.name) != f.default:
            raise NotImplementedError(
                f"S2TTransformerConfig.{f.name}={getattr(cfg, f.name)!r} is not ported "
                f"to s2t_tpu_torch (only the plain s2t_transformer serving path is)"
            )
    if cfg.share_ctc_and_embed:
        if cfg.encoder_embed_dim != cfg.decoder_embed_dim:
            raise ValueError("share_ctc_and_embed requires encoder_embed_dim == decoder_embed_dim")
        if cfg.ctc_vocab_size != cfg.vocab_size:
            raise ValueError("share_ctc_and_embed needs a joint vocabulary")


class S2TTransformerEncoder(nn.Module):
    """Speech encoder: conv subsampler -> Transformer stack -> CTC head.

    Returns {"encoder_out" (B, T', D), "encoder_lengths" (B,), "ctc_logits"
    (B, T', V_src) or None}.  ``embedding``: the decoder's token table when
    the CTC projection is tied to it."""

    def __init__(self, cfg: S2TTransformerConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.encoder_embed_dim
        self.subsample = Conv1dSubsampling(
            cfg.input_feat_per_channel * cfg.input_channels, cfg.subsampling_layers,
            cfg.subsampling_filter, D, cfg.subsampling_kernel, cfg.subsampling_stride,
            cfg.subsampling_activation,
        )
        self.layers = nn.ModuleList([
            S2TEncoderLayer(D, cfg.encoder_ffn_embed_dim, cfg.encoder_attention_heads,
                            cfg.enc_act, cfg.encoder_normalize_before, cfg.dropout,
                            cfg.attention_dropout, cfg.activation_dropout)
            for _ in range(cfg.encoder_layers)
        ])
        self.final_norm = layer_norm(D) if cfg.encoder_normalize_before else None
        self.ctc_head = (
            CTCHead(D, cfg.ctc_vocab_size, tied=cfg.share_ctc_and_embed, dropout=cfg.dropout)
            if cfg.use_ctc else None
        )
        self.register_buffer(
            "positions",
            fairseq_sinusoidal_encoding(cfg.max_source_positions, D, cfg.pad_id),
            persistent=False,
        )

    def forward(self, features: torch.Tensor, lengths: torch.Tensor,
                embedding: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        cfg = self.cfg
        # the positions table is in the compute dtype
        x, lengths = self.subsample(features.to(self.positions.dtype), lengths)
        if not cfg.encoder_no_scale_embedding:
            x = x * math.sqrt(cfg.encoder_embed_dim)
        T = x.shape[1]
        # fairseq table: valid frame i gets absolute position pad+1+i
        x = dropout(x + self.positions[:T][None], cfg.dropout, generator)
        valid = lengths_to_mask(lengths, T)
        for layer in self.layers:
            x = layer(x, valid, generator=generator)
        if self.final_norm is not None and cfg.encoder_apply_final_norm:
            x = self.final_norm(x)
        ctc_logits = None if self.ctc_head is None else self.ctc_head(x, embedding, generator)
        return {"encoder_out": x, "encoder_lengths": lengths, "ctc_logits": ctc_logits}


class S2TTransformerModel(nn.Module):
    """Encoder-decoder speech model.  Built on CPU from ``seed`` with an
    explicit ``torch.Generator`` (so the same seed gives the same weights on
    every device), then moved to ``device``.

    For serving (the default) the parameters are stored in ``cfg.dtype``,
    frozen, in eval mode.  ``for_training=True`` keeps float32 master
    parameters that require grad and computes in ``cfg.dtype`` (the layers
    cast their weights at use, ``modules/cast.py``), as the flax modules keep
    float32 params and compute in ``dtype``."""

    def __init__(self, cfg: S2TTransformerConfig, device="cuda", seed: int = 0,
                 for_training: bool = False):
        super().__init__()
        check_supported(cfg)
        if for_training:
            _check_trainable(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        self.encoder = S2TTransformerEncoder(cfg)
        self.decoder = TransformerDecoder(
            vocab_size=cfg.vocab_size,
            embed_dim=cfg.decoder_embed_dim,
            ffn_dim=cfg.decoder_ffn_embed_dim,
            num_layers=cfg.decoder_layers,
            num_heads=cfg.decoder_attention_heads,
            activation=cfg.activation_fn,
            normalize_before=cfg.decoder_normalize_before,
            share_input_output_embed=cfg.share_decoder_input_output_embed,
            max_positions=cfg.max_target_positions,
            pad_id=cfg.pad_id,
            dropout=cfg.dropout,
            attention_dropout=cfg.attention_dropout,
            activation_dropout=cfg.activation_dropout,
        )
        self.init_weights(seed)
        if for_training:
            self.to(device=device)
            for mod in self.modules():  # the positions tables set the compute dtype
                for name, buf in mod._buffers.items():
                    if buf is not None and buf.is_floating_point():
                        mod._buffers[name] = buf.to(cfg.dtype)
        else:
            self.to(device=device, dtype=cfg.dtype)
            self.eval()
            self.requires_grad_(False)

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """Flax-like init: dense and conv kernels N(0, 1/fan_in), biases 0,
        LayerNorm 1/0, token embeddings N(0, 1/D)."""
        g = torch.Generator().manual_seed(seed)
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Conv1d)):
                fan_in = mod.weight[0].numel()
                nn.init.normal_(mod.weight, std=fan_in ** -0.5, generator=g)
                if mod.bias is not None:
                    nn.init.zeros_(mod.bias)
            elif isinstance(mod, nn.LayerNorm):
                nn.init.ones_(mod.weight)
                nn.init.zeros_(mod.bias)
            elif isinstance(mod, nn.Embedding):
                nn.init.normal_(mod.weight, std=mod.embedding_dim ** -0.5, generator=g)

    @property
    def device(self) -> torch.device:
        return self.decoder.embed_tokens.weight.device

    def _ctc_embedding(self):
        return self.decoder.embed_tokens.weight if self.cfg.share_ctc_and_embed else None

    def forward(self, features, feat_lengths, prev_tokens, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """Teacher-forced forward.  ``train=True`` applies every dropout with
        bits from ``generator`` (on the model's device); otherwise no dropout."""
        if train:
            _check_trainable(self.cfg)
            if generator is None:
                raise ValueError("train=True needs the step's torch.Generator")
        else:
            generator = None
        enc = self.encoder(features, feat_lengths, self._ctc_embedding(), generator)
        enc_mask = lengths_to_mask(enc["encoder_lengths"], enc["encoder_out"].shape[1])
        logits = self.decoder(prev_tokens, enc["encoder_out"], enc_mask, generator)
        return {"decoder_logits": logits, **enc}

    # --- inference-facing methods (used by the generator) -------------------
    def encode(self, features, feat_lengths):
        return self.encoder(features, feat_lengths, self._ctc_embedding())

    def decode(self, prev_tokens, encoder_out, encoder_valid_mask):
        return self.decoder(prev_tokens, encoder_out, encoder_valid_mask)

    def decode_step(self, tokens, cache, index, encoder_out, encoder_valid_mask, cross_kv=None):
        return self.decoder.step(tokens, cache, index, encoder_out, encoder_valid_mask,
                                 cross_kv=cross_kv)

    def precompute_cross(self, encoder_out):
        return self.decoder.precompute_cross(encoder_out)

    def init_cache(self, batch_size: int, max_len: int):
        return self.decoder.init_cache(batch_size, max_len)


# --------------------------------------------------------------------------- #
# architecture presets (same values as the JAX package's)
# --------------------------------------------------------------------------- #


def base_architecture(**kw) -> S2TTransformerConfig:
    return S2TTransformerConfig(
        encoder_embed_dim=512, encoder_ffn_embed_dim=2048,
        encoder_attention_heads=8, decoder_embed_dim=512,
        decoder_ffn_embed_dim=2048, decoder_attention_heads=8,
    ).replace(**kw)


def s2t_transformer_s(**kw) -> S2TTransformerConfig:
    return S2TTransformerConfig(
        encoder_embed_dim=256, encoder_ffn_embed_dim=2048,
        encoder_attention_heads=4, decoder_embed_dim=256,
        decoder_ffn_embed_dim=2048, decoder_attention_heads=4, dropout=0.1,
    ).replace(**kw)


def s2t_transformer_m(**kw) -> S2TTransformerConfig:
    return S2TTransformerConfig(
        encoder_embed_dim=512, encoder_ffn_embed_dim=2048,
        encoder_attention_heads=8, decoder_embed_dim=512,
        decoder_ffn_embed_dim=2048, decoder_attention_heads=8, dropout=0.15,
    ).replace(**kw)


def s2t_transformer_l(**kw) -> S2TTransformerConfig:
    return S2TTransformerConfig(
        encoder_embed_dim=1024, encoder_ffn_embed_dim=4096,
        encoder_attention_heads=16, decoder_embed_dim=1024,
        decoder_ffn_embed_dim=4096, decoder_attention_heads=16, dropout=0.2,
    ).replace(**kw)

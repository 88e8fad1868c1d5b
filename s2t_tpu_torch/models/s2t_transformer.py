"""S2T Transformer / Conformer encoder-decoder (counterpart of
s2t_tpu/models/s2t_transformer.py).

The encoder: a Conv1d-GLU or Conv2d subsampler -> scaled features +
sinusoidal positions (none under rope, a relative-position table under
rel_pos) -> [embed_linear] -> pre- or post-norm layers, optionally Conformer
(macaron FFN, convolution module), with any self-attention type of the JAX
layer (abs, rope, Shaw relative, Gaussian local, windowed, reduced keys,
rel_pos, lightweight or dynamic convolutions) and optionally DLCL (every layer
reads a learned combination of the outputs before it) -> CTC head; a
Transformer decoder on top, whose self-attention is Shaw relative when
``max_decoder_relative_length`` > 0.  It serves and
trains (``forward(..., train=True, generator=g)``: every dropout site of the
JAX modules, drawn from the step's generator).

The CTC research stack of the JAX encoder rides the layer loop: inter-CTC
taps (a per-tap or the final norm, a shared or per-tap head) with PAE
re-injection and its ground-truth oracle, inter-XCTC taps with their own PAE,
AXCTC taps, per-layer output norms, CTC-blank compression that left-packs the
kept frames and shortens the lengths mid-stack, and inter-mixup.  The mixup
draws and the oracle's uniform draws are made on the host from numpy
generators seeded by the step's generator seed (``draw_mixup``,
``adapter.host_uniform``), so the card and the CPU draw alike.

``S2TTransformerConfig`` keeps the JAX config's field names and defaults so a
config crosses over field by field; a field that selects a branch the port
does not have raises ``NotImplementedError`` naming it (and the ROADMAP.md
item that ports it).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from s2t_tpu_torch.device import resolve_device, torch_dtype
from s2t_tpu_torch.models.transformer_decoder import TransformerDecoder
from s2t_tpu_torch.modules.adapter import Adapter, ctc_oracle_probs, host_uniform
from s2t_tpu_torch.modules.ctc_head import CTCHead
from s2t_tpu_torch.modules.attention import local_window_bias, padding_bias
from s2t_tpu_torch.modules.cast import Linear
from s2t_tpu_torch.modules.dlcl import DLCL
from s2t_tpu_torch.modules.dropout import dropout
from s2t_tpu_torch.modules.layers import S2TEncoderLayer, layer_norm
from s2t_tpu_torch.modules.lightconv import LightweightConv
from s2t_tpu_torch.modules.positional import (
    fairseq_sinusoidal_encoding, relative_table, sinusoidal_table)
from s2t_tpu_torch.modules.subsampling import (
    Conv1dSubsampling, Conv2dSubsampling, check_features)
from s2t_tpu_torch.parallel.collectives import gather, group_rank, group_size, split
from s2t_tpu_torch.parallel.context import get_mesh, ring_scope, seq_parallel_enabled
from s2t_tpu_torch.parallel.pipeline import pipeline_apply
from s2t_tpu_torch.registry import register_model, register_model_architecture
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
# default is on (pipeline_microbatches); every other field must keep its default
_PORTED_FIELDS = frozenset({
    "input_feat_per_channel", "input_channels", "subsampling_layers", "subsampling_filter",
    "subsampling_kernel", "subsampling_stride", "subsampling_activation",
    "encoder_apply_final_norm", "encoder_embed_dim", "encoder_ffn_embed_dim",
    "encoder_layers", "encoder_attention_heads", "encoder_normalize_before",
    "encoder_no_scale_embedding", "encoder_embed_norm", "decoder_embed_dim",
    "decoder_ffn_embed_dim", "decoder_layers", "decoder_attention_heads",
    "decoder_normalize_before",
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
    # the Conformer block and the Conv2d subsampler, checked in check_supported
    "encoder_attention_type", "macaron_style", "use_cnn_module", "subsampling_type",
    "subsampling_norm",
    # the encoder variants
    "subsampling_ref_pad_semantics", "encoder_lconv_kernels", "max_encoder_relative_length",
    "max_decoder_relative_length", "encoder_attention_window", "hard_mask_window",
    "gauss_mask_sigma", "encoder_attention_stride", "use_enc_dlcl", "encoder_embed_linear",
    # the CTC research stack of the layer loop
    "inter_ctc_layers", "ctc_pae", "use_xctc", "inter_xctc_layers", "xctc_pae",
    "share_xctc_and_embed", "use_axctc", "inter_axctc_layers", "compression_layers",
    "inter_mixup", "layer_out_norm",
    # learned decoder positions, and the parallel layouts (parallel/)
    "decoder_learned_pos", "seq_parallel", "pipeline_parallel",
})


REMAT_POLICIES = ("full", "dots", "dots_no_batch")


def _check_trainable(cfg: S2TTransformerConfig) -> None:
    """The training knobs' values (s2t_tpu/models/s2t_transformer.py:89-97)."""
    if cfg.checkpoint_activations and cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {cfg.remat_policy!r} not in {REMAT_POLICIES}")


def check_supported(cfg: S2TTransformerConfig) -> None:
    """Raise NotImplementedError on the first field that selects a branch
    the port does not have."""
    for f in dataclasses.fields(cfg):
        if f.name not in _PORTED_FIELDS and getattr(cfg, f.name) != f.default:
            raise NotImplementedError(
                f"S2TTransformerConfig.{f.name}={getattr(cfg, f.name)!r} is not ported "
                "to s2t_tpu_torch")
    if cfg.subsampling_type not in ("conv1d", "conv2d"):
        raise NotImplementedError(
            f"S2TTransformerConfig.subsampling_type={cfg.subsampling_type!r} is not ported to "
            "s2t_tpu_torch")
    if cfg.inter_mixup_keep_org and cfg.use_enc_dlcl and cfg.inter_mixup_layer > 0:
        raise ValueError("inter_mixup_keep_org grows the batch mid-stack, which is incompatible "
                         "with DLCL history; use inter_mixup_layer<=0")
    if cfg.share_ctc_and_embed or cfg.share_xctc_and_embed:
        if cfg.encoder_embed_dim != cfg.decoder_embed_dim:
            raise ValueError("share_(x)ctc_and_embed requires encoder_embed_dim == "
                             "decoder_embed_dim")
        if cfg.share_ctc_and_embed and cfg.ctc_vocab_size != cfg.vocab_size:
            raise ValueError("share_ctc_and_embed needs a joint vocabulary")
    # the JAX encoder's setup checks (s2t_tpu/models/s2t_transformer.py:491-517)
    missing = [l for l in cfg.compression_layers
               if not cfg.use_ctc or l not in cfg.inter_ctc_layers]
    if missing:
        raise ValueError(f"compression_layers {missing} need use_ctc=True and a matching entry "
                         "in inter_ctc_layers (the CTC logit source, as in the reference)")
    check_parallel(cfg)


def check_parallel(cfg) -> None:
    """The JAX encoder's refusals for its pipelined and sequence-parallel stacks
    (s2t_tpu/models/s2t_transformer.py:373-403, 474-490)."""
    if cfg.pipeline_parallel > 1:
        S = cfg.pipeline_parallel
        incompatible = [
            ("use_enc_dlcl", cfg.use_enc_dlcl),
            ("encoder_layerdrop", cfg.encoder_layerdrop > 0),
            ("seq_parallel", cfg.seq_parallel),
            ("compression_layers", bool(cfg.compression_layers)),
            ("inter_mixup_layer>0", cfg.inter_mixup and cfg.inter_mixup_layer > 0),
            ("inter_ctc_layers", bool(cfg.inter_ctc_layers)),
            ("inter_xctc_layers", bool(cfg.inter_xctc_layers)),
            ("inter_axctc_layers", bool(cfg.inter_axctc_layers)),
            ("layer_out_norm", getattr(cfg, "layer_out_norm", False)),
            ("per-layer lconv kernels", len(set(cfg.encoder_lconv_kernels)) > 1),
        ]
        bad = [n for n, v in incompatible if v]
        if bad:
            raise ValueError(
                f"pipeline_parallel={S} is incompatible with {bad}: "
                "pipeline stages are homogeneous layer blocks with no "
                "interior taps (reference PP has the same restriction — "
                "it only exists for the vanilla transformer)")
        if cfg.encoder_layers % S:
            raise ValueError(
                f"encoder_layers ({cfg.encoder_layers}) must divide "
                f"evenly into pipeline_parallel={S} stages")
    if cfg.seq_parallel:
        if cfg.encoder_attention_window > 0:
            raise ValueError(
                "seq_parallel is incompatible with "
                "encoder_attention_window (ring attention has no "
                "windowed-bias path)")
        if cfg.attention_dropout > 0:
            raise ValueError(
                "seq_parallel requires attention_dropout=0 (ring "
                "attention applies no attention-probability dropout; "
                "set attention_dropout: 0 explicitly)")


# the modules whose default init ``init_and_place`` overwrites, weights and biases alike
DEFAULT_INIT_MODULES = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Embedding)


def skip_default_init(module: nn.Module) -> None:
    """The ``reset_parameters`` of DEFAULT_INIT_MODULES while a model is built."""


def seeded_init(init):
    """Decorate the ``__init__`` of a model that ends with ``init_and_place``: while it
    builds its modules, torch's default init of DEFAULT_INIT_MODULES (drawn from the
    global generator, then overwritten from the seed) is skipped.  On the CPU that init
    took about half of a model's build."""
    @functools.wraps(init)
    def build(*args, **kw):
        saved = [(cls, cls.__dict__.get("reset_parameters")) for cls in DEFAULT_INIT_MODULES]
        for cls, _ in saved:
            cls.reset_parameters = lambda module: skip_default_init(module)
        try:
            return init(*args, **kw)
        finally:
            for cls, reset in saved:
                if reset is None:  # inherited (the convolutions' _ConvNd)
                    del cls.reset_parameters
                else:
                    cls.reset_parameters = reset

    return build


@torch.no_grad()
def init_and_place(model: nn.Module, cfg: S2TTransformerConfig, device: torch.device,
                   seed: int, for_training: bool) -> None:
    """Flax-like init on the CPU from ``seed`` (dense and conv kernels
    N(0, 1/fan_in), biases 0, LayerNorm 1/0, token embeddings N(0, 1/D); the
    frozen affines' ``norm_scale`` 1 / ``norm_bias`` 0, an embedding with an
    ``init_std`` attribute N(0, init_std^2), the PDS fusion's
    ``fusion_weight`` 1/len, the relative attentions' ``pos_bias_u`` /
    ``pos_bias_v`` / ``relative_position_keys`` Xavier-uniform, the adapters'
    ``embed_adapter`` N(0, 1/D), a lightweight conv's kernel N(0, 0.01), wav2vec
    2.0's ``mask_emb`` and codebook ``vars`` U[0, 1), Berard's LSTM weights and
    wav2vec's ``step_proj`` N(0, 1/fan_in), the k-means ``codebook`` N(0, 0.01^2); the
    Gaussian attention's and DLCL's constants keep their values from
    construction), then onto ``device``: for serving stored in
    ``cfg.dtype``, frozen, in eval mode; ``for_training`` keeps float32 master
    parameters and casts only the buffers."""
    g = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            fan_in = mod.weight[0].numel()
            nn.init.normal_(mod.weight, std=fan_in ** -0.5, generator=g)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.LayerNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.Embedding):
            nn.init.normal_(mod.weight, std=getattr(mod, "init_std", mod.embedding_dim ** -0.5),
                            generator=g)
        for name, p in mod.named_parameters(recurse=False):
            if name == "norm_scale":
                nn.init.ones_(p)
            elif name == "norm_bias":
                nn.init.zeros_(p)
            elif name == "fusion_weight":
                nn.init.constant_(p, 1.0 / p.numel())
            elif name in ("pos_bias_u", "pos_bias_v", "relative_position_keys"):
                limit = math.sqrt(6.0 / sum(p.shape))
                nn.init.uniform_(p, -limit, limit, generator=g)
            elif name == "embed_adapter":
                nn.init.normal_(p, std=p.shape[1] ** -0.5, generator=g)
            elif name in ("mask_emb", "vars"):  # wav2vec 2.0: flax uniform(1.0)
                nn.init.uniform_(p, 0.0, 1.0, generator=g)
            elif name in ("weight_ih", "weight_hh", "step_proj"):  # Berard's LSTMs, wav2vec's
                nn.init.normal_(p, std=p.shape[-1 if name != "step_proj" else 0] ** -0.5,
                                generator=g)
            elif name == "codebook":  # the k-means quantizer's: flax 0.01 N(0, 1)
                nn.init.normal_(p, std=0.01, generator=g)
            elif name == "weight" and isinstance(mod, LightweightConv):
                nn.init.normal_(p, std=0.1, generator=g)
    if for_training:
        model.to(device=device)
        for mod in model.modules():
            for name, buf in mod._buffers.items():
                if buf is not None and buf.is_floating_point():
                    mod._buffers[name] = buf.to(cfg.dtype)
    else:
        model.to(device=device, dtype=cfg.dtype)
        model.eval()
        model.requires_grad_(False)


# the streams of the host draws, beside the step's generator seed (drop-net's:
# sate.CrossStreamTextLayer)
MIXUP_STREAM, ORACLE_STREAM, DROPNET_STREAM, LAYERDROP_STREAM = 1, 2, 3, 4
# the dropout generators of a pipeline stage's microbatch and of a sequence rank's frames
PIPE_STREAM, SEQ_STREAM = 5, 6


def stream_generator(generator: Optional[torch.Generator], *data: int):
    """A generator of its own for (stream, ...) of the step's ``generator`` (None: none),
    so that work split over ranks draws the same bits wherever it runs and leaves the
    step generator as every rank sees it."""
    if generator is None:
        return None
    seed = generator.initial_seed()
    from s2t_tpu_torch.trainer import fold_in

    for d in data:
        seed = fold_in(seed, d)
    return torch.Generator(device=generator.device).manual_seed(seed)


def draw_layer_keep(n_layers: int, rate: float, seed: int) -> List[bool]:
    """LayerDrop's keep bits of one step: layer i runs iff its U[0, 1) draw is >=
    ``rate`` (s2t_tpu/models/s2t_transformer.py:785-790), drawn on the host from the
    step generator's seed, so the loop knows them without a sync."""
    u = host_uniform((n_layers,), (seed, LAYERDROP_STREAM))
    return [bool(x) for x in (u >= rate)]


# what a checkpointed layer saves (jax.checkpoint_policies.checkpoint_dots and
# checkpoint_dots_with_no_batch_dims): the matmul outputs, or those with no batch dim
_SAVED_OPS = {
    "dots": ("mm", "addmm", "bmm", "baddbmm"),
    "dots_no_batch": ("mm", "addmm"),
}


def remat_context(policy: str):
    """``torch.utils.checkpoint``'s ``context_fn`` for a remat policy (None: "full",
    which saves nothing inside the layer)."""
    if policy == "full":
        return None
    from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

    saved = {getattr(torch.ops.aten, name).default for name in _SAVED_OPS[policy]}

    def rule(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, rule)


def draw_mixup(B: int, cfg: S2TTransformerConfig, seed: int,
               step: Optional[int] = None) -> Dict[str, Any]:
    """The random draws of one inter-mixup (s2t_tpu/models/s2t_transformer.py:528-593),
    made on the host from a numpy generator seeded by (``seed``, ``step``).

    m = max(int(B ratio), 1) mixed rows; ``inter_mixup_prob`` decides whether
    any row mixes; with ``inter_mixup_ratio_decay`` and a ``step`` only the
    first floor(B ratio_t) mixed rows are live.  ``keep_org`` (AIPA): rows
    [all B originals | m mixed], keep_boundary 0, an unlive mixed row weighs 0;
    otherwise [originals m .. B-1 | m mixed], keep_boundary m, an unlive mixed
    slot j keeps original j.  Returns numpy ``index1`` / ``index2`` (int64),
    ``coef`` (float32, 1 where not mixed), ``flag`` (bool), ``weight``
    (float32) and the int ``keep_boundary``."""
    m = max(int(B * cfg.inter_mixup_ratio), 1)
    rng = np.random.default_rng([seed, MIXUP_STREAM, 0 if step is None else step])
    apply = rng.random() < cfg.inter_mixup_prob
    r1 = rng.integers(0, B, size=m)
    r2 = rng.integers(0, B, size=m)
    live = np.full(m, True)
    if cfg.inter_mixup_ratio_decay and step is not None:
        s0, s1, r_end = cfg.inter_mixup_ratio_decay_params
        t = np.clip((np.float32(step) - np.float32(s0)) / np.float32(max(s1 - s0, 1.0)),
                    np.float32(0.0), np.float32(1.0))
        ratio_t = np.float32(cfg.inter_mixup_ratio) + t * np.float32(r_end - cfg.inter_mixup_ratio)
        live = np.arange(m) < int(np.floor(np.float32(B) * ratio_t))
    live = live & apply
    if cfg.inter_mixup_keep_org:
        idx1 = np.concatenate([np.arange(B), r1])
        idx2 = np.concatenate([np.arange(B), r2])
        flag = np.concatenate([np.zeros(B, bool), live])
        weight = np.concatenate([np.ones(B, np.float32), live.astype(np.float32)])
        kb = 0
    else:
        slot = np.arange(m)  # an unlive slot j keeps original j
        idx1 = np.concatenate([np.arange(m, B), np.where(live, r1, slot)])
        idx2 = np.concatenate([np.arange(m, B), np.where(live, r2, slot)])
        flag = np.concatenate([np.zeros(B - m, bool), live])
        weight = np.ones(B, np.float32)
        kb = m
    beta = cfg.inter_mixup_beta
    coef = np.where(flag, rng.beta(beta, beta, size=flag.shape), 1.0).astype(np.float32)
    return {"index1": idx1.astype(np.int64), "index2": idx2.astype(np.int64), "coef": coef,
            "flag": flag, "weight": weight, "keep_boundary": kb}


def apply_mixup(x: torch.Tensor, lengths: torch.Tensor, draws: Dict[str, Any]):
    """Blend the rows of ``x`` (B, T, D) by ``draws`` (``draw_mixup``'s, or the
    ``mixup`` dict of a JAX forward): padded frames are zeroed first, row r
    becomes coef_r x[index1_r] + (1 - coef_r) x[index2_r], a mixed row's
    length is the longer source's.  Returns (x, lengths, the mixup dict as
    tensors on x's device)."""
    dev = x.device
    mix = {k: torch.as_tensor(np.array(draws[k]), device=dev)
           for k in ("index1", "index2", "coef", "flag", "weight")}
    mix["index1"], mix["index2"] = mix["index1"].long(), mix["index2"].long()
    mix["keep_boundary"] = int(draws["keep_boundary"])
    i1, i2, flag = mix["index1"], mix["index2"], mix["flag"]
    x = x * lengths_to_mask(lengths, x.shape[1])[..., None].to(x.dtype)
    c = mix["coef"][:, None, None].to(x.dtype)
    x = c * x[i1] + (1.0 - c) * x[i2]
    lengths = torch.where(flag, torch.maximum(lengths[i1], lengths[i2]), lengths[i1])
    return x, lengths, mix


def _taps(layers, n_layers: int, top: bool = False):
    """The 1-indexed layers a tap sits after (the last layer only when ``top``)."""
    return tuple(l for l in dict.fromkeys(layers) if 1 <= l < n_layers + int(top))


def encoder_layer(cfg: S2TTransformerConfig, i: int) -> S2TEncoderLayer:
    """The encoder's layer i (s2t_tpu/models/s2t_transformer.py:355-372)."""
    kernels = cfg.encoder_lconv_kernels
    return S2TEncoderLayer(
        cfg.encoder_embed_dim, cfg.encoder_ffn_embed_dim, cfg.encoder_attention_heads,
        cfg.enc_act, cfg.encoder_normalize_before, cfg.dropout,
        cfg.attention_dropout, cfg.activation_dropout,
        cfg.encoder_attention_type, cfg.macaron_style, cfg.use_cnn_module,
        cfg.cnn_module_kernel, conv_activation=cfg.activation_fn,
        conv_norm_type=cfg.cnn_module_norm, conv_bias=cfg.conv_module_bias,
        attention_stride=cfg.encoder_attention_stride,
        max_relative_length=cfg.max_encoder_relative_length,
        gauss_mask_sigma=cfg.gauss_mask_sigma,
        init_mask_weight=cfg.init_mask_weight,
        # the kernel plan, its last width repeated (s2t_transformer.py:361-368)
        lconv_kernel=kernels[min(i, len(kernels) - 1)] if kernels else 15)


class PipeStageBlock(nn.Module):
    """One pipeline stage: a contiguous block of ``n_layers`` encoder layers
    (s2t_tpu/models/s2t_transformer.py:271-299)."""

    def __init__(self, cfg: S2TTransformerConfig, n_layers: int):
        super().__init__()
        self.layers = nn.ModuleList([encoder_layer(cfg, j) for j in range(n_layers)])


def seq_chunkable(layer) -> bool:
    """A layer that runs on a slice of the frames with the ring in its self-attention:
    abs attention with every key, no convolution over time, no pooling."""
    attn = getattr(layer, "self_attn", None)
    return (getattr(layer, "attention_type", None) == "abs" and layer.conv_module is None
            and layer.se_fc1 is None and layer.collaboration_mode == "none"
            and attn.kv_stride == 1 and not attn.gauss)


class S2TTransformerEncoder(nn.Module):
    """Speech encoder: conv subsampler -> Transformer / Conformer stack -> CTC heads.

    ``forward(features, lengths, embedding, generator, transcript=...,
    transcript_lengths=..., target=..., target_lengths=..., num_updates=...)``
    returns the JAX encoder's dict: "encoder_out" (B, T', D), "encoder_lengths"
    (B,), "ctc_logits" (B, T', V_src) or None, "inter_ctc_logits" ((layer,
    logits), ...), "xctc_logits", "inter_xctc_logits", "axctc_logits",
    "inter_axctc_logits" and "mixup" (None, or the draws as tensors).
    ``embedding``: the decoder's token table when a CTC or XCTC projection is
    tied to it.  With a ``generator`` (training) mixup draws and the PAE
    oracle substitutes (from ``transcript`` / ``target``)."""

    def __init__(self, cfg: S2TTransformerConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.encoder_embed_dim
        in_dim = cfg.input_feat_per_channel * cfg.input_channels
        mask_between = not cfg.subsampling_ref_pad_semantics
        if cfg.subsampling_type == "conv2d":
            # s2t_tpu/models/s2t_transformer.py:347-353: no subsampling_norm reaches it
            self.subsample = Conv2dSubsampling(
                in_dim, cfg.subsampling_layers, cfg.subsampling_filter, D,
                cfg.subsampling_kernel, cfg.subsampling_stride, cfg.subsampling_activation,
                cfg.subsampling_padding, mask_between)
        else:
            self.subsample = Conv1dSubsampling(
                in_dim, cfg.subsampling_layers, cfg.subsampling_filter, D,
                cfg.subsampling_kernel, cfg.subsampling_stride, cfg.subsampling_activation,
                cfg.subsampling_norm, mask_between)
        if cfg.pipeline_parallel > 1:
            # S stages of encoder_layers / S layers each (s2t_tpu/models/s2t_transformer.py:
            # 271-299, 404-413); the flax tree stacks them on a leading axis
            S = cfg.pipeline_parallel
            self.layers = nn.ModuleList()
            self.pipe_stages = nn.ModuleList([PipeStageBlock(cfg, cfg.encoder_layers // S)
                                              for _ in range(S)])
        else:
            self.layers = nn.ModuleList([encoder_layer(cfg, i)
                                         for i in range(cfg.encoder_layers)])
            self.pipe_stages = None
        self.dlcl = DLCL(cfg.encoder_layers, D) if cfg.use_enc_dlcl else None
        self.embed_norm = layer_norm(D) if cfg.encoder_embed_norm else None
        self.embed_linear = Linear(D, D) if cfg.encoder_embed_linear else None
        self.final_norm = layer_norm(D) if cfg.encoder_normalize_before else None
        self.ctc_head = (
            CTCHead(D, cfg.ctc_vocab_size, tied=cfg.share_ctc_and_embed, dropout=cfg.dropout)
            if cfg.use_ctc else None
        )
        # the taps the layer loop reaches, and only the modules they call (as flax
        # creates parameters only for the submodules a call reaches)
        L = cfg.encoder_layers
        self.ctc_taps = _taps(cfg.inter_ctc_layers, L) if cfg.use_ctc else ()
        self.xctc_taps = _taps(cfg.inter_xctc_layers, L) if cfg.use_xctc else ()
        self.axctc_taps = _taps(cfg.inter_axctc_layers, L, top=True) if cfg.use_axctc else ()

        def norms(taps):
            return nn.ModuleDict({str(l): layer_norm(D) for l in taps}) if taps else None

        self.inter_ctc_heads = (
            nn.ModuleDict({str(l): CTCHead(D, cfg.ctc_vocab_size, dropout=cfg.dropout)
                           for l in self.ctc_taps})
            if self.ctc_taps and not cfg.share_inter_ctc else None)
        self.inter_ctc_norms = None if cfg.share_inter_ctc_norm else norms(self.ctc_taps)
        self.pae = (Adapter(D, cfg.ctc_vocab_size, cfg.ctc_pae, cfg.pae_ctc_temperature)
                    if self.ctc_taps and cfg.ctc_pae != "none" else None)
        self.xctc_head = (CTCHead(D, cfg.vocab_size, tied=cfg.share_xctc_and_embed,
                                  dropout=cfg.dropout) if cfg.use_xctc else None)
        self.inter_xctc_norms = None if cfg.share_inter_xctc_norm else norms(self.xctc_taps)
        self.xpae = (Adapter(D, cfg.vocab_size, cfg.xctc_pae, cfg.pae_ctc_temperature)
                     if self.xctc_taps and cfg.xctc_pae != "none" else None)
        self.axctc_head = (CTCHead(D, cfg.vocab_size, dropout=cfg.dropout)
                           if cfg.use_axctc else None)
        self.inter_axctc_norms = norms(self.axctc_taps)
        self.compression_norms = (
            norms([l for l in cfg.compression_layers if l in self.ctc_taps])
            if cfg.compression_norm else None)
        iv = max(cfg.layer_out_norm_interval, 1)
        self.layer_out_norms = (nn.ModuleDict({str(i): layer_norm(D) for i in range(L)
                                               if i % iv == 0})
                                if cfg.layer_out_norm else None)
        self.rel_pos = cfg.encoder_attention_type == "rel_pos"
        # abs positions for every type but rel_pos and rope (s2t_transformer.py:721-725)
        self.abs_pos = cfg.encoder_attention_type not in ("rel_pos", "rope")
        if self.abs_pos:
            self.register_buffer(
                "positions",
                fairseq_sinusoidal_encoding(cfg.max_source_positions, D, cfg.pad_id),
                persistent=False,
            )

    def _window(self, T: int) -> int:
        """The attention window at length T: ``encoder_attention_window``, or under local
        attention a ``hard_mask_window`` (a share of the padded T when in (0, 1])."""
        cfg = self.cfg
        hw = cfg.hard_mask_window
        if cfg.encoder_attention_type == "local" and hw:
            return int(T * hw) if 0 < hw <= 1 else int(hw)
        return cfg.encoder_attention_window

    def _mixup(self, x, lengths, generator, num_updates):
        draws = draw_mixup(x.shape[0], self.cfg, generator.initial_seed(), num_updates)
        return apply_mixup(x, lengths, draws)

    def _oracle(self, logits, lengths, tokens, token_lengths, ratio, generator, layer, stream):
        """The PAE oracle's probabilities at one tap (s2t_tpu/models/s2t_transformer.py:678-690),
        its uniform draws from the host by (step seed, layer, CTC 0 / XCTC 1)."""
        cfg = self.cfg
        uniform = host_uniform(logits.shape[:2], (generator.initial_seed(), ORACLE_STREAM,
                                                  layer, stream))
        return ctc_oracle_probs(logits, lengths, tokens, token_lengths, uniform, ratio,
                                temperature=cfg.pae_ctc_temperature, smooth=cfg.pae_oracle_smooth,
                                only_mistake=cfg.xctc_pae_ground_truth_only_mistake)

    def _run_layer(self, layer, x, valid, bias, generator, pos_emb):
        """One encoder layer; with ``checkpoint_activations`` in training it runs under
        ``torch.utils.checkpoint`` (non-reentrant) with ``remat_policy``'s saved set
        (s2t_tpu/models/s2t_transformer.py:256-268), drawing its dropout (the fused
        attention's seed included) from a generator that starts at the step generator's
        state, which the recompute replays; the step generator then moves on as if the
        layer had drawn from it, so remat changes no bit."""
        if generator is None or not self.cfg.checkpoint_activations:
            return layer(x, valid, bias, generator=generator, pos_emb=pos_emb)
        from torch.utils.checkpoint import checkpoint

        start, end = generator.get_state(), []

        def run(h):
            gen = torch.Generator(device=h.device)
            gen.set_state(start)
            out = layer(h, valid, bias, generator=gen, pos_emb=pos_emb)
            if not end:  # the first call's, not the recompute's
                end.append(gen.get_state())
            return out

        kw = {}
        context = remat_context(self.cfg.remat_policy)
        if context is not None:
            kw["context_fn"] = context
        out = checkpoint(run, x, use_reentrant=False, preserve_rng_state=False, **kw)
        generator.set_state(end[0])
        return out

    def _layer(self, i, layer, x, valid, bias, generator, pos_emb):
        """Encoder layer i.  Under ``seq_parallel`` with a "seq" group in the mesh a layer
        that ``seq_chunkable`` admits runs on this rank's slice of the frames (padded to a
        multiple of the group), its self-attention through the ring, its dropout from the
        rank's own generator, and the slices are gathered after it; any other layer runs
        whole on every rank (the sum convention keeps its gradients right)."""
        if not (self.cfg.seq_parallel and seq_parallel_enabled() and bias is None
                and seq_chunkable(layer)):
            return self._run_layer(layer, x, valid, bias, generator, pos_emb)
        group = get_mesh().group("seq")
        P, T = group_size(group), x.shape[1]
        pad = (-T) % P
        xc = split(torch.nn.functional.pad(x, (0, 0, 0, pad)), 1, group)
        vc = split(torch.nn.functional.pad(valid, (0, pad), value=False), 1, group)
        gen = stream_generator(generator, SEQ_STREAM, group_rank(group), i)
        with ring_scope():
            h = self._run_layer(layer, xc, vc, None, gen, pos_emb)
        return gather(h, 1, group)[:, :T]

    def _pipe_forward(self, x, valid, bias, pos_emb, generator):
        """The pipelined stack (s2t_tpu/models/s2t_transformer.py:636-679): the batch in
        M = ``pipeline_microbatches`` or 2 S microbatches through the S stages, each
        (stage, microbatch) drawing its dropout from a generator of its own.  With a
        "pipe" group in the mesh each rank runs its block of stages
        (``parallel/pipeline.py``); without one the stages run here in order."""
        cfg = self.cfg
        S = len(self.pipe_stages)
        M = cfg.pipeline_microbatches or 2 * S
        B = x.shape[0]
        if B % M:
            raise ValueError(
                f"batch size {B} must be divisible by pipeline_microbatches "
                f"({M}); pad the batch or adjust pipeline_microbatches")
        valids = valid.chunk(M, dim=0)
        biases = [None] * M if bias is None else (
            bias.chunk(M, dim=0) if bias.shape[0] == B else [bias] * M)

        def stage(s, m, h):
            gen = stream_generator(generator, PIPE_STREAM, s, m)
            for layer in self.pipe_stages[s].layers:
                h = self._run_layer(layer, h, valids[m], biases[m], gen, pos_emb)
            return h

        mesh = get_mesh()
        P = 1 if mesh is None else mesh.size("pipe")
        if P == 1:
            return torch.cat([functools.reduce(lambda h, s_: stage(s_, m, h), range(S), xm)
                              for m, xm in enumerate(x.chunk(M, dim=0))], dim=0)
        if S % P:
            raise ValueError(f"pipeline_parallel={S} stages do not divide over the mesh's "
                             f"{P} pipe ranks")
        per = S // P

        def run(p, m, h):
            for s_ in range(p * per, (p + 1) * per):
                h = stage(s_, m, h)
            return h

        own = [q for s_ in range(mesh.index("pipe") * per, (mesh.index("pipe") + 1) * per)
               for q in self.pipe_stages[s_].parameters()]
        return pipeline_apply(run, x, M, mesh, own)

    def _compress(self, x, logits, lengths, layer):
        """CTC-blank compression (s2t_tpu/models/s2t_transformer.py:595-622): frames whose
        blank probability is >= the threshold go, the rest are left-packed in order
        by a stable sort, a row with nothing kept keeps frame 0."""
        cfg = self.cfg
        B, T, D = x.shape
        valid = lengths_to_mask(lengths, T)
        blank = torch.softmax(logits.float(), dim=-1)[..., 0]
        keep = (blank < cfg.compression_threshold) & valid
        first = torch.arange(T, device=x.device)[None, :] == 0
        keep = keep | (~keep.any(dim=1, keepdim=True) & first & valid)
        order = torch.argsort(torch.where(keep, 0, 1), dim=1, stable=True)
        x = x.gather(1, order[..., None].expand(B, T, D))
        lengths = keep.sum(dim=1).to(lengths.dtype)
        x = x * lengths_to_mask(lengths, T)[..., None].to(x.dtype)
        if self.compression_norms is not None:
            x = self.compression_norms[str(layer)](x)
        if cfg.compression_pos:
            x = x + sinusoidal_table(T, D, cfg.pad_id, x.dtype, x.device)[None]
        return x, lengths

    def forward(self, features: torch.Tensor, lengths: torch.Tensor,
                embedding: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                transcript: Optional[torch.Tensor] = None,
                transcript_lengths: Optional[torch.Tensor] = None,
                target: Optional[torch.Tensor] = None,
                target_lengths: Optional[torch.Tensor] = None,
                num_updates: Optional[int] = None,
                layer_keep: Optional[Sequence[bool]] = None) -> Dict[str, Any]:
        """``layer_keep``: LayerDrop's keep bits of this step in place of the draw
        (``draw_layer_keep``)."""
        cfg = self.cfg
        train = generator is not None
        check_features(features)
        x, lengths = self.subsample(features.to(cfg.dtype), lengths)
        # the JAX order (s2t_transformer.py:714-729): embed_norm, scale, positions, dropout
        if self.embed_norm is not None:
            x = self.embed_norm(x)
        if not cfg.encoder_no_scale_embedding:
            x = x * math.sqrt(cfg.encoder_embed_dim)
        T = x.shape[1]
        pos_emb = None
        if self.rel_pos:
            pos_emb = relative_table(T, cfg.encoder_embed_dim, x.dtype, x.device)
        elif self.abs_pos:
            # fairseq table: valid frame i gets absolute position pad+1+i
            x = x + self.positions[:T][None]
        if self.embed_linear is not None:
            x = self.embed_linear(x)
        x = dropout(x, cfg.dropout, generator)
        mixup = None
        if train and cfg.inter_mixup and cfg.inter_mixup_layer <= 0:
            x, lengths, mixup = self._mixup(x, lengths, generator, num_updates)
        valid = lengths_to_mask(lengths, T)
        # None: a pure padding mask (the fused kernel's case); a window adds a band
        window = self._window(T)

        def window_bias(valid):
            if window <= 0:
                return None
            return padding_bias(valid, x.dtype) + local_window_bias(T, window, x.dtype, x.device)

        bias = window_bias(valid)
        if self.pipe_stages is not None:
            x = self._pipe_forward(x, valid, bias, pos_emb, generator)
        history = [x] if self.dlcl is not None else None
        inter_ctc, inter_xctc, inter_axctc = [], [], []
        keep = None
        if train and cfg.encoder_layerdrop > 0:
            keep = layer_keep if layer_keep is not None else draw_layer_keep(
                len(self.layers), cfg.encoder_layerdrop, generator.initial_seed())
        for i, layer in enumerate(self.layers):
            if self.dlcl is not None:
                x = self.dlcl.combine(history, i)
            if train and cfg.inter_mixup and mixup is None and cfg.inter_mixup_layer == i + 1:
                x, lengths, mixup = self._mixup(x, lengths, generator, num_updates)
                valid = lengths_to_mask(lengths, T)
                # as in JAX (s2t_transformer.py:781), a window is not rebuilt here
                bias = None if bias is None else padding_bias(valid, x.dtype)
            if keep is None or keep[i]:
                # a dropped layer is skipped: JAX computes it and keeps x (a where), so
                # the values are the same and its parameters get zero gradients
                x = self._layer(i, layer, x, valid, bias, generator, pos_emb)
            if self.layer_out_norms is not None and str(i) in self.layer_out_norms:
                x = self.layer_out_norms[str(i)](x)
            l = i + 1
            if l in self.ctc_taps:
                h = (self.final_norm if cfg.share_inter_ctc_norm
                     else self.inter_ctc_norms[str(l)])(x)
                head = self.ctc_head if cfg.share_inter_ctc else self.inter_ctc_heads[str(l)]
                logits = head(h, embedding, generator)
                inter_ctc.append((l, logits))
                if self.pae is not None:
                    probs = None
                    if cfg.ctc_pae_ground_truth_ratio > 0 and train and transcript is not None:
                        probs = self._oracle(logits, lengths, transcript, transcript_lengths,
                                             cfg.ctc_pae_ground_truth_ratio, generator, l, 0)
                    x = self.pae(x if cfg.pae_unnorm_input else h, logits, probs=probs)
                if l in cfg.compression_layers:
                    x, lengths = self._compress(x, logits, lengths, l)
                    valid = lengths_to_mask(lengths, T)
                    bias = window_bias(valid)
            if l in self.xctc_taps:
                h = (self.final_norm if cfg.share_inter_xctc_norm
                     else self.inter_xctc_norms[str(l)])(x)
                xlogits = self.xctc_head(h, embedding, generator)
                inter_xctc.append((l, xlogits))
                if self.xpae is not None:
                    probs = None
                    if cfg.xctc_pae_ground_truth_ratio > 0 and train and target is not None:
                        probs = self._oracle(xlogits, lengths, target, target_lengths,
                                             cfg.xctc_pae_ground_truth_ratio, generator, l, 1)
                    x = self.xpae(x if cfg.pae_unnorm_input else h, xlogits, probs=probs)
            if l in self.axctc_taps:
                h = self.inter_axctc_norms[str(l)](x)
                inter_axctc.append((l, self.axctc_head(h, None, generator)))
            if history is not None:
                history.append(x)
        if self.dlcl is not None:
            x = self.dlcl.combine(history, cfg.encoder_layers)
        if self.final_norm is not None and cfg.encoder_apply_final_norm:
            x = self.final_norm(x)

        def head(module, emb=None):
            return None if module is None else module(x, emb, generator)

        return {"encoder_out": x, "encoder_lengths": lengths,
                "ctc_logits": head(self.ctc_head, embedding),
                "inter_ctc_logits": tuple(inter_ctc),
                "xctc_logits": head(self.xctc_head, embedding),
                "inter_xctc_logits": tuple(inter_xctc),
                "axctc_logits": head(self.axctc_head),
                "inter_axctc_logits": tuple(inter_axctc), "mixup": mixup}


@register_model("s2t_transformer")
class S2TTransformerModel(nn.Module):
    """Encoder-decoder speech model.  Built on CPU from ``seed`` with an
    explicit ``torch.Generator`` (so the same seed gives the same weights on
    every device), then moved to ``device``.

    For serving (the default) the parameters are stored in ``cfg.dtype``,
    frozen, in eval mode.  ``for_training=True`` keeps float32 master
    parameters that require grad and computes in ``cfg.dtype`` (the layers
    cast their weights at use, ``modules/cast.py``), as the flax modules keep
    float32 params and compute in ``dtype``."""

    @seeded_init
    def __init__(self, cfg: S2TTransformerConfig, device="cuda", seed: int = 0,
                 for_training: bool = False):
        super().__init__()
        self.check_config(cfg, for_training)
        device = resolve_device(device)
        self.cfg = cfg
        self.encoder = self.build_encoder(cfg)
        dec = self.decoder_config(cfg)
        self.decoder = TransformerDecoder(
            vocab_size=dec.vocab_size,
            embed_dim=dec.decoder_embed_dim,
            ffn_dim=dec.decoder_ffn_embed_dim,
            num_layers=dec.decoder_layers,
            num_heads=dec.decoder_attention_heads,
            activation=dec.activation_fn,
            normalize_before=dec.decoder_normalize_before,
            share_input_output_embed=dec.share_decoder_input_output_embed,
            max_positions=dec.max_target_positions,
            pad_id=dec.pad_id,
            dropout=dec.dropout,
            attention_dropout=dec.attention_dropout,
            activation_dropout=dec.activation_dropout,
            learned_pos=dec.decoder_learned_pos,
            # the cross-attention's keys and values have the encoder's width (flax's
            # k_proj / v_proj infer it, s2t_tpu/modules/attention.py:136-137)
            encoder_dim=self.encoder_out_dim(cfg),
            **self.decoder_self_attention(dec),
        )
        init_and_place(self, cfg, device, seed, for_training)

    @staticmethod
    def check_config(cfg: S2TTransformerConfig, for_training: bool) -> None:
        """Raise on what the port does not have (a subclass checks its own config)."""
        check_supported(cfg)
        if for_training:
            _check_trainable(cfg)

    @staticmethod
    def decoder_config(cfg):
        """The config whose decoder fields build the decoder (a subclass's may nest it)."""
        return cfg

    @staticmethod
    def encoder_out_dim(cfg) -> int:
        """The width of the encoder's output, which the decoder's cross-attention reads."""
        return cfg.encoder_embed_dim

    @staticmethod
    def decoder_self_attention(dec) -> Dict[str, Any]:
        """The decoder's self-attention: Shaw relative when ``max_decoder_relative_length``
        > 0 (s2t_tpu/models/s2t_transformer.py:969-971)."""
        L = getattr(dec, "max_decoder_relative_length", 0)
        return {"self_attn_type": "relative" if L > 0 else "abs", "max_relative_length": L}

    build_encoder = S2TTransformerEncoder
    # the decoder rows follow the encoder's mixup (s2t_tpu/models/s2t_transformer.py:994-1004);
    # the JAX SATE model's decoder takes the tokens as they are
    decoder_mixup = True

    @property
    def device(self) -> torch.device:
        return self.decoder.embed_tokens.weight.device

    def _ctc_embedding(self):
        cfg = self.cfg
        tied = getattr(cfg, "share_ctc_and_embed", False) or getattr(cfg, "share_xctc_and_embed",
                                                                     False)
        return self.decoder.embed_tokens.weight if tied else None

    def forward(self, features, feat_lengths, prev_tokens, train: bool = False,
                generator: Optional[torch.Generator] = None, **encoder_inputs) -> Dict[str, Any]:
        """Teacher-forced forward.  ``train=True`` applies every dropout with
        bits from ``generator`` (on the model's device); otherwise no dropout.
        ``encoder_inputs``: the encoder's keyword inputs (the oracle's
        ``transcript`` / ``target`` and their lengths, ``num_updates``); None
        values are dropped."""
        if train:
            self.check_config(self.cfg, True)
            if generator is None:
                raise ValueError("train=True needs the step's torch.Generator")
        else:
            generator = None
        kw = {k: v for k, v in encoder_inputs.items() if v is not None}
        enc = self.encoder(features, feat_lengths, self._ctc_embedding(), generator, **kw)
        enc_mask = lengths_to_mask(enc["encoder_lengths"], enc["encoder_out"].shape[1])
        mix = None
        if self.decoder_mixup and enc.get("mixup") is not None:
            # embed both source utterances' targets and blend (decoder_emb mixup)
            mu = enc["mixup"]
            mix = {"tokens2": prev_tokens[mu["index2"]], "coef": mu["coef"], "flag": mu["flag"]}
            prev_tokens = prev_tokens[mu["index1"]]
        logits = self.decoder(prev_tokens, enc["encoder_out"], enc_mask, generator, mix=mix)
        return {"decoder_logits": logits, **enc}

    # --- inference-facing methods (used by the generator) -------------------
    def encode(self, features, feat_lengths):
        return self.encoder(features, feat_lengths, self._ctc_embedding())

    def decode(self, prev_tokens, encoder_out, encoder_valid_mask):
        return self.decoder(prev_tokens, encoder_out, encoder_valid_mask)

    # the generator's cache modes this model takes, as the JAX model's signatures
    # say (s2t_tpu/models/s2t_transformer.py:1017-1027): the int8 cache and the
    # lazy reorder's ancestry map
    kv_int8_cache = True
    lazy_reorder = True

    def decode_step(self, tokens, cache, index, encoder_out, encoder_valid_mask, cross_kv=None,
                    ancestry=None):
        return self.decoder.step(tokens, cache, index, encoder_out, encoder_valid_mask,
                                 cross_kv=cross_kv, ancestry=ancestry)

    def precompute_cross(self, encoder_out):
        return self.decoder.precompute_cross(encoder_out)

    def init_cache(self, batch_size: int, max_len: int, kv_int8: bool = False):
        return self.decoder.init_cache(batch_size, max_len, kv_int8=kv_int8)


# --------------------------------------------------------------------------- #
# architecture presets (same values as the JAX package's)
# --------------------------------------------------------------------------- #


@register_model_architecture("s2t_transformer", "s2t_transformer")
def base_architecture(**kw) -> S2TTransformerConfig:
    return S2TTransformerConfig(
        encoder_embed_dim=512, encoder_ffn_embed_dim=2048,
        encoder_attention_heads=8, decoder_embed_dim=512,
        decoder_ffn_embed_dim=2048, decoder_attention_heads=8,
    ).replace(**kw)


@register_model_architecture("s2t_transformer", "s2t_transformer_s")
def s2t_transformer_s(**kw) -> S2TTransformerConfig:
    return S2TTransformerConfig(
        encoder_embed_dim=256, encoder_ffn_embed_dim=2048,
        encoder_attention_heads=4, decoder_embed_dim=256,
        decoder_ffn_embed_dim=2048, decoder_attention_heads=4, dropout=0.1,
    ).replace(**kw)


@register_model_architecture("s2t_transformer", "s2t_transformer_xs")
def s2t_transformer_xs(**kw) -> S2TTransformerConfig:
    return s2t_transformer_s(
        encoder_layers=6, decoder_layers=3, encoder_ffn_embed_dim=1024,
        decoder_ffn_embed_dim=1024, dropout=0.3,
    ).replace(**kw)


@register_model_architecture("s2t_transformer", "s2t_transformer_sp")
def s2t_transformer_sp(**kw) -> S2TTransformerConfig:
    return s2t_transformer_s(encoder_layers=16).replace(**kw)


@register_model_architecture("s2t_transformer", "s2t_transformer_m")
def s2t_transformer_m(**kw) -> S2TTransformerConfig:
    return S2TTransformerConfig(
        encoder_embed_dim=512, encoder_ffn_embed_dim=2048,
        encoder_attention_heads=8, decoder_embed_dim=512,
        decoder_ffn_embed_dim=2048, decoder_attention_heads=8, dropout=0.15,
    ).replace(**kw)


@register_model_architecture("s2t_transformer", "s2t_transformer_mp")
def s2t_transformer_mp(**kw) -> S2TTransformerConfig:
    return s2t_transformer_m(encoder_layers=16).replace(**kw)


@register_model_architecture("s2t_transformer", "s2t_transformer_l")
def s2t_transformer_l(**kw) -> S2TTransformerConfig:
    return S2TTransformerConfig(
        encoder_embed_dim=1024, encoder_ffn_embed_dim=4096,
        encoder_attention_heads=16, decoder_embed_dim=1024,
        decoder_ffn_embed_dim=4096, decoder_attention_heads=16, dropout=0.2,
    ).replace(**kw)


@register_model_architecture("s2t_transformer", "s2t_transformer_lp")
def s2t_transformer_lp(**kw) -> S2TTransformerConfig:
    return s2t_transformer_l(encoder_layers=16).replace(**kw)


@register_model_architecture("s2t_transformer", "s2t_conformer")
def s2t_conformer(**kw) -> S2TTransformerConfig:
    """Conformer-S: macaron FFN, convolution module, relative positions, swish."""
    return s2t_transformer_s(
        encoder_attention_type="rel_pos", macaron_style=True,
        use_cnn_module=True, activation_fn="swish",
    ).replace(**kw)


@register_model_architecture("s2t_transformer", "s2t_transformer_s_relative")
def s2t_transformer_s_relative(**kw) -> S2TTransformerConfig:
    """Shaw clipped relative keys in the encoder's self-attention (clip 100) and the
    decoder's (clip 20)."""
    return s2t_transformer_s(
        encoder_attention_type="relative", max_encoder_relative_length=100,
        max_decoder_relative_length=20,
    ).replace(**kw)


@register_model_architecture("s2t_transformer", "convtransformer")
def convtransformer(**kw) -> S2TTransformerConfig:
    """ESPnet-ST's Conv2d front end (k 3, stride 2, padding k // 2, ReLU, as many
    channels as the embedding) under a post-norm 512-wide 6 + 6 layer Transformer
    with no CTC."""
    embed = int(kw.get("encoder_embed_dim", 512))
    return s2t_transformer_s(
        subsampling_type="conv2d", subsampling_kernel=3,
        subsampling_padding="same", subsampling_activation="relu",
        encoder_embed_dim=512, encoder_ffn_embed_dim=2048,
        encoder_layers=6, encoder_attention_heads=8,
        decoder_embed_dim=512, decoder_ffn_embed_dim=2048,
        decoder_layers=6, decoder_attention_heads=8,
        encoder_normalize_before=False, decoder_normalize_before=False,
        attention_dropout=0.0, activation_dropout=0.0,
        use_ctc=False, subsampling_filter=embed,
    ).replace(**kw)


@register_model_architecture("s2t_transformer", "convtransformer_espnet")
def convtransformer_espnet(**kw) -> S2TTransformerConfig:
    """The 256-wide 12-layer, 4-head variant."""
    embed = int(kw.get("encoder_embed_dim", 256))
    return convtransformer(
        encoder_embed_dim=256, encoder_layers=12, encoder_attention_heads=4,
        decoder_attention_heads=4, subsampling_filter=embed,
    ).replace(**kw)


@register_model_architecture("s2t_transformer", "s2t_dynamic_transformer_s")
def s2t_dynamic_transformer_s(**kw) -> S2TTransformerConfig:
    """Dynamic convolutions in place of self-attention, kernels growing 3 .. 31."""
    return s2t_transformer_s(
        encoder_attention_type="dynamic",
        encoder_lconv_kernels=(3, 7, 15, 31, 31, 31, 31),
    ).replace(**kw)


@register_model_architecture("s2t_transformer", "s2t_light_transformer_s")
def s2t_light_transformer_s(**kw) -> S2TTransformerConfig:
    """Lightweight convolutions in place of self-attention, kernels growing 3 .. 31."""
    return s2t_transformer_s(
        encoder_attention_type="light",
        encoder_lconv_kernels=(3, 7, 15, 31, 31, 31, 31),
    ).replace(**kw)


@register_model_architecture("s2t_transformer", "s2t_transformer_s_dlcl")
def s2t_transformer_s_dlcl(**kw) -> S2TTransformerConfig:
    return s2t_transformer_s(use_enc_dlcl=True).replace(**kw)

"""wav2vec 2.0: self-supervised pretraining and its fine-tuning heads
(counterpart of s2t_tpu/models/wav2vec2.py).

``Wav2Vec2Model``: a convolutional feature extractor over the (B, N) waveform
(GELU after every conv; "default" mode: a per-channel group norm over time
after the first, "layer_norm" mode: a LayerNorm after each), the feature
gradient scaled by ``feature_grad_mult`` (``grad_multiply``), a LayerNorm and
an optional projection, span masking with a learned ``mask_emb``, a grouped
convolutional positional embedding (k = 128, 16 groups, SamePad), a stack of
``S2TEncoderLayer``s, and for pretraining a Gumbel vector quantizer over the
unmasked features at the masked positions, negatives from the same
utterance's masked positions, and cosine-similarity contrastive logits
(1 + N, B, M) with a negative equal to its positive masked to -inf.  The
port tests that equality on what the target is, the same codes in every
group (unquantized: the same frame), where JAX compares the projected
vectors bit for bit: in training the straight-through sum hard + soft - soft
rounds two rows of one code apart by an ulp or not, and a GEMM may round
equal rows apart, so JAX's mask depends on rounding (a deliberate
deviation; in eval, one-hot rows, the two agree).

The stack's self-attention takes a padding-only mask, so every layer runs the
fused attention kernel (K1f, and K1b in training), where the JAX module passes
an explicit padding bias and attends densely; the two agree.  The extractor's
convolutions and the positional conv are dense in JAX too: they stay
``conv1d``.  The group norm and the model's other norms keep flax's
statistics: float32, and the group norm's variance E[x^2] - E[x]^2 over the
whole padded time axis.

Randomness: the span starts, the negatives and the Gumbel uniforms are drawn
from the step's ``torch.Generator`` (JAX draws them from its dropout key, so
the bits differ by design); in eval the masks and negatives come from a
generator seeded 0, as JAX fixes its key.  ``draws`` hands a set over:
{"mask_uniform": (B, n_spans), "negatives": (B, M, N) int, "gumbel_uniform":
(B, M, G, V)}, the same contract in both packages' math.

``Wav2VecCtc`` (a CTC head; K3 / K4 through ``criterion: ctc``) and
``Wav2VecSeq2Seq`` (the port's Transformer decoder) fine-tune it; their
``w2v`` keeps only what ``extract_features`` calls (no quantizer or
projections), as flax creates only those parameters.  ``waveform_forward``
is the Trainer's forward adapter for these models, handing them the batch's
waveforms as JAX's tests drive them (the speech_to_text task's adapter runs
the fbank first, where the model raises, as JAX's fails).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from s2t_tpu_torch.device import resolve_device, torch_dtype
from s2t_tpu_torch.models.s2t_transformer import init_and_place, seeded_init
from s2t_tpu_torch.models.transformer_decoder import TransformerDecoder
from s2t_tpu_torch.modules.cast import Conv1d, Linear
from s2t_tpu_torch.modules.dropout import dropout
from s2t_tpu_torch.modules.layers import S2TEncoderLayer, layer_norm
from s2t_tpu_torch.registry import register_model, register_model_architecture
from s2t_tpu_torch.utils.masking import lengths_to_mask

EVAL_SEED = 0  # the eval masks and negatives, as JAX's fixed PRNGKey(0)
GN_EPS = 1e-6  # flax's GroupNorm epsilon


@dataclass(frozen=True)
class Wav2Vec2Config:
    conv_feature_layers: Tuple[Tuple[int, int, int], ...] = (
        (512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2), (512, 3, 2),
        (512, 2, 2), (512, 2, 2),
    )
    extractor_mode: str = "default"
    conv_bias: bool = False
    feature_grad_mult: float = 0.1
    encoder_embed_dim: int = 768
    encoder_ffn_embed_dim: int = 3072
    encoder_layers: int = 12
    encoder_attention_heads: int = 12
    activation_fn: str = "gelu"
    layer_norm_first: bool = False
    conv_pos: int = 128
    conv_pos_groups: int = 16
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.0
    dropout_input: float = 0.1
    dropout_features: float = 0.1
    mask_prob: float = 0.65
    mask_length: int = 10
    min_masks: int = 2
    mask_channel_prob: float = 0.0
    mask_channel_length: int = 10
    quantize_targets: bool = True
    latent_vars: int = 320
    latent_groups: int = 2
    latent_dim: int = 0
    latent_temp: Tuple[float, float, float] = (2.0, 0.5, 0.999995)
    final_dim: int = 256
    num_negatives: int = 100
    logit_temp: float = 0.1
    normalize: bool = False  # read by the dataset
    dtype_str: str = "float32"

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype_str)


def conv_out_lengths(lengths: torch.Tensor, layers) -> torch.Tensor:
    """Frames after the extractor: (L - k) // s + 1 per layer."""
    for _, k, s in layers:
        lengths = torch.div(lengths - k, s, rounding_mode="floor") + 1
    return lengths


class _GradMultiply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def grad_multiply(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Identity forward; the gradient scaled by ``scale``."""
    return _GradMultiply.apply(x, scale)


class ChannelGroupNorm(nn.Module):
    """flax ``GroupNorm(num_groups=C)`` on (B, C, T): each channel over the whole
    time axis, statistics in float32 with the variance E[x^2] - E[x]^2."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=2, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=2, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + GN_EPS) * self.weight.float()[None, :, None]
        return ((xf - mean) * mul + self.bias.float()[None, :, None]).to(x.dtype)


class ConvFeatureExtractor(nn.Module):
    """(B, N) waveform -> (B, T', C) frames (s2t_tpu/models/wav2vec2.py:112-138)."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.cfg = cfg
        convs, in_dim = [], 1
        for dim, k, s in cfg.conv_feature_layers:
            convs.append(Conv1d(in_dim, dim, k, s, bias=cfg.conv_bias))
            in_dim = dim
        self.convs = nn.ModuleList(convs)
        if cfg.extractor_mode == "layer_norm":
            self.norms = nn.ModuleList([layer_norm(d) for d, _, _ in cfg.conv_feature_layers])
            self.group_norm = None
        elif cfg.extractor_mode == "default":
            self.norms = None
            self.group_norm = ChannelGroupNorm(cfg.conv_feature_layers[0][0])
        else:
            raise ValueError(f"extractor_mode {cfg.extractor_mode!r} not in ('default', "
                             "'layer_norm')")

    def forward(self, source: torch.Tensor) -> torch.Tensor:
        if source.dim() != 2:
            raise ValueError(
                f"wav2vec 2.0 takes (B, N) waveforms, got a tensor of shape "
                f"{tuple(source.shape)}: a (B, T, C) feature batch (the speech_to_text "
                "task runs its fbank before the model, where the JAX model fails too)")
        h = source.to(self.cfg.dtype)[:, None, :]
        for i, conv in enumerate(self.convs):
            h = conv(h)
            if self.norms is not None:
                h = self.norms[i](h.transpose(1, 2)).transpose(1, 2)
            elif i == 0:
                h = self.group_norm(h)
            h = F.gelu(h)
        return h.transpose(1, 2)


class ConvPositionalEmbedding(nn.Module):
    """Grouped conv over time, padded k // 2 each side, the trailing frame
    dropped when k is even (SamePad), then GELU (wav2vec2.py:141-162)."""

    def __init__(self, dim: int, kernel: int = 128, groups: int = 16):
        super().__init__()
        self.conv = Conv1d(dim, dim, kernel, padding=kernel // 2, groups=groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(x.transpose(1, 2))[:, :, :x.shape[1]]
        return F.gelu(h).transpose(1, 2)


class GumbelVectorQuantizer(nn.Module):
    """Gumbel-softmax quantizer (wav2vec2.py:165-225): returns (quantized (B, T,
    vq_dim), prob_perplexity, code_perplexity, the codes (B, T, G)); hard
    one-hots in eval, the straight-through Gumbel sample at ``temp`` in
    training."""

    def __init__(self, input_dim: int, num_vars: int = 320, groups: int = 2,
                 vq_dim: int = 256):
        super().__init__()
        self.groups, self.num_vars, self.vq_dim = groups, num_vars, vq_dim
        self.weight_proj = Linear(input_dim, groups * num_vars)
        self.vars = nn.Parameter(torch.zeros(groups, num_vars, vq_dim // groups))

    @staticmethod
    def _perplexity(avg: torch.Tensor) -> torch.Tensor:
        return torch.exp(-(avg * torch.log(avg + 1e-7)).sum(dim=-1)).sum()

    def forward(self, x: torch.Tensor, temp: float, train: bool,
                uniform: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        B, T, _ = x.shape
        G, V = self.groups, self.num_vars
        logits = self.weight_proj(x).reshape(B, T, G, V).float()
        prob_ppl = self._perplexity(torch.softmax(logits, -1).reshape(B * T, G, V).mean(0))
        codes = logits.argmax(-1)
        hard = F.one_hot(codes, V).float()
        code_ppl = self._perplexity(hard.reshape(B * T, G, V).mean(0))
        if not train:
            q = hard
        else:
            if uniform is None:
                uniform = torch.rand(logits.shape, generator=generator, device=logits.device)
                uniform = uniform * (1.0 - 2e-6) + 1e-6
            g = -torch.log(-torch.log(uniform.to(logits.device, torch.float32)))
            y_soft = torch.softmax((logits + g) / temp, dim=-1)
            codes = y_soft.argmax(-1)
            q = F.one_hot(codes, V).float() + y_soft - y_soft.detach()
        out = torch.einsum("btgv,gvd->btgd", q, self.vars.float())
        return out.reshape(B, T, self.vq_dim).to(x.dtype), prob_ppl, code_ppl, codes


def mask_span_count(T: int, mask_prob: float, mask_length: int, min_masks: int = 2) -> int:
    return max(min_masks, int(mask_prob * T / float(mask_length)))


def sample_mask_spans(uniform: torch.Tensor, T: int, lengths: torch.Tensor, mask_length: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Positions (B, M) and mask (B, T) of ``uniform`` (B, n_spans) span starts:
    start = int(u * max(len - mask_length, 1)), spans of mask_length clipped at T
    - 1 (wav2vec2.py:228-251)."""
    B = uniform.shape[0]
    max_start = torch.clamp(lengths - mask_length, min=1)
    starts = (uniform.float() * max_start[:, None].float()).to(torch.long)
    positions = (starts[:, :, None] + torch.arange(mask_length, device=starts.device)
                 ).reshape(B, -1).clamp(max=T - 1)
    mask = torch.zeros((B, T), dtype=torch.bool, device=starts.device)
    mask.scatter_(1, positions, True)
    return positions, mask


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, T, C) at idx (B, M) -> (B, M, C)."""
    return x.gather(1, idx[..., None].expand(*idx.shape, x.shape[-1]))


@register_model("wav2vec2")
class Wav2Vec2Model(nn.Module):
    """``forward(source, lengths, train, generator, temp, features_only,
    apply_mask, draws)``: ``features_only`` -> {"x" (B, T', D), "lengths"};
    otherwise {"logits" (1+N, B, M), "features_pen", "mask_positions",
    "mask_valid", "prob_perplexity", "code_perplexity", "num_vars"}.
    ``pretraining=False`` builds only what ``extract_features`` calls (the
    fine-tuning models' ``w2v``)."""

    @seeded_init
    def __init__(self, cfg: Wav2Vec2Config, device="cuda", seed: int = 0,
                 for_training: bool = False, pretraining: bool = True, place: bool = True):
        super().__init__()
        self.cfg = cfg
        D = cfg.encoder_embed_dim
        self.embed = cfg.conv_feature_layers[-1][0]
        self.feature_extractor = ConvFeatureExtractor(cfg)
        self.layer_norm = layer_norm(self.embed)
        self.post_extract_proj = Linear(self.embed, D) if self.embed != D else None
        self.mask_emb = nn.Parameter(torch.zeros(D))
        self.pos_conv = ConvPositionalEmbedding(D, cfg.conv_pos, cfg.conv_pos_groups)
        self.encoder_norm = layer_norm(D)
        self.layers = nn.ModuleList([
            S2TEncoderLayer(D, cfg.encoder_ffn_embed_dim, cfg.encoder_attention_heads,
                            cfg.activation_fn, cfg.layer_norm_first, cfg.dropout,
                            cfg.attention_dropout, cfg.activation_dropout)
            for _ in range(cfg.encoder_layers)])
        self.pretraining = pretraining
        self.quantizer = self.project_q = self.final_proj = None
        if pretraining:
            final_dim = cfg.final_dim if cfg.final_dim > 0 else D
            if cfg.quantize_targets:
                vq_dim = cfg.latent_dim if cfg.latent_dim > 0 else final_dim
                self.quantizer = GumbelVectorQuantizer(self.embed, cfg.latent_vars,
                                                       cfg.latent_groups, vq_dim)
            self.project_q = Linear(self.embed if not cfg.quantize_targets else vq_dim,
                                    final_dim)
            self.final_proj = Linear(D, final_dim)
        if place:
            init_and_place(self, cfg, resolve_device(device), seed, for_training)

    @property
    def device(self) -> torch.device:
        return self.mask_emb.device

    def _encode(self, x, valid, generator):
        cfg = self.cfg
        x = x + self.pos_conv(x)
        if not cfg.layer_norm_first:
            x = self.encoder_norm(x)
        x = dropout(x, cfg.dropout, generator)
        for layer in self.layers:
            x = layer(x, valid, None, generator)
        if cfg.layer_norm_first:
            x = self.encoder_norm(x)
        return x

    def _mask(self, x, lengths, generator, uniform):
        cfg = self.cfg
        B, T, _ = x.shape
        if uniform is None:
            n = mask_span_count(T, cfg.mask_prob, cfg.mask_length, cfg.min_masks)
            uniform = torch.rand((B, n), generator=generator, device=x.device)
        positions, mask = sample_mask_spans(uniform.to(x.device), T, lengths, cfg.mask_length)
        x = torch.where(mask[..., None], self.mask_emb.to(x.dtype), x)
        return x, positions

    def forward(self, source: torch.Tensor, lengths: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None, temp: float = 0.5,
                features_only: bool = False, apply_mask: bool = False,
                draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, Any]:
        cfg = self.cfg
        draws = draws or {}
        if train and generator is None:
            raise ValueError("train=True needs the step's torch.Generator")
        step_gen = generator if train else None  # dropout only in training
        feats = self.feature_extractor(source)
        if cfg.feature_grad_mult != 1.0:
            feats = grad_multiply(feats, cfg.feature_grad_mult)
        out_lengths = conv_out_lengths(lengths.to(feats.device), cfg.conv_feature_layers)
        features_pen = (feats.float() ** 2).mean()
        feats = self.layer_norm(feats)
        x = self.post_extract_proj(feats) if self.post_extract_proj is not None else feats
        x = dropout(x, cfg.dropout_input, step_gen)
        unmasked = dropout(feats, cfg.dropout_features, step_gen)
        B, T, _ = x.shape
        valid = lengths_to_mask(out_lengths, T)
        # the draws: the step's generator in training, a fixed one in eval
        draw_gen = generator if train else None
        if draw_gen is None and not features_only:
            draw_gen = torch.Generator(device=x.device).manual_seed(EVAL_SEED)

        if features_only:
            if apply_mask and train:
                x, _ = self._mask(x, out_lengths, draw_gen, draws.get("mask_uniform"))
            return {"x": self._encode(x, valid, step_gen), "lengths": out_lengths}

        x, positions = self._mask(x, out_lengths, draw_gen, draws.get("mask_uniform"))
        x = self._encode(x, valid, step_gen)
        y = _gather_rows(unmasked, positions)
        prob_ppl = code_ppl = None
        ident = positions[..., None]  # what each target is: its frame, or its codes
        if self.quantizer is not None:
            y, prob_ppl, code_ppl, ident = self.quantizer(y, temp, train,
                                                          draws.get("gumbel_uniform"), draw_gen)
        y = self.project_q(y)
        M = positions.shape[1]
        neg_idx = draws.get("negatives")
        if neg_idx is None:
            neg_idx = torch.randint(0, max(M - 1, 1), (B, M, cfg.num_negatives),
                                    generator=draw_gen, device=x.device)
        neg_idx = neg_idx.to(x.device, torch.long)
        self_idx = torch.arange(M, device=x.device)[None, :, None]
        neg_idx = torch.where(neg_idx >= self_idx, neg_idx + 1, neg_idx).clamp(max=M - 1)
        N = neg_idx.shape[2]
        negs = _gather_rows(y, neg_idx.reshape(B, M * N)).reshape(B, M, N, -1)
        cx = self.final_proj(_gather_rows(x, positions)).float()
        targets = torch.cat([y[:, :, None], negs], dim=2)  # (B, M, 1 + N, C)
        tf = targets.float()
        cos = (cx[:, :, None] * tf).sum(-1) / (
            torch.linalg.vector_norm(cx, dim=-1)[:, :, None]
            * torch.linalg.vector_norm(tf, dim=-1) + 1e-8)
        logits = cos / cfg.logit_temp
        # a negative that is its positive: the same codes (the same frame unquantized)
        neg_ident = _gather_rows(ident, neg_idx.reshape(B, M * N)).reshape(B, M, N, -1)
        neg_is_pos = (neg_ident == ident[:, :, None]).all(-1)
        logits = torch.cat([logits[:, :, :1],
                            logits[:, :, 1:].masked_fill(neg_is_pos, float("-inf"))], dim=2)
        out = {"logits": logits.permute(2, 0, 1), "features_pen": features_pen,
               "mask_positions": positions, "mask_valid": valid.gather(1, positions)}
        if prob_ppl is not None:
            out.update(prob_perplexity=prob_ppl, code_perplexity=code_ppl,
                       num_vars=cfg.latent_vars * cfg.latent_groups)
        return out

    def extract_features(self, source, lengths, train: bool = False, generator=None,
                         apply_mask: bool = False, draws=None):
        out = self(source, lengths, train, generator, features_only=True, apply_mask=apply_mask,
                   draws=draws)
        return out["x"], out["lengths"]


@dataclass(frozen=True)
class Wav2VecCtcConfig(Wav2Vec2Config):
    vocab_size: int = 32
    final_dropout: float = 0.0


def _ctc_out(x, logits, lengths) -> Dict[str, Any]:
    return {"encoder_out": x, "ctc_logits": logits, "encoder_lengths": lengths,
            "inter_ctc_logits": (), "xctc_logits": None, "inter_xctc_logits": (),
            "mixup": None}


@register_model("wav2vec_ctc")
class Wav2VecCtc(nn.Module):
    """w2v features (span-masked in training) -> dropout -> CTC projection
    (wav2vec2.py:424-461).  No ``encode``: as in JAX, neither generator nor the
    validation-time CTC WER takes it."""

    @seeded_init
    def __init__(self, cfg: Wav2VecCtcConfig, device="cuda", seed: int = 0,
                 for_training: bool = False):
        super().__init__()
        self.cfg = cfg
        self.w2v = Wav2Vec2Model(cfg, pretraining=False, place=False)
        self.proj = Linear(cfg.encoder_embed_dim, cfg.vocab_size)
        init_and_place(self, cfg, resolve_device(device), seed, for_training)

    @property
    def device(self) -> torch.device:
        return self.proj.weight.device

    def forward(self, source, lengths, train: bool = False,
                generator: Optional[torch.Generator] = None, draws=None) -> Dict[str, Any]:
        x, out_lengths = self.w2v.extract_features(source, lengths, train, generator,
                                                   apply_mask=train, draws=draws)
        x = dropout(x, self.cfg.final_dropout, generator if train else None)
        return _ctc_out(x, self.proj(x), out_lengths)


@dataclass(frozen=True)
class Wav2VecSeq2SeqConfig(Wav2Vec2Config):
    vocab_size: int = 10000
    decoder_embed_dim: int = 768
    decoder_ffn_embed_dim: int = 3072
    decoder_layers: int = 6
    decoder_attention_heads: int = 4
    decoder_dropout: float = 0.1
    decoder_attention_dropout: float = 0.1
    decoder_activation_dropout: float = 0.0
    decoder_learned_pos: bool = False
    decoder_normalize_before: bool = False
    share_decoder_input_output_embed: bool = False
    max_target_positions: int = 2048
    final_dropout: float = 0.0
    pad_id: int = 1


@register_model("wav2vec_seq2seq")
class Wav2VecSeq2Seq(nn.Module):
    """w2v features -> dropout -> [projection to the decoder width] -> the
    Transformer decoder (wav2vec2.py:483-566), with the generator's surface."""

    kv_int8_cache = True

    @seeded_init
    def __init__(self, cfg: Wav2VecSeq2SeqConfig, device="cuda", seed: int = 0,
                 for_training: bool = False):
        super().__init__()
        self.cfg = cfg
        self.w2v = Wav2Vec2Model(cfg, pretraining=False, place=False)
        self.enc_proj = (Linear(cfg.encoder_embed_dim, cfg.decoder_embed_dim)
                         if cfg.encoder_embed_dim != cfg.decoder_embed_dim else None)
        self.decoder = TransformerDecoder(
            vocab_size=cfg.vocab_size, embed_dim=cfg.decoder_embed_dim,
            ffn_dim=cfg.decoder_ffn_embed_dim, num_layers=cfg.decoder_layers,
            num_heads=cfg.decoder_attention_heads,
            normalize_before=cfg.decoder_normalize_before,
            share_input_output_embed=cfg.share_decoder_input_output_embed,
            max_positions=cfg.max_target_positions, pad_id=cfg.pad_id,
            dropout=cfg.decoder_dropout, attention_dropout=cfg.decoder_attention_dropout,
            activation_dropout=cfg.decoder_activation_dropout,
            learned_pos=cfg.decoder_learned_pos)
        init_and_place(self, cfg, resolve_device(device), seed, for_training)

    @property
    def device(self) -> torch.device:
        return self.decoder.embed_tokens.weight.device

    def _encode_w2v(self, source, lengths, train, generator, draws=None):
        x, out_lengths = self.w2v.extract_features(source, lengths, train, generator,
                                                   apply_mask=train, draws=draws)
        x = dropout(x, self.cfg.final_dropout, generator if train else None)
        if self.enc_proj is not None:
            x = self.enc_proj(x)
        return x, out_lengths

    def forward(self, source, lengths, prev_tokens, train: bool = False,
                generator: Optional[torch.Generator] = None, draws=None, **unused):
        x, out_lengths = self._encode_w2v(source, lengths, train, generator, draws)
        mask = lengths_to_mask(out_lengths, x.shape[1])
        logits = self.decoder(prev_tokens, x, mask, generator if train else None)
        return {"decoder_logits": logits, **_ctc_out(x, None, out_lengths)}

    def encode(self, source, lengths):
        x, out_lengths = self._encode_w2v(source, lengths, False, None)
        return {"encoder_out": x, "encoder_lengths": out_lengths}

    def decode(self, prev_tokens, encoder_out, encoder_valid_mask):
        return self.decoder(prev_tokens, encoder_out, encoder_valid_mask)

    def decode_step(self, tokens, cache, index, encoder_out, encoder_valid_mask, cross_kv=None):
        return self.decoder.step(tokens, cache, index, encoder_out, encoder_valid_mask,
                                 cross_kv=cross_kv)

    def precompute_cross(self, encoder_out):
        return self.decoder.precompute_cross(encoder_out)

    def init_cache(self, batch_size: int, max_len: int, kv_int8: bool = False):
        return self.decoder.init_cache(batch_size, max_len, kv_int8=kv_int8)


def waveform_forward(model, batch: Dict[str, Any], train: bool = False,
                     generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
    """The Trainer's forward adapter for the wav2vec 2.0 fine-tuning models: the
    batch's (B, N) waveforms ("features" / "feat_lengths") with no fbank and, for an
    encoder-decoder, its ``prev_tokens``; ``batch["draws"]`` (optional) hands the span
    uniforms over."""
    args = (batch["features"], batch["feat_lengths"])
    if getattr(model, "decoder", None) is not None:
        args += (batch["prev_tokens"],)
    return model(*args, train=train, generator=generator, draws=batch.get("draws"))


@register_model_architecture("wav2vec2", "wav2vec2_base")
def wav2vec2_base(**kw) -> Wav2Vec2Config:
    return Wav2Vec2Config().replace(**kw)


@register_model_architecture("wav2vec_seq2seq", "wav2vec_seq2seq")
def wav2vec_seq2seq_arch(**kw) -> Wav2VecSeq2SeqConfig:
    return Wav2VecSeq2SeqConfig().replace(**kw)


@register_model_architecture("wav2vec_ctc", "wav2vec_ctc")
def wav2vec_ctc_arch(**kw) -> Wav2VecCtcConfig:
    return Wav2VecCtcConfig().replace(**kw)


@register_model_architecture("wav2vec2", "wav2vec2_large")
def wav2vec2_large(**kw) -> Wav2Vec2Config:
    return Wav2Vec2Config(
        encoder_embed_dim=1024, encoder_ffn_embed_dim=4096, encoder_layers=24,
        encoder_attention_heads=16, final_dim=768, layer_norm_first=True,
        extractor_mode="layer_norm", feature_grad_mult=1.0,
    ).replace(**kw)

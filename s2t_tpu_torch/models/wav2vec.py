"""wav2vec (v1): contrastive predictive coding over raw audio
(counterpart of s2t_tpu/models/wav2vec.py).

A convolutional feature extractor over the (B, N) waveform (valid convs, a
single-group norm over (T, C) per utterance whose statistics are masked to the
valid frames, ReLU or GELU, optional strided skips, log compression), an
optional vector quantizer of the features (``vq_type`` "gumbel": wav2vec 2.0's
``GumbelVectorQuantizer``; "kmeans": ``modules/vq.py``), a causal convolutional
aggregator (left padding by zeros or by the edge frame, skips scaled by
sqrt(``residual_scale``) with 1x1 projections where the width changes), and the
CPC head: per-step linear maps (``step_proj`` (C_in, steps, C_out),
``step_bias``), and for each frame t and step i the dot products of the
prediction with the target frame t + offset + i and its negatives, dense:
``cpc_logits`` (B, T', steps, 1 + N) with ``cpc_valid`` (B, T', steps) where
t + offset + i < frames.  ``effective_offset`` is the extractor's receptive
field over its jump when ``offset`` is -1.

Randomness: the negatives' uniforms (and the cross-utterance draws, and the
Gumbel uniforms) come from the step's ``torch.Generator``, in eval from one
seeded 0 where JAX fixes ``PRNGKey(0)``; ``draws`` hands a set over:
{"negatives": (B, T', N) uniforms, "cross_utterance": (B, T', Nx) ints and
"cross_uniform": (B, T', Nx) uniforms, "gumbel_uniform": (B, T', G, V)}, in
the math of both packages.  A negative is drawn from the row's valid frames
only, shifted past its own frame.  Everything here is dense in JAX too: the
convolutions stay ``conv1d``.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from s2t_tpu_torch.device import resolve_device, torch_dtype
from s2t_tpu_torch.models.s2t_transformer import init_and_place, seeded_init
from s2t_tpu_torch.models.wav2vec2 import EVAL_SEED, GumbelVectorQuantizer, conv_out_lengths
from s2t_tpu_torch.modules.cast import Conv1d
from s2t_tpu_torch.modules.dropout import dropout
from s2t_tpu_torch.modules.vq import KmeansVectorQuantizer
from s2t_tpu_torch.registry import register_model, register_model_architecture
from s2t_tpu_torch.utils.masking import lengths_to_mask

GN_EPS = 1e-5  # the block norm's epsilon (wav2vec.py:140)
VQ_TYPES = ("none", "gumbel", "kmeans")


@dataclass(frozen=True)
class Wav2VecConfig:
    prediction_steps: int = 12
    num_negatives: int = 10
    cross_sample_negatives: int = 0
    conv_feature_layers: Tuple[Tuple[int, int, int], ...] = (
        (512, 10, 5), (512, 8, 4), (512, 4, 2), (512, 4, 2), (512, 4, 2),
        (512, 1, 1), (512, 1, 1), (512, 1, 1),
    )
    conv_aggregator_layers: Tuple[Tuple[int, int, int], ...] = tuple(
        (512, k, 1) for k in range(2, 14))
    dropout: float = 0.0
    dropout_features: float = 0.0
    dropout_agg: float = 0.0
    no_conv_bias: bool = False
    agg_zero_pad: bool = False
    skip_connections_feat: bool = False
    skip_connections_agg: bool = True
    residual_scale: float = 0.5
    log_compression: bool = True
    balanced_classes: bool = False
    non_affine_group_norm: bool = False
    offset: int = -1
    activation: str = "relu"
    infonce: bool = False
    vq_type: str = "none"
    vq_vars: int = 320
    vq_groups: int = 2
    vq_dim: int = 0
    vq_temp: Tuple[float, float, float] = (2.0, 0.5, 0.999995)
    vq_gamma: float = 0.25
    dtype_str: str = "float32"

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype_str)

    @property
    def effective_offset(self) -> int:
        if self.offset >= 0:
            return self.offset
        # the extractor's receptive field over its jump (wav2vec.py:88-98)
        jin = rin = 0
        for _, k, stride in self.conv_feature_layers:
            if rin == 0:
                rin = k
            rin = rin + (k - 1) * jin
            jin = stride if jin == 0 else jin * stride
        return int(math.ceil(rin / jin))


def _act(name: str):
    return F.relu if name == "relu" else F.gelu


class GroupNormBlock(nn.Module):
    """One group over (T, C) per utterance in float32 (epsilon 1e-5), the statistics
    over the ``valid`` frames only and the padded tail zeroed after; ``gn_scale`` /
    ``gn_bias`` unless non-affine (wav2vec.py:102-147)."""

    def __init__(self, channels: int, affine: bool = True):
        super().__init__()
        self.gn_scale = nn.Parameter(torch.ones(channels)) if affine else None
        self.gn_bias = nn.Parameter(torch.zeros(channels)) if affine else None

    def forward(self, x: torch.Tensor, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T, C = x.shape
        xf = x.float()
        if valid is None:
            mean = xf.mean(dim=(1, 2))
            var = ((xf - mean[:, None, None]) ** 2).mean(dim=(1, 2))
        else:
            m = valid[..., None]
            n = torch.clamp(m.float().sum(dim=(1, 2)) * C, min=1.0)
            mean = torch.where(m, xf, 0.0).sum(dim=(1, 2)) / n
            var = torch.where(m, (xf - mean[:, None, None]) ** 2, 0.0).sum(dim=(1, 2)) / n
        h = (xf - mean[:, None, None]) * torch.rsqrt(var[:, None, None] + GN_EPS)
        if self.gn_scale is not None:
            h = h * self.gn_scale.float() + self.gn_bias.float()
        if valid is not None:
            h = torch.where(valid[..., None], h, 0.0)
        return h.to(x.dtype)


class ConvFeatureExtractorV1(nn.Module):
    """(B, N) waveform -> (B, T', C) features (wav2vec.py:150-190)."""

    def __init__(self, cfg: Wav2VecConfig):
        super().__init__()
        self.cfg = cfg
        convs, norms, d = [], [], 1
        for dim, k, s in cfg.conv_feature_layers:
            convs.append(Conv1d(d, dim, k, s, bias=False))
            norms.append(GroupNormBlock(dim, not cfg.non_affine_group_norm))
            d = dim
        self.convs, self.norms = nn.ModuleList(convs), nn.ModuleList(norms)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        act = _act(cfg.activation)
        h = x.to(cfg.dtype)[:, None, :]  # (B, 1, N)
        for conv, norm, (_, k, s) in zip(self.convs, self.norms, cfg.conv_feature_layers):
            prev = h
            h = conv(h)
            valid = None
            if lengths is not None:
                lengths = torch.div(lengths - k, s, rounding_mode="floor") + 1
                valid = lengths_to_mask(torch.clamp(lengths, min=0), h.shape[2])
            h = dropout(h, cfg.dropout, generator)
            h = act(norm(h.transpose(1, 2), valid)).transpose(1, 2)
            if cfg.skip_connections_feat and h.shape[1] == prev.shape[1]:
                t, rt = h.shape[2], prev.shape[2]
                h = (h + prev[:, :, ::rt // t][:, :, :t]) * math.sqrt(cfg.residual_scale)
        h = h.transpose(1, 2)
        if cfg.log_compression:
            h = torch.log(h.float().abs() + 1.0).to(h.dtype)
        return h


class ConvAggregator(nn.Module):
    """Causal conv stack over the features (wav2vec.py:193-228): each layer pads
    k - 1 frames on the left (zeros with ``agg_zero_pad``, else the first frame)."""

    def __init__(self, cfg: Wav2VecConfig):
        super().__init__()
        self.cfg = cfg
        convs, norms, rprojs = [], [], {}
        d = cfg.conv_feature_layers[-1][0]
        for i, (dim, k, s) in enumerate(cfg.conv_aggregator_layers):
            convs.append(Conv1d(d, dim, k, s, bias=not cfg.no_conv_bias))
            norms.append(GroupNormBlock(dim, not cfg.non_affine_group_norm))
            if cfg.skip_connections_agg and d != dim:
                rprojs[str(i)] = Conv1d(d, dim, 1, bias=False)
            d = dim
        self.convs, self.norms = nn.ModuleList(convs), nn.ModuleList(norms)
        self.rprojs = nn.ModuleDict(rprojs)

    def forward(self, x: torch.Tensor, valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        act = _act(cfg.activation)
        x = x.transpose(1, 2)  # (B, C, T)
        for i, (conv, norm, (dim, k, s)) in enumerate(
                zip(self.convs, self.norms, cfg.conv_aggregator_layers)):
            residual = x
            ka = k // 2
            left = ka + (ka - 1 if k % 2 == 0 else ka)
            if cfg.agg_zero_pad:
                h = F.pad(x, (left, 0))
            else:
                h = torch.cat([x[:, :, :1].expand(-1, -1, left), x], dim=2)
            h = dropout(conv(h), cfg.dropout, generator)
            h = act(norm(h.transpose(1, 2), valid)).transpose(1, 2)
            if cfg.skip_connections_agg:
                if str(i) in self.rprojs:
                    residual = self.rprojs[str(i)](residual)
                h = (h + residual) * math.sqrt(cfg.residual_scale)
            x = h
        return x.transpose(1, 2)


@register_model("wav2vec")
class Wav2VecModel(nn.Module):
    """``forward(source, lengths, train, generator, temp, draws)`` -> {"cpc_logits"
    (B, T', steps, 1 + N) f32, "cpc_valid" (B, T', steps), "infonce",
    "balanced_classes", "num_negatives", and the quantizer's "kmeans_loss" or
    "prob_perplexity", "code_perplexity", "num_vars"}."""

    @seeded_init
    def __init__(self, cfg: Wav2VecConfig, device="cuda", seed: int = 0,
                 for_training: bool = False):
        super().__init__()
        if cfg.vq_type not in VQ_TYPES:
            raise ValueError(f"vq_type {cfg.vq_type!r} not in {VQ_TYPES}")
        self.cfg = cfg
        self.feature_extractor = ConvFeatureExtractorV1(cfg)
        self.feature_aggregator = ConvAggregator(cfg)
        c_feat = cfg.conv_feature_layers[-1][0]
        vq_dim = cfg.vq_dim if cfg.vq_dim > 0 else c_feat
        self.vq = None
        if cfg.vq_type == "gumbel":
            self.vq = GumbelVectorQuantizer(c_feat, cfg.vq_vars, cfg.vq_groups, vq_dim)
        elif cfg.vq_type == "kmeans":
            self.vq = KmeansVectorQuantizer(c_feat, cfg.vq_vars, cfg.vq_groups, vq_dim,
                                            gamma=cfg.vq_gamma)
        c_in = cfg.conv_aggregator_layers[-1][0]
        self.step_proj = nn.Parameter(torch.zeros(c_in, cfg.prediction_steps, c_feat))
        self.step_bias = nn.Parameter(torch.zeros(cfg.prediction_steps, c_feat))
        init_and_place(self, cfg, resolve_device(device), seed, for_training)

    @property
    def device(self) -> torch.device:
        return self.step_proj.device

    def _negatives(self, y, frames, gen, draws):
        """(B, T, N + Nx, C) negatives: N from the row's own valid frames, Nx from
        other rows', each shifted past the frame it scores (wav2vec.py:323-357)."""
        cfg = self.cfg
        B, T, C = y.shape
        dev = y.device
        t_idx = torch.arange(T, device=dev)
        parts = []
        if cfg.num_negatives > 0:
            u = draws.get("negatives")
            if u is None:
                u = torch.rand((B, T, cfg.num_negatives), generator=gen, device=dev)
            hi = torch.clamp(frames - 1, min=1).float()
            idx = torch.floor(u.to(dev).float() * hi[:, None, None]).long()
            idx = torch.where(idx >= t_idx[None, :, None], idx + 1, idx)
            idx = torch.minimum(idx, torch.clamp(frames - 1, min=0)[:, None, None])
            parts.append(y.gather(1, idx.reshape(B, -1, 1).expand(B, -1, C)
                                  ).reshape(B, T, cfg.num_negatives, C))
        Nx = cfg.cross_sample_negatives
        if Nx > 0:
            bsel = draws.get("cross_utterance")
            if bsel is None:
                bsel = torch.randint(0, B, (B, T, Nx), generator=gen, device=dev)
            u = draws.get("cross_uniform")
            if u is None:
                u = torch.rand((B, T, Nx), generator=gen, device=dev)
            bsel = bsel.to(dev).long()
            fb = frames[bsel]
            tsel = torch.floor(u.to(dev).float() * torch.clamp(fb, min=1).float()).long()
            same = (bsel == torch.arange(B, device=dev)[:, None, None]) & \
                (tsel == t_idx[None, :, None])
            tsel = torch.minimum(torch.where(same, tsel + 1, tsel), torch.clamp(fb - 1, min=0))
            parts.append(y.reshape(B * T, C)[(bsel * T + tsel).reshape(-1)].reshape(B, T, Nx, C))
        return torch.cat(parts, dim=2) if parts else None

    def forward(self, source: torch.Tensor, lengths: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None, temp=None,
                draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, Any]:
        cfg = self.cfg
        draws = draws or {}
        if train and generator is None:
            raise ValueError("train=True needs the step's torch.Generator")
        step_gen = generator if train else None
        lengths = lengths.to(source.device)
        feats = self.feature_extractor(source, lengths, step_gen)
        extra: Dict[str, Any] = {}
        draw_gen = generator if train else torch.Generator(device=feats.device).manual_seed(
            EVAL_SEED)
        if cfg.vq_type == "gumbel":
            t = cfg.vq_temp[0] if temp is None else temp
            feats, prob_ppl, code_ppl, _ = self.vq(feats, t, train, draws.get("gumbel_uniform"),
                                                   draw_gen)
            extra = {"prob_perplexity": prob_ppl, "code_perplexity": code_ppl,
                     "num_vars": cfg.vq_vars * cfg.vq_groups}
        elif cfg.vq_type == "kmeans":
            q = self.vq(feats)
            feats = q["x"]
            extra = {k: q[k] for k in ("kmeans_loss", "code_perplexity", "num_vars")}
        # the targets are the clean (post-VQ) features; dropout feeds only the aggregator
        y = feats
        frames = conv_out_lengths(lengths, cfg.conv_feature_layers)
        B, T, C = y.shape
        agg_valid = lengths_to_mask(frames, T)
        x = dropout(feats, cfg.dropout_features, step_gen)
        x = self.feature_aggregator(x, agg_valid, step_gen)
        x = dropout(x, cfg.dropout_agg, step_gen)
        preds = torch.einsum("btc,csd->btsd", x, self.step_proj.to(x.dtype)) + \
            self.step_bias.to(x.dtype)[None, None]
        preds = dropout(preds, cfg.dropout, step_gen)
        negs = self._negatives(y, frames, draw_gen, draws)
        targets = y[:, :, None] if negs is None else torch.cat([y[:, :, None], negs], dim=2)
        t_idx = torch.arange(T, device=y.device)
        logits, valid = [], []
        for i in range(cfg.prediction_steps):
            off = cfg.effective_offset + i
            shifted = torch.roll(targets, -off, dims=1)  # rows >= T - off are masked
            logits.append(torch.einsum("btc,btnc->btn", preds[:, :, i].float(), shifted.float()))
            valid.append(t_idx[None, :] + off < frames[:, None])
        return {"cpc_logits": torch.stack(logits, dim=2), "cpc_valid": torch.stack(valid, dim=2),
                "infonce": cfg.infonce, "balanced_classes": cfg.balanced_classes,
                "num_negatives": cfg.num_negatives + cfg.cross_sample_negatives, **extra}


@register_model_architecture("wav2vec", "wav2vec")
def wav2vec_base(**kw) -> Wav2VecConfig:
    return Wav2VecConfig().replace(**kw)


@register_model_architecture("wav2vec", "wav2vec_large")
def wav2vec_large(**kw) -> Wav2VecConfig:
    return Wav2VecConfig(
        conv_aggregator_layers=tuple((512, k, 1) for k in range(2, 15)),
        skip_connections_agg=True, activation="gelu",
    ).replace(**kw)

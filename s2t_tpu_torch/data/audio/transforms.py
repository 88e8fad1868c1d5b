"""Feature transforms: CMVN and SpecAugment as batched device functions
(counterpart of s2t_tpu/data/audio/transforms.py:24-219).

Each transform takes (B, T, D) features, (B,) frame lengths and an optional
``torch.Generator`` on the features' device, and never lets padded frames
into its statistics.  Random draws come from the generator in a fixed order
(a stateful generator takes the place of the JAX key splits), so the same
seed gives the same masks; they are not the JAX package's bits.
``CompositeTransform`` hands the same generator to each transform in turn.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from s2t_tpu_torch.registry import FEATURE_TRANSFORMS, register_feature_transform
from s2t_tpu_torch.utils.masking import lengths_to_mask


@register_feature_transform("utterance_cmvn")
class UtteranceCMVN:
    """Per-utterance mean/variance normalisation over the valid frames."""

    def __init__(self, norm_means: bool = True, norm_vars: bool = True):
        self.norm_means, self.norm_vars = norm_means, norm_vars

    @classmethod
    def from_config_dict(cls, cfg: Optional[Dict] = None):
        cfg = cfg or {}
        return cls(cfg.get("norm_means", True), cfg.get("norm_vars", True))

    def __call__(self, feats: torch.Tensor, lengths: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        mask = lengths_to_mask(lengths, feats.shape[1])[..., None]  # (B, T, 1)
        n = torch.clamp(lengths[:, None, None].to(feats.dtype), min=1.0)
        mean = torch.where(mask, feats, 0.0).sum(dim=1, keepdim=True) / n
        out = feats
        if self.norm_means:
            out = out - mean
        if self.norm_vars:
            var = torch.where(mask, (feats - mean) ** 2, 0.0).sum(dim=1, keepdim=True) / n
            out = out / torch.sqrt(var + 1e-10)
        return torch.where(mask, out, 0.0)


@register_feature_transform("global_cmvn")
class GlobalCMVN:
    """Dataset-level mean/std from precomputed stats (an npz with "mean" and "std")."""

    def __init__(self, mean: np.ndarray, std: np.ndarray):
        self.mean = torch.as_tensor(np.asarray(mean, np.float32))
        self.std = torch.as_tensor(np.asarray(std, np.float32))

    @classmethod
    def from_config_dict(cls, cfg: Optional[Dict] = None):
        cfg = cfg or {}
        stats = np.load(cfg["stats_npz_path"])
        return cls(stats["mean"], stats["std"])

    def __call__(self, feats: torch.Tensor, lengths: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        mask = lengths_to_mask(lengths, feats.shape[1])[..., None]
        mean, std = self.mean.to(feats.device), self.std.to(feats.device)
        return torch.where(mask, (feats - mean) / std, 0.0)


@register_feature_transform("specaugment")
class SpecAugment:
    """SpecAugment (Park et al. 2019): time warp, then frequency and time
    masks filled with the per-utterance mean (or ``mask_value``).

    Frequency mask: f ~ U{0..F}, f0 = floor(u * max(D - f, 1)); time mask:
    t = floor(u * (min(T_mask, p * len) + 1)), t0 = floor(u * max(len - t, 1));
    the warp moves a center c = W + u * max(len - 2W, 1) by
    w = floor(U[-W, W + 1)) and resamples both segments linearly (rows
    shorter than 2W + 2 keep identity).  W = 0 (the recipe default) disables
    it.  Without a generator (evaluation) the transform is the identity."""

    def __init__(self, time_warp_w: int = 0, freq_mask_n: int = 2, freq_mask_f: int = 27,
                 time_mask_n: int = 2, time_mask_t: int = 100, time_mask_p: float = 1.0,
                 mask_value: Optional[float] = None):
        self.time_warp_w = time_warp_w
        self.freq_mask_n = freq_mask_n
        self.freq_mask_f = freq_mask_f
        self.time_mask_n = time_mask_n
        self.time_mask_t = time_mask_t
        self.time_mask_p = time_mask_p
        self.mask_value = mask_value  # None -> per-utterance mean

    @classmethod
    def from_config_dict(cls, cfg: Optional[Dict] = None):
        cfg = cfg or {}
        return cls(
            time_warp_w=cfg.get("time_warp_W", 0),
            freq_mask_n=cfg.get("freq_mask_N", 2),
            freq_mask_f=cfg.get("freq_mask_F", 27),
            time_mask_n=cfg.get("time_mask_N", 2),
            time_mask_t=cfg.get("time_mask_T", 100),
            time_mask_p=cfg.get("time_mask_p", 1.0),
            mask_value=cfg.get("mask_value", None),
        )

    def __call__(self, feats: torch.Tensor, lengths: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if generator is None:
            return feats
        B, T, D = feats.shape
        dev = feats.device

        def uniform():
            return torch.rand((B, 1), generator=generator, device=dev)

        if self.time_warp_w > 0:
            feats = self._time_warp(feats, lengths, uniform)
        valid = lengths_to_mask(lengths, T)[..., None]
        n = torch.clamp(lengths[:, None, None].to(feats.dtype), min=1.0)
        if self.mask_value is None:
            fill = torch.where(valid, feats, 0.0).sum(dim=(1, 2), keepdim=True) / (n * D)
        else:
            fill = torch.full((B, 1, 1), self.mask_value, dtype=feats.dtype, device=dev)
        keep = torch.ones((B, T, D), dtype=torch.bool, device=dev)
        d = torch.arange(D, device=dev)[None, :]
        for _ in range(self.freq_mask_n):
            f = torch.randint(0, self.freq_mask_f + 1, (B, 1), generator=generator, device=dev)
            f0 = (uniform() * torch.clamp(D - f, min=1)).to(torch.int64)
            keep &= ~((d >= f0) & (d < f0 + f))[:, None, :]
        max_t = torch.clamp((self.time_mask_p * lengths).to(torch.int64),
                            max=self.time_mask_t)[:, None]
        ts = torch.arange(T, device=dev)[None, :]
        for _ in range(self.time_mask_n):
            t = (uniform() * (max_t + 1)).to(torch.int64)
            t0 = (uniform() * torch.clamp(lengths[:, None] - t, min=1)).to(torch.int64)
            keep &= ~((ts >= t0) & (ts < t0 + t))[:, :, None]
        out = torch.where(keep, feats, fill)
        return torch.where(valid, out, feats)

    def _time_warp(self, feats, lengths, uniform):
        """Piecewise-linear time warp: [0, c] -> [0, c + w] and [c, len) ->
        [c + w, len), resampled by linear interpolation."""
        B, T, D = feats.shape
        W = self.time_warp_w
        L = lengths.to(torch.float32)[:, None]  # (B, 1)
        ok = (lengths >= 2 * W + 2)[:, None]
        c = W + uniform() * torch.clamp(L - 2 * W, min=1.0)
        w = torch.floor(-W + uniform() * (2 * W + 1.0))
        cw = c + w
        t = torch.arange(T, dtype=torch.float32, device=feats.device)[None, :]
        # inverse map: output position t reads source position src(t)
        left = t * (c / torch.clamp(cw, min=1.0))
        right = c + (t - cw) * (L - 1 - c) / torch.clamp(L - 1 - cw, min=1.0)
        src = torch.where(t <= cw, left, right)
        src = torch.where(ok, src, t)
        src = torch.minimum(torch.clamp(src, min=0.0), L - 1.0)
        lo = torch.floor(src).to(torch.int64).clamp(min=0)
        hi = torch.clamp(lo + 1, max=T - 1)
        frac = (src - lo.to(torch.float32))[..., None].to(feats.dtype)
        f_lo = torch.gather(feats, 1, lo[..., None].expand(B, T, D))
        f_hi = torch.gather(feats, 1, hi[..., None].expand(B, T, D))
        warped = f_lo * (1 - frac) + f_hi * frac
        return torch.where((t >= L)[..., None], feats, warped)  # padded tail untouched


class CompositeTransform:
    """Transforms from a data-config dict {"transforms": [names], name: {options}}."""

    def __init__(self, transforms: List):
        self.transforms = transforms

    @classmethod
    def from_config_dict(cls, names_and_cfg: Optional[Dict] = None):
        names_and_cfg = names_and_cfg or {}
        ts = []
        for name in names_and_cfg.get("transforms", []):
            t_cls = FEATURE_TRANSFORMS.get(name)
            ts.append(t_cls.from_config_dict(names_and_cfg.get(name)))
        return cls(ts)

    def __call__(self, feats, lengths, generator: Optional[torch.Generator] = None):
        for t in self.transforms:
            feats = t(feats, lengths, generator)
        return feats

"""Latency metrics and the latency-augmented label-smoothed CE for simultaneous
ST / MT (counterpart of s2t_tpu/criterions/latency.py, whole).

Expected delays come from (B, H·L, U, S) cross-attention probabilities,
delay[u] = sum_s s p(s | u) with source steps counted from 1; the metrics are
AverageProportion, AverageLagging, DifferentiableAverageLagging and VarianceDelay
over those delays, each a masked reduction.  DAL's recursion
d'_i = max(d_i, d'_{i-1} + 1/gamma) is the running maximum of d_j - j/gamma shifted
back, d'_i = cummax_{j<=i}(d_j - j/gamma) + i/gamma (``torch.cummax``), as JAX folds
it into ``lax.cummax``.

``capture_cross_attn(model)`` makes the model's decoder keep every layer's
cross-attention probabilities before dropout during one forward and
``with_cross_attn(forward_fn)`` wraps a task's forward adapter so that its output
carries them as ``cross_attn``, layer-major as ``stack_cross_attn`` concatenates
JAX's sown intermediates.  The attention is dense, as in JAX.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from s2t_tpu_torch.criterions.label_smoothed_ce import label_smoothed_nll_loss


def expected_delays_from_attention(attn: torch.Tensor, src_lens: Optional[torch.Tensor] = None,
                                   tgt_mask: Optional[torch.Tensor] = None,
                                   stay_on_last_token: bool = True
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """attn (B, HL, U, S) -> (delays (B, HL, U), src_lens (B,) float32); without
    ``stay_on_last_token`` the mass the rows lack is put on the last source step."""
    B, HL, U, S = attn.shape
    attn = attn.float()
    if not stay_on_last_token:
        resid = 1.0 - attn[..., :-1].sum(dim=-1, keepdim=True)
        attn = torch.cat([attn[..., :-1], resid], dim=-1)
    steps = torch.arange(1, S + 1, dtype=torch.float32, device=attn.device)
    delays = torch.einsum("bhus,s->bhu", attn, steps)
    if src_lens is None:
        src_lens = torch.full((B,), float(S), dtype=torch.float32, device=attn.device)
    else:
        src_lens = src_lens.float()
    if tgt_mask is not None:
        delays = torch.where(tgt_mask[:, None, :], delays, 0.0)
    return delays, src_lens


def _tgt_lens(tgt_mask: torch.Tensor) -> torch.Tensor:
    return tgt_mask.float().sum(dim=-1)


def average_proportion(delays, src_lens, tgt_mask) -> torch.Tensor:
    """AP = sum_i d_i / (|x| |y|)."""
    d = torch.where(tgt_mask, delays, 0.0)
    return d.sum(dim=-1) / (src_lens * torch.clamp(_tgt_lens(tgt_mask), min=1.0))


def average_lagging(delays, src_lens, tgt_mask) -> torch.Tensor:
    """AL = 1/tau sum_{i<=tau} d_i - (i - 1)/gamma, tau the first step whose delay
    reaches |x| (steps after it are left out, cumulatively)."""
    B, U = delays.shape
    gamma = torch.clamp(_tgt_lens(tgt_mask), min=1.0) / src_lens
    reached = (delays >= src_lens[:, None]).to(torch.int32)
    after = torch.nn.functional.pad(torch.cummax(reached, dim=1).values, (1, 0))[:, :-1].bool()
    keep = ~after & tgt_mask
    idx = torch.arange(U, dtype=torch.float32, device=delays.device)
    lagging = torch.where(keep, delays - idx[None] / gamma[:, None], 0.0)
    tau = torch.clamp(keep.float().sum(dim=-1), min=1.0)
    return lagging.sum(dim=-1) / tau


def differentiable_average_lagging(delays, src_lens, tgt_mask) -> torch.Tensor:
    """DAL through the cummax form (module docstring)."""
    B, U = delays.shape
    gamma = torch.clamp(_tgt_lens(tgt_mask), min=1.0) / src_lens
    idx = torch.arange(U, dtype=torch.float32, device=delays.device)[None]
    step = idx / gamma[:, None]
    new_delays = torch.cummax(delays - step, dim=1).values + step
    dal = torch.where(tgt_mask, new_delays - step, 0.0)
    return dal.sum(dim=-1) / torch.clamp(_tgt_lens(tgt_mask), min=1.0)


def variance_delay(delays_hl, src_lens, tgt_mask) -> torch.Tensor:
    """The delays' variance across heads (ddof 1), summed over targets / |y|."""
    if delays_hl.shape[1] == 1:
        return torch.zeros((delays_hl.shape[0],), dtype=torch.float32, device=delays_hl.device)
    var = torch.where(tgt_mask, torch.var(delays_hl, dim=1, correction=1), 0.0)
    return var.sum(dim=-1) / torch.clamp(_tgt_lens(tgt_mask), min=1.0)


_METRICS = {
    "average_proportion": average_proportion,
    "average_lagging": average_lagging,
    "differentiable_average_lagging": differentiable_average_lagging,
}


def latency_metrics(delays, src_lens, tgt_mask) -> Dict[str, torch.Tensor]:
    """Every scalar latency metric, per utterance."""
    return {k: f(delays, src_lens, tgt_mask) for k, f in _METRICS.items()}


@dataclass
class LatencyTrainingConfig:
    latency_weight_avg: float = 0.0
    latency_weight_var: float = 0.0
    latency_weight_avg_type: str = "differentiable_average_lagging"
    latency_weight_var_type: str = "variance_delay"
    mass_preservation: bool = True  # stay_on_last_token
    average_method: str = "weighted_average"  # average | weighted_average | max


def latency_training_loss(attn: torch.Tensor, src_lens: Optional[torch.Tensor],
                          tgt_mask: torch.Tensor, cfg: LatencyTrainingConfig) -> torch.Tensor:
    """The scalar avg + var penalty of (B, HL, U, S) attention
    (s2t_tpu/criterions/latency.py:126-163): the heads' delays averaged (``average``),
    softmax-weighted (``weighted_average``) or maxed (``max``) into one delay per
    target, scored by ``latency_weight_avg_type``; plus the heads' variance."""
    delays_hl, src_lens = expected_delays_from_attention(attn, src_lens, tgt_mask,
                                                         cfg.mass_preservation)
    loss = torch.zeros((), dtype=torch.float32, device=attn.device)
    if cfg.latency_weight_avg > 0:
        if cfg.average_method == "average":
            d = delays_hl.mean(dim=1)
        elif cfg.average_method == "weighted_average":
            d = (delays_hl * torch.softmax(delays_hl, dim=1)).sum(dim=1)
        elif cfg.average_method == "max":
            d = delays_hl.max(dim=1).values
        else:
            raise ValueError(f"average_method {cfg.average_method!r}")
        d = torch.where(tgt_mask, d, 0.0)
        avg = _METRICS[cfg.latency_weight_avg_type](d, src_lens, tgt_mask)
        loss = loss + cfg.latency_weight_avg * avg.sum()
    if cfg.latency_weight_var > 0:
        loss = loss + cfg.latency_weight_var * variance_delay(delays_hl, src_lens, tgt_mask).sum()
    return loss


class _Capture:
    attn: Optional[torch.Tensor] = None


@contextlib.contextmanager
def capture_cross_attn(model):
    """Inside the block the model's ``decoder`` keeps every layer's cross-attention
    probabilities of its teacher-forced passes; ``.attn`` holds the first pass's
    (B, H·L, U, S) after the block (None for a model without such a decoder)."""
    cap = _Capture()
    dec = getattr(model, "decoder", None)
    if dec is None or not hasattr(dec, "capture_cross_attn"):
        yield cap
        return
    dec.capture_cross_attn, dec.captured_cross_attn = True, None
    try:
        yield cap
    finally:
        cap.attn = dec.captured_cross_attn
        dec.capture_cross_attn, dec.captured_cross_attn = False, None


def with_cross_attn(forward_fn: Callable) -> Callable:
    """A forward adapter whose output also carries ``cross_attn``."""

    def fwd(model, batch, train: bool = False, generator=None):
        with capture_cross_attn(model) as cap:
            out = forward_fn(model, batch, train=train, generator=generator)
        if cap.attn is not None:
            out = {**out, "cross_attn": cap.attn}
        return out

    return fwd


class LatencyAugmentedLabelSmoothedCE:
    """Label-smoothed CE + ``latency_training_loss`` over ``model_out["cross_attn"]``
    with ``encoder_lengths`` as the source lengths (s2t_tpu/criterions/latency.py:183-225)."""

    @dataclass
    class Config(LatencyTrainingConfig):
        label_smoothing: float = 0.1
        pad_id: int = 1

    def __init__(self, cfg: "LatencyAugmentedLabelSmoothedCE.Config"):
        self.cfg = cfg

    def __call__(self, model_out: Dict[str, Any], batch: Dict[str, Any]):
        cfg = self.cfg
        target = batch["target"]
        loss, nll = label_smoothed_nll_loss(model_out["decoder_logits"], target,
                                            cfg.label_smoothing, cfg.pad_id)
        ntokens = (target != cfg.pad_id).float().sum()
        logs = {"nll_loss": nll}
        attn = model_out.get("cross_attn")
        if attn is not None and (cfg.latency_weight_avg > 0 or cfg.latency_weight_var > 0):
            lat = latency_training_loss(attn, model_out.get("encoder_lengths"),
                                        target != cfg.pad_id, cfg)
            loss = loss + lat
            logs["latency_loss"] = lat
        logs["loss"] = loss
        logs["ntokens"] = ntokens
        logs["nsentences"] = torch.tensor(float(target.shape[0]), device=ntokens.device)
        return loss, ntokens, logs

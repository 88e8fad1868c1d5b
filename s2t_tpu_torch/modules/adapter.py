"""PAE adapters, the CTC shrink and the ground-truth oracle (counterpart of
s2t_tpu/modules/adapter.py:31-192).

``Adapter`` re-injects CTC predictions into an encoder stream; SATE uses it
as the bridge from the acoustic to the textual encoder.  Types: ``none``
(identity), ``linear`` (Linear(d, 2d) -> ReLU -> Linear(2d, d) -> LayerNorm),
``context`` (softmax(logits / T) @ E, the CTC posterior re-embedded),
``league`` (linear + context), ``inter_league`` (x + context) and
``gated_league`` (g linear + (1 - g) context with a learned sigmoid gate).
``ctc_shrink_matrix`` is the static-shape form of the CTC-blank/repeat
collapse: a (B, T, T) pooling matrix, applied as a matmul.
``ctc_oracle_probs`` is the PAE's ground-truth curriculum: at frames drawn with
probability ``ratio`` the Viterbi alignment's one-hot replaces the CTC
posterior that ``Adapter(..., probs=...)`` re-embeds.  Its uniform draws come
from the host (``host_uniform``: a numpy generator of an explicit seed), so
the card and the CPU draw the same mask.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from s2t_tpu_torch.modules.cast import LayerNorm, Linear
from s2t_tpu_torch.ops.ctc import ctc_best_alignment

ADAPTER_TYPES = ("none", "linear", "context", "league", "inter_league", "gated_league")
_CONTEXT_TYPES = ("context", "league", "inter_league", "gated_league")
_LINEAR_TYPES = ("linear", "league", "gated_league")


def _layer_norm(dim: int) -> LayerNorm:
    return LayerNorm(dim, eps=1e-6)  # flax's epsilon


class Adapter(nn.Module):
    """``forward(x, ctc_logits, probs=None)``; ``probs`` (the oracle's) replaces
    softmax(ctc_logits / T); ``embed_adapter`` (V, D) is the re-embedding table
    of the context types; ``embed_norm`` / ``out_norm`` add a LayerNorm on the
    context (``embed_ln``) / on the output (``out_ln``)."""

    def __init__(self, dim: int, vocab_size: int, adapter_type: str = "inter_league",
                 ctc_temperature: float = 1.0, embed_norm: bool = False,
                 out_norm: bool = False):
        super().__init__()
        if adapter_type not in ADAPTER_TYPES:
            raise ValueError(f"adapter type {adapter_type!r} not supported")
        self.adapter_type = adapter_type
        self.ctc_temperature = ctc_temperature
        context = adapter_type in _CONTEXT_TYPES
        self.embed_adapter = nn.Parameter(torch.zeros(vocab_size, dim)) if context else None
        self.embed_ln = _layer_norm(dim) if context and embed_norm else None
        if adapter_type in _LINEAR_TYPES:
            self.linear_fc1 = Linear(dim, 2 * dim)
            self.linear_fc2 = Linear(2 * dim, dim)
            self.linear_norm = _layer_norm(dim)
        self.gate = Linear(2 * dim, dim) if adapter_type == "gated_league" else None
        self.out_ln = _layer_norm(dim) if out_norm and adapter_type != "none" else None

    def _linear(self, x):
        return self.linear_norm(self.linear_fc2(F.relu(self.linear_fc1(x))))

    def forward(self, x: torch.Tensor, ctc_logits: Optional[torch.Tensor] = None,
                probs: Optional[torch.Tensor] = None) -> torch.Tensor:
        t = self.adapter_type
        if t == "none":
            return x
        if self.embed_adapter is not None:
            if probs is None:
                probs = torch.softmax(ctc_logits.float() / self.ctc_temperature, dim=-1)
            context = torch.einsum("btv,vd->btd", probs.to(x.dtype),
                                   self.embed_adapter.to(x.dtype))
            if self.embed_ln is not None:
                context = self.embed_ln(context)
        if t == "linear":
            out = self._linear(x)
        elif t == "context":
            out = context
        elif t == "league":
            out = self._linear(x) + context
        elif t == "inter_league":
            out = x + context
        else:  # gated_league
            lin = self._linear(x)
            gate = torch.sigmoid(self.gate(torch.cat([lin, context], dim=-1)))
            out = gate * lin + (1.0 - gate) * context
        return out if self.out_ln is None else self.out_ln(out)


def ctc_shrink_matrix(ctc_logits: torch.Tensor, lengths: torch.Tensor, blank_id: int = 0,
                      strategy: str = "avg") -> Tuple[torch.Tensor, torch.Tensor]:
    """(W (B, T, T) in the logits' dtype, new_lengths (B,)): consecutive valid
    frames with the same CTC argmax form a segment, blank segments are dropped,
    and row s of W pools the frames of the s-th kept segment ("avg": equal
    weights; "weighted": each frame's top CTC probability, normalised;
    "softmax": a softmax of those probabilities over the segment), so W @ x
    left-packs the segments and the rows past new_lengths are zero.  A row the
    CTC head calls all blank keeps new_length 0."""
    B, T, _ = ctc_logits.shape
    pred = ctc_logits.argmax(dim=-1)
    valid = torch.arange(T, device=pred.device)[None, :] < lengths[:, None]
    prev = torch.cat([torch.full((B, 1), -1, dtype=pred.dtype, device=pred.device),
                      pred[:, :-1]], dim=1)
    keep = (pred != blank_id) & valid
    new_seg = (pred != prev) & keep
    seg_id = torch.cumsum(new_seg.to(torch.int32), dim=1) - 1
    new_lengths = new_seg.sum(dim=1, dtype=torch.int32)
    # seg_oh[b, s, t] = 1 where frame t belongs to kept segment s (dropped frames -> column T)
    target = torch.where(keep, seg_id, torch.full_like(seg_id, T)).long()
    seg_oh = F.one_hot(target, T + 1)[..., :T].transpose(1, 2).float()
    if strategy == "avg":
        W = seg_oh / seg_oh.sum(dim=2, keepdim=True).clamp_min(1.0)
    elif strategy in ("weighted", "softmax"):
        conf = torch.softmax(ctc_logits.float(), dim=-1).amax(dim=-1)  # (B, T)
        if strategy == "softmax":
            scores = torch.where(keep, conf, torch.full_like(conf, -1e30))[:, None, :].expand(
                B, T, T)
            scores = torch.where(seg_oh > 0, scores, torch.full_like(scores, -1e30))
            W = torch.where(seg_oh > 0, torch.softmax(scores, dim=2), 0.0)
        else:
            w = seg_oh * conf[:, None, :]
            W = w / w.sum(dim=2, keepdim=True).clamp_min(1e-9)
    else:
        raise ValueError(f"shrink strategy {strategy!r} not supported")
    return W.to(ctc_logits.dtype), new_lengths


def host_uniform(shape: Sequence[int], seed: Sequence[int]) -> torch.Tensor:
    """U[0, 1) draws of ``shape`` as a float32 CPU tensor, from a numpy generator
    seeded by ``seed`` (non-negative ints): the same draws on every device."""
    return torch.from_numpy(np.random.default_rng(list(seed)).random(tuple(shape),
                                                                     dtype=np.float32))


def ctc_oracle_probs(logits: torch.Tensor, lengths: torch.Tensor, tokens: torch.Tensor,
                     token_lengths: torch.Tensor, uniform: torch.Tensor, ratio: float,
                     temperature: float = 1.0, smooth: bool = False,
                     only_mistake: bool = False) -> torch.Tensor:
    """(B, T, V) float32: the CTC best alignment's one-hot (0.9 + 0.1/V and 0.1/V
    with ``smooth``) at the frames where ``uniform`` (B, T) < ``ratio``, and
    softmax(logits / temperature) elsewhere (s2t_tpu/modules/adapter.py:156-192).
    ``only_mistake`` keeps the one-hot only where the CTC argmax differs from
    the aligned token.  The alignment is taken without gradient; the posterior
    keeps its graph."""
    lp = torch.log_softmax(logits.detach().float(), dim=-1)
    aligned, _ = ctc_best_alignment(lp, tokens, lengths, token_lengths)
    V = logits.shape[-1]
    oracle = F.one_hot(aligned.long(), V).float()
    if smooth:
        oracle = torch.where(oracle == 1.0, 0.9 + 0.1 / V, 0.1 / V)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    mask = uniform.to(logits.device) < ratio
    if only_mistake:
        mask = mask & (lp.argmax(dim=-1) != aligned)
    return torch.where(mask[..., None], oracle, probs)

"""Dynamic (low-rank, beam-restricted) linear-chain CRF, Sun et al. 2019
(counterpart of s2t_tpu/modules/dynamic_crf.py).

The V x V transition matrix is E1 E2^T of rank ``rank`` (``e1`` / ``e2``, N(0, 0.02)
tables), and at every position the lattice keeps ``beam`` candidate labels.  The
NLL's lattice holds the gold label in slot 0 and the K - 1 best non-gold labels
(K = min(beam, V)), so with beam >= V it is exact; Viterbi decodes over the top-K
emissions.  Top-k ties go to the lower index (a stable sort), as ``jax.lax.top_k``.
The (B, T - 1, K, K) transition blocks come from one batched product; the forward
and Viterbi recursions step over time in Python.  Plain PyTorch: no TPU kernel
runs here.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from s2t_tpu_torch.inference.beam_search import stable_topk

NEG = -1e30
TABLE_STD = 0.02  # flax normal(0.02) of e1 / e2


class DynamicCRF(nn.Module):
    def __init__(self, vocab_size: int, rank: int = 32, beam: int = 8):
        super().__init__()
        self.beam = beam
        self.e1 = nn.Embedding(vocab_size, rank)
        self.e2 = nn.Embedding(vocab_size, rank)
        self.e1.init_std = self.e2.init_std = TABLE_STD

    def _trans(self, cand: torch.Tensor) -> torch.Tensor:
        """(B, T, K) candidates -> (B, T - 1, K, K) scores from position t's to t + 1's."""
        a = self.e1(cand[:, :-1]).float()
        b = self.e2(cand[:, 1:]).float()
        return torch.einsum("btpr,btcr->btpc", a, b)

    def nll(self, emissions: torch.Tensor, targets: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
        """Sequence NLL (B,): emissions (B, T, V), gold ``targets`` (B, T), ``mask``
        (B, T) the valid positions (a prefix); an all-pad row gives 0."""
        B, T, V = emissions.shape
        K = min(self.beam, V)
        em = emissions.float()
        targets = targets.long()
        gold_hot = torch.zeros_like(em, dtype=torch.bool).scatter_(-1, targets[..., None], True)
        top_e, top_i = stable_topk(em.masked_fill(gold_hot, NEG), K - 1)
        cand = torch.cat([targets[..., None], top_i], dim=-1)  # (B, T, K)
        e_gold = em.gather(-1, targets[..., None])[..., 0]
        e_cand = torch.cat([e_gold[..., None], top_e], dim=-1)
        # numerator: the gold path
        tr_gold = (self.e1(targets[:, :-1]).float() * self.e2(targets[:, 1:]).float()).sum(-1)
        pair_valid = (mask[:, 1:] & mask[:, :-1]).float()
        gold = (e_gold * mask.float()).sum(1) + (tr_gold * pair_valid).sum(1)
        # denominator: the forward algorithm over the candidate lattice
        tr = self._trans(cand)
        alpha = e_cand[:, 0]
        for t in range(1, T):
            new = torch.logsumexp(alpha[:, :, None] + tr[:, t - 1], dim=1) + e_cand[:, t]
            alpha = torch.where(mask[:, t][:, None], new, alpha)
        logz = torch.logsumexp(alpha, dim=-1)
        return (logz - gold) * mask.any(dim=1).float()

    def viterbi(self, emissions: torch.Tensor,
                mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The best labelling over the top-``beam`` lattice: (tokens (B, T), score (B,))."""
        B, T, V = emissions.shape
        K = min(self.beam, V)
        e_cand, cand = stable_topk(emissions.float(), K)
        tr = self._trans(cand)
        ident = torch.arange(K, device=emissions.device)[None, :]
        alpha, bps = e_cand[:, 0], []
        for t in range(1, T):
            scores = alpha[:, :, None] + tr[:, t - 1]  # (B, K prev, K cur)
            best, best_prev = scores.max(dim=1)  # ties to the first index, as jnp.argmax
            keep = mask[:, t][:, None]
            alpha = torch.where(keep, best + e_cand[:, t], alpha)
            bps.append(torch.where(keep, best_prev, ident))  # padded steps: identity
        score, idx = alpha.max(dim=-1)
        path = [idx]
        rows = torch.arange(B, device=emissions.device)
        for bp in reversed(bps):
            idx = bp[rows, idx]
            path.append(idx)
        idxs = torch.stack(path[::-1], dim=1)  # (B, T)
        return cand.gather(-1, idxs[..., None])[..., 0], score

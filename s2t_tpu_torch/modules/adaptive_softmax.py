"""Adaptive softmax and adaptive input, the clustered output and input layers
of a large-vocabulary LM (counterpart of s2t_tpu/modules/adaptive_softmax.py).

The vocabulary splits at ``cutoffs`` into a frequent head and tail clusters
whose embeddings are down-projected by ``factor`` per cluster.  Submodules keep
the flax names (``head``, ``proj{k}``, ``tail{k}``, ``embed{k}``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from s2t_tpu_torch.modules.cast import Linear


class AdaptiveSoftmax(nn.Module):
    def __init__(self, vocab_size: int, cutoffs: Sequence[int], input_dim: int = 512,
                 factor: float = 4.0):
        super().__init__()
        self.cuts = list(cutoffs) + [vocab_size]
        n_clusters = len(self.cuts) - 1
        # the head covers [0, cutoffs[0]) plus one slot per tail cluster
        self.head = Linear(input_dim, self.cuts[0] + n_clusters, bias=False)
        for k in range(n_clusters):
            dim = max(int(input_dim // (factor ** (k + 1))), 8)
            self.add_module(f"proj{k}", Linear(input_dim, dim, bias=False))
            self.add_module(f"tail{k}", Linear(dim, self.cuts[k + 1] - self.cuts[k], bias=False))

    def _tail_lp(self, x, k: int):
        tail = getattr(self, f"tail{k}")(getattr(self, f"proj{k}")(x))
        return torch.log_softmax(tail.float(), dim=-1)

    def target_logprob(self, x: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """x (..., D), targets (...) -> log p(target) (...), from the head and the
        targets' clusters only."""
        cuts = self.cuts
        head_lp = torch.log_softmax(self.head(x).float(), dim=-1)
        cluster = torch.zeros_like(targets)
        for k in range(len(cuts) - 1):
            cluster = torch.where(targets >= cuts[k], k + 1, cluster)
        head_idx = torch.where(cluster == 0, targets.clamp(max=cuts[0] - 1),
                               cuts[0] + (cluster - 1).clamp(min=0))
        lp = head_lp.gather(-1, head_idx[..., None])[..., 0]
        for k in range(len(cuts) - 1):
            idx = (targets - cuts[k]).clamp(0, cuts[k + 1] - cuts[k] - 1)
            t = self._tail_lp(x, k).gather(-1, idx[..., None])[..., 0]
            lp = lp + torch.where(cluster == k + 1, t, 0.0)
        return lp

    def log_probs(self, x: torch.Tensor) -> torch.Tensor:
        """Full-vocabulary log-probs (..., V)."""
        cuts = self.cuts
        head_lp = torch.log_softmax(self.head(x).float(), dim=-1)
        parts = [head_lp[..., :cuts[0]]]
        for k in range(len(cuts) - 1):
            parts.append(head_lp[..., cuts[0] + k:cuts[0] + k + 1] + self._tail_lp(x, k))
        return torch.cat(parts, dim=-1)


class AdaptiveInput(nn.Module):
    """Adaptive input embeddings: cluster k embeds at ``embed_dim / factor**k``
    and projects up to ``embed_dim``.  A decoder's token embedding (no tied output)."""

    def __init__(self, vocab_size: int, cutoffs: Sequence[int], embed_dim: int = 512,
                 factor: float = 4.0):
        super().__init__()
        self.cuts = [0] + list(cutoffs) + [vocab_size]
        for k in range(len(self.cuts) - 1):
            dim = max(int(embed_dim // (factor ** k)), 8)
            self.add_module(f"embed{k}", nn.Embedding(self.cuts[k + 1] - self.cuts[k], dim))
            self.add_module(f"proj{k}", Linear(dim, embed_dim, bias=False))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cuts = self.cuts
        out = None
        for k in range(len(cuts) - 1):
            idx = (tokens - cuts[k]).clamp(0, cuts[k + 1] - cuts[k] - 1)
            e = getattr(self, f"proj{k}")(getattr(self, f"embed{k}")(idx))
            e = torch.where(((tokens >= cuts[k]) & (tokens < cuts[k + 1]))[..., None], e, 0.0)
            out = e if out is None else out + e
        return out

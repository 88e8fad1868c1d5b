"""DLCL, the dynamic linear combination of layers (counterpart of s2t_tpu/modules/dlcl.py).

Every encoder layer reads a learned weighted sum of the outputs before it (the
embedded input first): row ``idx`` of an (L + 1) x (L + 1) lower-triangular
matrix, initialised to the running average, weights h_0 .. h_idx, each through a
LayerNorm of its own (``norm{j}``).
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from s2t_tpu_torch.modules.cast import LN_EPS, LayerNorm


class DLCL(nn.Module):
    def __init__(self, num_layers: int, dim: int):
        """``num_layers``: the encoder's layer count; the combination points are its
        layers' inputs and the encoder's output."""
        super().__init__()
        n = num_layers + 1
        self.weights = nn.Parameter(
            torch.ones(n, n).tril() / torch.arange(1, n + 1, dtype=torch.float32)[:, None])
        self.norms = nn.ModuleList([LayerNorm(dim, eps=LN_EPS) for _ in range(n)])

    def combine(self, history: List[torch.Tensor], idx: int) -> torch.Tensor:
        """history: the (B, T, D) outputs h_0 .. h_idx; returns the input of layer idx + 1."""
        w = self.weights[idx, :len(history)].to(history[0].dtype)
        out = torch.zeros_like(history[0])
        for j, h in enumerate(history):
            out = out + w[j] * self.norms[j](h)
        return out

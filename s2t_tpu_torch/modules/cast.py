"""Layers whose parameters may be stored wider than the activations they see.

A model built for training keeps float32 master parameters and computes in
``cfg.dtype`` (the flax modules keep float32 params and compute in ``dtype``):
``Linear`` and ``Conv1d`` cast their weights to the input's dtype at use, and
``LayerNorm`` normalises in float32 with float32 scale and bias and returns
the input's dtype.  A model built for serving stores its parameters in
``cfg.dtype`` already, and each layer then runs exactly as its torch.nn base.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _as(p, dtype):
    return None if p is None else p.to(dtype)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), _as(self.bias, x.dtype))


class Conv1d(nn.Conv1d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), _as(self.bias, x.dtype))


class LayerNorm(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight.dtype == x.dtype:
            return super().forward(x)
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)

"""CTC projection head (counterpart of s2t_tpu/modules/ctc_head.py:17-57, logits path).

Dense to the CTC vocabulary, or ``x @ E^T`` when the projection is tied to a
token embedding (``share_ctc_and_embed``).  No norm (the s2t_transformer
heads have none) and no dropout (the port serves only).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class CTCHead(nn.Module):
    def __init__(self, dim: int, vocab_size: int, tied: bool = False):
        super().__init__()
        self.proj = None if tied else nn.Linear(dim, vocab_size)

    def forward(self, x: torch.Tensor, embedding: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.proj is None:
            if embedding is None:
                raise ValueError("a tied CTC head needs the embedding table")
            return torch.einsum("btd,vd->btv", x, embedding.to(x.dtype))
        return self.proj(x)

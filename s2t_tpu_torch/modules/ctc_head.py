"""CTC projection head (counterpart of s2t_tpu/modules/ctc_head.py:17-57, logits path).

Dropout on the head input (:38), then a dense layer to the CTC vocabulary, or
``x @ E^T`` when the projection is tied to a token embedding
(``share_ctc_and_embed``).  No norm (the s2t_transformer heads have none).
``return_fused`` is not ported: the loss gathers its emissions from the
logits (``ops/ctc.py``), which is the same math as the JAX head-input gather.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from s2t_tpu_torch.modules.cast import Linear
from s2t_tpu_torch.modules.dropout import dropout


class CTCHead(nn.Module):
    def __init__(self, dim: int, vocab_size: int, tied: bool = False, dropout: float = 0.0):
        super().__init__()
        self.proj = None if tied else Linear(dim, vocab_size)
        self.dropout = dropout

    def forward(self, x: torch.Tensor, embedding: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = dropout(x, self.dropout, generator)
        if self.proj is None:
            if embedding is None:
                raise ValueError("a tied CTC head needs the embedding table")
            return torch.einsum("btd,vd->btv", x, embedding.to(x.dtype))
        return self.proj(x)

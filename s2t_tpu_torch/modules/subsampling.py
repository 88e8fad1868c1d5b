"""Conv1d subsampling front-end (counterpart of s2t_tpu/modules/subsampling.py:23-97).

A stack of strided 1-D convs with GLU (default), halving T per layer; the
padded tail is re-zeroed before every conv so valid outputs do not depend on
bucket padding.  Length recurrence per layer: L' = (L - 1) // stride + 1.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from s2t_tpu_torch.modules.cast import Conv1d
from s2t_tpu_torch.utils.masking import lengths_to_mask


def get_activation(name: str):
    if name == "relu":
        return F.relu
    if name == "gelu":
        # exact (erf) form
        return partial(F.gelu, approximate="none")
    if name in ("gelu_tanh", "gelu_accurate"):
        return partial(F.gelu, approximate="tanh")
    if name == "swish":
        return F.silu
    if name in ("none", None):
        return lambda x: x
    raise ValueError(f"activation {name!r} not supported")


class Conv1dSubsampling(nn.Module):
    """Channel plan: intermediate layers output ``filters``, the last outputs
    ``out_dim``; with GLU each conv emits 2x channels which the gate halves
    (``a * sigmoid(b)``, ``a`` the first half)."""

    def __init__(self, in_dim: int, num_layers: int = 2, filters: int = 1024,
                 out_dim: int = 512, kernel_size: int = 5, stride: int = 2,
                 activation: str = "glu"):
        super().__init__()
        self.stride = stride
        self.glu = activation == "glu"
        self.act = None if self.glu else get_activation(activation)
        convs = []
        for i in range(num_layers):
            ch = out_dim if i == num_layers - 1 else filters
            convs.append(Conv1d(
                in_dim, ch * 2 if self.glu else ch, kernel_size, stride,
                padding=(kernel_size - 1) // 2,
            ))
            in_dim = ch
        self.convs = nn.ModuleList(convs)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        # x: (B, T, D_in); lengths: (B,)
        for conv in self.convs:
            x = x.masked_fill(~lengths_to_mask(lengths, x.shape[1])[..., None], 0.0)
            x = conv(x.transpose(1, 2)).transpose(1, 2)
            if self.glu:
                a, b = x.chunk(2, dim=-1)
                x = a * torch.sigmoid(b)
            else:
                x = self.act(x)
            lengths = (lengths - 1) // self.stride + 1
        x = x.masked_fill(~lengths_to_mask(lengths, x.shape[1])[..., None], 0.0)
        return x, lengths

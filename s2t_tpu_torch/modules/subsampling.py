"""Subsampling front-ends (counterpart of s2t_tpu/modules/subsampling.py:23-155).

``Conv1dSubsampling``: a stack of strided 1-D convs with GLU (default),
halving T per layer; the padded tail is re-zeroed before every conv (unless the
reference's pad semantics are asked for) so valid outputs do not depend on
bucket padding.  Length recurrence per layer:
L' = (L - 1) // stride + 1.

``Conv2dSubsampling``: strided 2-D convs over (time, frequency), ESPnet style,
then a linear map of the flattened (frequency, channel) plane.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from s2t_tpu_torch.modules.cast import LN_EPS, Conv1d, Conv2d, LayerNorm, Linear
from s2t_tpu_torch.utils.masking import lengths_to_mask


def check_features(features: torch.Tensor) -> None:
    """An encoder with a subsampler takes (B, T, C) features; the (B, N)
    waveforms of a ``use_audio_input`` split fed to it as they are (the
    generators' and validation's batches) raise here, as JAX's conv fails."""
    if features.dim() != 3:
        raise ValueError(
            f"this encoder takes (B, T, C) features, got a tensor of shape "
            f"{tuple(features.shape)}: the (B, N) waveforms of a use_audio_input split go to "
            "the encoder without an fbank when decoding, which a wav2vec 2.0 front end reads")


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
    (``a * sigmoid(b)``, ``a`` the first half).  ``norm`` "layer": a LayerNorm
    (``norms.{i}``) over each conv's output before the gate; any other value is
    inert, as in JAX (s2t_tpu/modules/subsampling.py:86-87).
    ``mask_between_layers`` False: the padded tail is zeroed only before the first
    conv, so valid frames at a length boundary read what the conv left there (the
    torch reference's semantics)."""

    def __init__(self, in_dim: int, num_layers: int = 2, filters: int = 1024,
                 out_dim: int = 512, kernel_size: int = 5, stride: int = 2,
                 activation: str = "glu", norm: str = "none", mask_between_layers: bool = True):
        super().__init__()
        self.stride = stride
        self.glu = activation == "glu"
        self.act = None if self.glu else get_activation(activation)
        self.mask_between_layers = mask_between_layers
        convs, widths = [], []
        for i in range(num_layers):
            ch = out_dim if i == num_layers - 1 else filters
            widths.append(ch * 2 if self.glu else ch)
            convs.append(Conv1d(in_dim, widths[-1], kernel_size, stride,
                                padding=(kernel_size - 1) // 2))
            in_dim = ch
        self.convs = nn.ModuleList(convs)
        self.norms = (nn.ModuleList(LayerNorm(w, eps=LN_EPS) for w in widths)
                      if norm == "layer" else None)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        # x: (B, T, D_in); lengths: (B,)
        for i, conv in enumerate(self.convs):
            if i == 0 or self.mask_between_layers:
                x = x.masked_fill(~lengths_to_mask(lengths, x.shape[1])[..., None], 0.0)
            x = conv(x.transpose(1, 2)).transpose(1, 2)
            if self.norms is not None:
                x = self.norms[i](x)
            if self.glu:
                a, b = x.chunk(2, dim=-1)
                x = a * torch.sigmoid(b)
            else:
                x = self.act(x)
            lengths = (lengths - 1) // self.stride + 1
        x = x.masked_fill(~lengths_to_mask(lengths, x.shape[1])[..., None], 0.0)
        return x, lengths


class Conv2dSubsampling(nn.Module):
    """2-D conv subsampling (s2t_tpu/modules/subsampling.py:99-155): ``num_layers``
    convs of ``kernel_size`` x ``kernel_size`` at stride ``stride`` on both axes,
    ``padding`` "valid" (ESPnet) or "same" (k // 2 on both sides), each followed
    by GLU (the gate halves 2 ``filters`` channels) or another activation; then
    the (T', F', C) plane flattened with C fastest, as the flax NHWC layout
    flattens it, and a linear map to ``out_dim``.  ``mask_between``: re-zero the
    padded frames before every conv (the JAX default); False zeroes them only
    before the first (the torch reference's semantics).  The length and the
    frequency axis shrink by (L + 2 pad - k) // stride + 1 a layer.  The JAX
    module has no norm: ``subsampling_norm`` does not reach it."""

    def __init__(self, in_dim: int = 80, num_layers: int = 2, filters: int = 176,
                 out_dim: int = 512, kernel_size: int = 5, stride: int = 2,
                 activation: str = "glu", padding: str = "valid", mask_between: bool = True):
        super().__init__()
        if padding not in ("valid", "same"):
            raise ValueError(f"conv2d padding {padding!r} not in ('valid', 'same')")
        self.kernel_size, self.stride = kernel_size, stride
        self.pad = kernel_size // 2 if padding == "same" else 0
        self.mask_between = mask_between
        self.glu = activation == "glu"
        self.act = None if self.glu else get_activation(activation)
        convs, ch, freq = [], 1, in_dim
        for _ in range(num_layers):
            convs.append(Conv2d(ch, filters * 2 if self.glu else filters, kernel_size, stride,
                                padding=self.pad))
            ch = filters
            freq = (freq + 2 * self.pad - kernel_size) // stride + 1
        self.convs = nn.ModuleList(convs)
        self.out = Linear(freq * filters, out_dim)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        # x: (B, T, F) -> (B, 1, T, F), NCHW with H = time and W = frequency
        h = x[:, None]
        for i, conv in enumerate(self.convs):
            if self.mask_between or i == 0:
                h = h.masked_fill(~lengths_to_mask(lengths, h.shape[2])[:, None, :, None], 0.0)
            h = conv(h)
            if self.glu:
                a, b = h.chunk(2, dim=1)
                h = a * torch.sigmoid(b)
            else:
                h = self.act(h)
            lengths = (lengths + 2 * self.pad - self.kernel_size) // self.stride + 1
        B, C, T, F_ = h.shape
        out = self.out(h.permute(0, 2, 3, 1).reshape(B, T, F_ * C))
        return out.masked_fill(~lengths_to_mask(lengths, T)[..., None], 0.0), lengths

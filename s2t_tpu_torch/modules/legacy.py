"""Legacy speech / text modules (counterpart of s2t_tpu/modules/legacy.py:24-202).

``VGGBlock``: conv3x3 (+ LayerNorm over channels) + ReLU layers and a ceil-mode
max-pool over NHWC (time, freq) input; ``LocationAttention``: additive attention
whose score adds a convolution of the previous attention rows (Chorowski et al.
2015); ``Highway`` layers; ``CharacterTokenEmbedder``: word vectors from character
CNNs, highway layers and a projection, with learned vectors for the special rows.

The modules take the JAX modules' inputs and layouts (NHWC features, (B, U, L) char
ids) and hold their parameters under the names ``interop/from_flax`` maps:
``conv{i}`` / ``norm{i}`` -> ``convs.{i}`` / ``norms.{i}``, ``layer{i}`` ->
``layers.{i}``; ``char_embeddings``, ``conv_w{width}``, ``projection`` and the bare
``symbol_embeddings`` keep theirs.  LayerNorms use flax's epsilon.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from s2t_tpu_torch.modules.layers import layer_norm as _layer_norm

NEG = -1e9


class VGGBlock(nn.Module):
    """(B, T, F, C_in) -> (B, ceil(T/p), ceil(F/p), C_out)."""

    def __init__(self, in_channels: int, out_channels: int, conv_kernel_size: int = 3,
                 pooling_kernel_size: int = 2, num_conv_layers: int = 2, input_dim: int = 80,
                 layer_norm: bool = False):
        super().__init__()
        k = conv_kernel_size
        self.pooling_kernel_size = pooling_kernel_size
        self.input_dim = input_dim
        self.out_channels = out_channels
        self.convs = nn.ModuleList([
            nn.Conv2d(in_channels if i == 0 else out_channels, out_channels, k, padding=k // 2)
            for i in range(num_conv_layers)])
        self.norms = (nn.ModuleList([_layer_norm(out_channels) for _ in range(num_conv_layers)])
                      if layer_norm else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, conv in enumerate(self.convs):
            x = conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            if self.norms is not None:
                x = self.norms[i](x)
            x = torch.relu(x)
        p = self.pooling_kernel_size
        if p and p > 1:
            # ceil mode: edge windows padded with -inf
            T, Fq = x.shape[1], x.shape[2]
            x = F.pad(x, (0, 0, 0, (-Fq) % p, 0, (-T) % p), value=-math.inf)
            x = F.max_pool2d(x.permute(0, 3, 1, 2), p, p).permute(0, 2, 3, 1)
        return x

    @property
    def output_freq_dim(self) -> int:
        p = self.pooling_kernel_size
        return -(-self.input_dim // p) if p and p > 1 else self.input_dim

    @property
    def total_output_dim(self) -> int:
        return self.output_freq_dim * self.out_channels


class LocationAttention(nn.Module):
    """(context (B, D_enc), weights (B, T)) from the encoder output, its valid mask,
    the decoder state (None at the first step) and the (B, K, T) previous attention."""

    def __init__(self, attn_dim: int, encoder_dim: int, decoder_dim: int,
                 attn_state_kernel_size: int = 1, conv_dim: int = 10,
                 conv_kernel_size: int = 100, scaling: float = 2.0):
        super().__init__()
        self.decoder_dim = decoder_dim
        self.scaling = scaling
        self.proj_enc = nn.Linear(encoder_dim, attn_dim)
        self.proj_dec = nn.Linear(decoder_dim, attn_dim, bias=False)
        self.proj_attn = nn.Linear(conv_dim, attn_dim, bias=False)
        self.conv = nn.Conv1d(attn_state_kernel_size, conv_dim, 2 * conv_kernel_size + 1,
                              padding=conv_kernel_size, bias=False)
        self.proj_out = nn.Linear(attn_dim, 1)

    def project_encoder(self, encoder_out: torch.Tensor) -> torch.Tensor:
        """The cacheable encoder projection (the caller holds it across steps)."""
        return self.proj_enc(encoder_out)

    def forward(self, encoder_out: torch.Tensor, valid_mask: torch.Tensor,
                decoder_h: Optional[torch.Tensor], attn_state: torch.Tensor,
                proj_enc_out: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        B = encoder_out.shape[0]
        if proj_enc_out is None:
            proj_enc_out = self.project_encoder(encoder_out)
        h = self.proj_attn(self.conv(attn_state).transpose(1, 2))
        if decoder_h is None:
            decoder_h = encoder_out.new_zeros((B, self.decoder_dim))
        dec = self.proj_dec(decoder_h)[:, None]
        score = self.proj_out(torch.tanh(h + proj_enc_out + dec))[..., 0]
        score = torch.where(valid_mask, score, NEG)
        w = torch.softmax(self.scaling * score.float(), dim=1)
        c = torch.einsum("btd,bt->bd", encoder_out, w.to(encoder_out.dtype))
        return c, w


class Highway(nn.Module):
    def __init__(self, dim: int, num_layers: int = 2):
        super().__init__()
        self.layers = nn.ModuleList([nn.Linear(dim, 2 * dim) for _ in range(num_layers)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            h, gate = layer(x).chunk(2, dim=-1)
            gate = torch.sigmoid(gate)
            x = gate * x + (1 - gate) * torch.relu(h)
        return x


class CharacterTokenEmbedder(nn.Module):
    """(B, U, L) char ids (0 pad, bytes + 1) -> (B, U, word_embed_dim); a row whose
    only nonzero char is 1 (eos) or 2 (unk) takes its learned symbol vector."""

    def __init__(self, word_embed_dim: int, char_embed_dim: int = 16,
                 filters: Sequence[Tuple[int, int]] = ((1, 64), (2, 128), (3, 192), (4, 256)),
                 highway_layers: int = 2):
        super().__init__()
        self.char_embed_dim = char_embed_dim
        self.widths = [w for w, _ in filters]
        self.char_embeddings = nn.Embedding(257, char_embed_dim)
        for width, channels in filters:
            setattr(self, f"conv_w{width}", nn.Conv1d(char_embed_dim, channels, width))
        total = sum(c for _, c in filters)
        self.highway = Highway(total, highway_layers) if highway_layers > 0 else None
        self.projection = nn.Linear(total, word_embed_dim)
        self.symbol_embeddings = nn.Parameter(torch.randn(2, word_embed_dim)
                                              * word_embed_dim ** -0.5)

    def forward(self, chars: torch.Tensor) -> torch.Tensor:
        B, U, L = chars.shape
        x = self.char_embeddings(chars.long()).reshape(B * U, L, self.char_embed_dim)
        x = x.transpose(1, 2)
        h = torch.cat([torch.relu(getattr(self, f"conv_w{w}")(x)).max(dim=-1).values
                       for w in self.widths], dim=-1)
        if self.highway is not None:
            h = self.highway(h)
        out = self.projection(h).reshape(B, U, -1)
        only_first = chars[..., 1:].sum(dim=-1) == 0
        sym = self.symbol_embeddings.to(out.dtype)
        out = torch.where(((chars[..., 0] == 1) & only_first)[..., None], sym[0], out)
        return torch.where(((chars[..., 0] == 2) & only_first)[..., None], sym[1], out)

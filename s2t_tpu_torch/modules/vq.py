"""K-means vector quantizer (counterpart of s2t_tpu/modules/vq.py), wav2vec's
``vq_type: kmeans``.

A grouped 1x1 projection without bias, a float32 group norm over (T, C / G) per
group (flax's ``GroupNorm``: E[x^2] - E[x]^2 clipped at 0, epsilon 1e-6), the
nearest codeword of each group by squared distance, a straight-through output
(the codewords forward, the gradient to the normed projection), and the loss
mean((zq - sg(ze))^2) + gamma mean((ze - sg(zq))^2).  The Gumbel quantizer
lives with wav2vec 2.0 (``models/wav2vec2.GumbelVectorQuantizer``).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from s2t_tpu_torch.modules.cast import Conv1d

GN_EPS = 1e-6  # flax's GroupNorm epsilon


class KmeansVectorQuantizer(nn.Module):
    def __init__(self, input_dim: int, num_vars: int = 320, groups: int = 2, vq_dim: int = 512,
                 combine_groups: bool = False, gamma: float = 0.25):
        super().__init__()
        if vq_dim % groups:
            raise ValueError(f"vq_dim {vq_dim} is not a multiple of groups {groups}")
        self.num_vars, self.groups, self.vq_dim, self.gamma = num_vars, groups, vq_dim, gamma
        self.var_dim = vq_dim // groups
        self.proj = Conv1d(input_dim, input_dim, 1, groups=groups, bias=False)
        self.norm = nn.GroupNorm(groups, input_dim)  # its weight / bias; the math is below
        self.codebook = nn.Parameter(torch.zeros(num_vars, 1 if combine_groups else groups,
                                                 self.var_dim))

    def _group_norm(self, x: torch.Tensor) -> torch.Tensor:
        B, T, C = x.shape
        G = self.groups
        xg = x.float().reshape(B, T, G, C // G)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = torch.clamp((xg * xg).mean(dim=(1, 3), keepdim=True) - mean * mean, min=0.0)
        y = ((xg - mean) * torch.rsqrt(var + GN_EPS)).reshape(B, T, C)
        return y * self.norm.weight.float() + self.norm.bias.float()

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x (B, T, C) -> {"x": quantized (B, T, vq_dim) in x's dtype, "targets" (B, T, G)
        codeword indices, "code_perplexity", "num_vars", "kmeans_loss"}."""
        B, T, C = x.shape
        G, V = self.groups, self.num_vars
        ze = self._group_norm(self.proj(x.transpose(1, 2)).transpose(1, 2))
        ze_g = ze.reshape(B, T, G, self.var_dim)
        emb = self.codebook.float().expand(V, G, self.var_dim)
        d = ((ze_g[:, :, :, None] - emb.transpose(0, 1)[None, None]) ** 2).sum(dim=-1)
        idx = d.argmin(dim=-1)  # (B, T, G)
        one_hot = F.one_hot(idx, V).float()
        zq = torch.einsum("btgv,vgd->btgd", one_hot, emb)
        out = zq.detach() + (ze_g - ze_g.detach())
        hard = one_hot.reshape(B * T, G, V).mean(dim=0)
        code_ppl = torch.exp(-(hard * torch.log(hard + 1e-7)).sum(dim=-1)).sum()
        latent = ((zq - ze_g.detach()) ** 2).mean()
        commit = ((ze_g - zq.detach()) ** 2).mean()
        return {"x": out.reshape(B, T, self.vq_dim).to(x.dtype), "targets": idx,
                "code_perplexity": code_ppl, "num_vars": V,
                "kmeans_loss": latent + self.gamma * commit}

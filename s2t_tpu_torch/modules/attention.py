"""Multi-head attention with an explicit incremental KV cache, and the
Conformer's relative-position attention (counterpart of
s2t_tpu/modules/attention.py: "abs" attention and ``RelPositionMultiHeadAttention``).

Encoder self-attention with a pure padding mask goes to the fused kernel
(``ops/attention_cuda.py``) under the condition of the JAX module
(attention.py:264-269); there is no sequence-length gate.  It gets the
attention-dropout rate and a seed drawn from the step's generator
(attention.py:286-289); the dense path drops its probabilities with
``modules/dropout.py`` (attention.py:468).  Everything else is plain PyTorch,
as the JAX package leaves it to XLA.

Incremental decoding: ``cache`` = {"k": (N, L, H, Dh), "v": ...} is updated
IN PLACE at ``cache_index`` (the JAX module returns a new cache), and the
step attends over the written prefix ``[:cache_index + 1]`` only, which
equals the JAX module's attention over all L slots with a -1e9 step mask.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from s2t_tpu_torch.modules.cast import Linear
from s2t_tpu_torch.modules.dropout import dropout as drop
from s2t_tpu_torch.ops.attention_cuda import fused_attention

NEG = -1e9


def padding_bias(valid_mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(B, Tk) valid-mask -> (B, 1, 1, Tk) additive attention bias."""
    return torch.where(valid_mask[:, None, None, :], 0.0, NEG).to(dtype)


def causal_bias(T: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(1, 1, T, T) additive causal mask."""
    mask = torch.ones((T, T), dtype=torch.bool, device=device).tril()
    return torch.where(mask, 0.0, NEG).to(dtype)[None, None]


def dot_attention_weights(q, k, bias, dtype):
    """q: (B, Tq, H, Dh), k: (B, Tk, H, Dh), bias: (B, 1|H, Tq, Tk) additive.
    The softmax runs in f32."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if bias is not None:
        scores = scores + bias
    return torch.softmax(scores.float(), dim=-1).to(dtype)


def kernel_seed(generator: torch.Generator) -> torch.Tensor:
    """A (1,) int64 dropout seed for the fused kernel, drawn on the generator's
    device (no host sync)."""
    return torch.randint(0, 2 ** 62, (1,), generator=generator, device=generator.device)


class MultiHeadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of num_heads {num_heads}")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.q_proj = Linear(embed_dim, embed_dim)
        self.k_proj = Linear(embed_dim, embed_dim)
        self.v_proj = Linear(embed_dim, embed_dim)
        self.out_proj = Linear(embed_dim, embed_dim)

    def _split(self, x):
        B, T, _ = x.shape
        return x.reshape(B, T, self.num_heads, self.head_dim)

    def _merge(self, x):
        return x.reshape(x.shape[0], x.shape[1], self.embed_dim)

    def _grouped_cross(self, q, k, v, bias):
        """Cross-attention with sentence-level K/V shared by G beams.

        q: (B*G, 1, H, Dh); k, v: (B, Tk, H, Dh); bias: (B*G, 1, 1, Tk) or None.
        Returns ((B*G, 1, D), None)."""
        B, Tk = k.shape[0], k.shape[1]
        G = q.shape[0] // B
        qg = q.reshape(B, G, self.num_heads, self.head_dim)
        scores = torch.einsum("bghd,bthd->bhgt", qg, k) / math.sqrt(self.head_dim)
        if bias is not None:
            # (B*G, 1, 1, Tk) -> (B, 1, G, Tk), broadcast over heads
            scores = scores + bias.reshape(B, G, 1, Tk).transpose(1, 2)
        w = torch.softmax(scores.float(), dim=-1).to(q.dtype)
        out = torch.einsum("bhgt,bthd->bghd", w, v).reshape(B * G, 1, self.embed_dim)
        return self.out_proj(out), None

    def project_kv(self, key, value=None):
        """Split K/V of a static source, projected once (cross-attention
        during incremental decode)."""
        value = key if value is None else value
        return self._split(self.k_proj(key)), self._split(self.v_proj(value))

    def forward(
        self,
        query: torch.Tensor,
        key: torch.Tensor,
        value: torch.Tensor,
        bias: Optional[torch.Tensor] = None,
        cache: Optional[dict] = None,
        cache_index: Optional[int] = None,
        valid_mask: Optional[torch.Tensor] = None,
        kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Optional[dict]]:
        """Returns (output (B, Tq, D), cache).

        Incremental mode: pass ``cache`` and ``cache_index`` (a Python int);
        query then has Tq == 1 and key/value are the new step only.
        ``generator``: the training step's; None means no dropout."""
        q = self._split(self.q_proj(query))
        if kv_override is not None:
            k, v = kv_override
            if k.shape[0] != q.shape[0] and cache is None:
                # beam-shared cross K/V: one row per sentence, G beams per sentence
                return self._grouped_cross(q, k, v, bias)
        else:
            k = self._split(self.k_proj(key))
            v = self._split(self.v_proj(value))

        if bias is None and valid_mask is not None and cache is None and kv_override is None:
            if q.shape[1] == k.shape[1]:
                # encoder self-attention with a pure padding mask: the fused
                # kernel (the (B, H, T, T) probabilities never reach memory)
                rate = self.dropout if generator is not None else 0.0
                seed = kernel_seed(generator) if rate > 0 else None
                out = fused_attention(q, k, v, valid_mask, rate, seed)
                return self.out_proj(self._merge(out)), None
            bias = padding_bias(valid_mask, q.dtype)

        if cache is not None:
            if q.shape[1] != 1:
                raise ValueError("incremental attention takes one query step at a time")
            i = int(cache_index)
            cache["k"][:, i:i + 1] = k
            cache["v"][:, i:i + 1] = v
            k, v = cache["k"][:, :i + 1], cache["v"][:, :i + 1]
            if bias is not None:
                bias = bias[..., :i + 1]

        w = drop(dot_attention_weights(q, k, bias, q.dtype), self.dropout, generator)
        out = torch.einsum("bhqk,bkhd->bqhd", w, v)
        return self.out_proj(self._merge(out)), cache


class RelPositionMultiHeadAttention(nn.Module):
    """Transformer-XL relative-position self-attention, ESPnet's variant that
    the Conformer uses (s2t_tpu/modules/attention.py:474-542): content scores
    (q + u) k^T plus position scores (q + v) p^T, the latter shifted so that key
    j of query i reads the table row of position j - i.  Dense, as in JAX.
    ``pos_emb`` is ``relative_encoding(T, D)`` for the call's T.  The scores and
    both products stay in the input dtype, the softmax runs in f32 and is cast
    back (attention.py:539)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of num_heads {num_heads}")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.q_proj = Linear(embed_dim, embed_dim)
        self.k_proj = Linear(embed_dim, embed_dim)
        self.v_proj = Linear(embed_dim, embed_dim)
        self.pos_proj = Linear(embed_dim, embed_dim, bias=False)
        self.out_proj = Linear(embed_dim, embed_dim)
        self.pos_bias_u = nn.Parameter(torch.zeros(num_heads, self.head_dim))
        self.pos_bias_v = nn.Parameter(torch.zeros(num_heads, self.head_dim))

    @staticmethod
    def rel_shift(x: torch.Tensor) -> torch.Tensor:
        """(B, H, T, 2T-1) -> (B, H, T, T): the pad-one-left, reshape, drop-a-row
        trick of attention.py:503-512, element for element."""
        B, H, T, L = x.shape
        x = F.pad(x, (1, 0)).reshape(B, H, L + 1, T)
        return x[:, :, 1:, :].reshape(B, H, T, L)[..., :T]

    def forward(self, x: torch.Tensor, pos_emb: torch.Tensor, bias: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Self-attention of ``x`` (B, T, D) under the additive ``bias``
        (B, 1, 1, T); ``generator``: the training step's, None for no dropout."""
        B, T, _ = x.shape
        H, Dh = self.num_heads, self.head_dim
        q = self.q_proj(x).reshape(B, T, H, Dh)
        k = self.k_proj(x).reshape(B, T, H, Dh)
        v = self.v_proj(x).reshape(B, T, H, Dh)
        p = self.pos_proj(pos_emb).reshape(-1, H, Dh)  # (2T-1, H, Dh)
        q_u = q + self.pos_bias_u.to(q.dtype)[None, None]
        q_v = q + self.pos_bias_v.to(q.dtype)[None, None]
        ac = torch.einsum("bqhd,bkhd->bhqk", q_u, k)
        bd = self.rel_shift(torch.einsum("bqhd,lhd->bhql", q_v, p))
        # the JAX scale is sqrt(Dh) rounded to the input dtype
        scores = (ac + bd) / torch.tensor(math.sqrt(Dh), dtype=q.dtype)
        scores = scores + bias
        w = drop(torch.softmax(scores.float(), dim=-1).to(q.dtype), self.dropout, generator)
        out = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, T, self.embed_dim)
        return self.out_proj(out)

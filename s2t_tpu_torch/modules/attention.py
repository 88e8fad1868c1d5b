"""Multi-head attention with an explicit incremental KV cache, and the
Conformer's relative-position attention (counterpart of
s2t_tpu/modules/attention.py: ``MultiHeadAttention`` with its abs, rope, Shaw
relative and Gaussian local types and reduced (strided) keys, and
``RelPositionMultiHeadAttention``).

An encoder layer's self-attention over its slice of the frames under ``seq_parallel``
goes through ``parallel/ring_attention.py`` (``parallel/context.ring_scope``).
Encoder self-attention (abs or rope) with a pure padding mask goes to the fused kernel
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
Two more cache forms of the JAX module (attention.py:304-395): the int8 cache
(a cache with ``k_scale`` / ``v_scale`` leaves: int8 k / v with per-(position,
head) bf16 absmax scales, applied after the contractions), and the lazy beam
reorder's ancestry map
(``cache_ancestry`` (B, K, L): the beam slot that holds each position of each
beam's history; every beam writes its own slot).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from s2t_tpu_torch.modules.cast import Linear
from s2t_tpu_torch.modules.dropout import dropout as drop
from s2t_tpu_torch.modules.positional import apply_rope, rope_table
from s2t_tpu_torch.ops.attention_cuda import fused_attention
from s2t_tpu_torch.parallel.context import get_mesh, ring_active
from s2t_tpu_torch.parallel.ring_attention import ring_attention

NEG = -1e9


def padding_bias(valid_mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(B, Tk) valid-mask -> (B, 1, 1, Tk) additive attention bias."""
    return torch.where(valid_mask[:, None, None, :], 0.0, NEG).to(dtype)


def causal_bias(T: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(1, 1, T, T) additive causal mask."""
    mask = torch.ones((T, T), dtype=torch.bool, device=device).tril()
    return torch.where(mask, 0.0, NEG).to(dtype)[None, None]


def attention_suppression(scores: torch.Tensor, scale: float) -> torch.Tensor:
    """Mask the keys whose probability falls ``scale`` standard deviations below
    the per-query mean over the keys of nonzero probability (the streaming
    robustness trick, s2t_tpu/modules/attention.py:46-57); ``scores`` (..., Tk)
    pre-softmax."""
    prob = torch.softmax(scores.float(), dim=-1)
    nonzero = prob > 0
    n = nonzero.float().sum(dim=-1, keepdim=True)
    mean = prob.sum(dim=-1, keepdim=True) / (n + 1e-8)
    dis = torch.where(nonzero, (prob - mean) ** 2, 0.0)
    std = torch.sqrt(dis.sum(dim=-1, keepdim=True) / (n - 1.0 + 1e-8))
    return torch.where(prob < mean - scale * std, NEG, scores.float()).to(scores.dtype)


def dot_attention_weights(q, k, bias, dtype, std_scale: float = 0.0):
    """q: (B, Tq, H, Dh), k: (B, Tk, H, Dh), bias: (B, 1|H, Tq, Tk) additive;
    ``std_scale`` > 0 suppresses the weak keys first.  The softmax runs in f32."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if bias is not None:
        scores = scores + bias
    if std_scale > 0:
        scores = attention_suppression(scores, std_scale)
    return torch.softmax(scores.float(), dim=-1).to(dtype)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., Dh) -> (int8 values, bf16 scales (...)): absmax / 127 per row with a
    1e-8 floor, rounded half to even and clipped to +-127."""
    x = x.float()
    scale = torch.clamp(x.abs().amax(dim=-1) / 127.0, min=1e-8)
    return torch.clamp(torch.round(x / scale[..., None]), -127, 127).to(torch.int8), \
        scale.to(torch.bfloat16)


def select_ancestors(kv: torch.Tensor, ancestry: torch.Tensor) -> torch.Tensor:
    """kv (B*K, T, H, Dh) written in place by each beam at its own slot; ancestry
    (B, K, >= T) the slot that holds each position of each beam's history ->
    each beam's own history (B*K, T, H, Dh)."""
    N, T, H, Dh = kv.shape
    B, K = ancestry.shape[:2]
    idx = ancestry[:, :, :T, None].expand(B, K, T, H * Dh)
    return kv.reshape(B, K, T, H * Dh).gather(1, idx).reshape(N, T, H, Dh)


def local_window_bias(T: int, window: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(1, 1, T, T) band mask: keys farther than ``window`` frames are hidden."""
    i = torch.arange(T, device=device)
    band = (i[:, None] - i[None, :]).abs() <= window
    return torch.where(band, 0.0, NEG).to(dtype)[None, None]


def kernel_seed(generator: torch.Generator) -> torch.Tensor:
    """A (1,) int64 dropout seed for the fused kernel, drawn on the generator's
    device (no host sync)."""
    return torch.randint(0, 2 ** 62, (1,), generator=generator, device=generator.device)


def shard_seed(seed: torch.Tensor, index: int) -> torch.Tensor:
    """The kernel seed of tensor-parallel rank ``index``'s heads: its high word xored
    with the rank, so each rank's heads draw their own masks (Megatron's model-parallel
    stream); rank 0 keeps the step's seed."""
    return seed ^ (index << 32) if index else seed


# the attention types of ``MultiHeadAttention`` (rel_pos is ``RelPositionMultiHeadAttention``),
# and those that take the fused kernel under a pure padding mask
ATTENTION_TYPES = ("abs", "rope", "relative", "local")
FUSED_ATTENTION_TYPES = ("abs", "rope")
# the length of rope's tables (the JAX module's ``max_positions`` default)
ROPE_MAX_POSITIONS = 4096


class MultiHeadAttention(nn.Module):
    """``attention_type``: "abs"; "rope" (q and k rotated, s2t_tpu/modules/attention.py:420-431);
    "relative" (Shaw: learned keys of the clipped distance key - query, an additive
    score, :338-349, :588-597); "local" (with ``gauss_mask_sigma`` a per-head learned
    Gaussian of the distance mixed into the probabilities, :619-640).  ``kv_stride``
    keeps every s-th key and value outside incremental decoding (:402-406).  Only
    abs and rope attention under a pure padding mask with Tq == Tk reach the fused
    kernel, as in JAX (:443-472); the rest is dense.  ``attention_std_scale`` > 0
    suppresses the weak keys of the dense path (the Emformer's, :423-439).
    ``kv_dim`` (0: ``embed_dim``): the width of the keys and values it projects
    (a cross-attention over a wider encoder; flax infers it)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 attention_type: str = "abs", kv_stride: int = 1, max_relative_length: int = 0,
                 gauss_mask_sigma: float = 0.0, init_mask_weight: float = 0.5,
                 attention_std_scale: float = 0.0, kv_dim: int = 0):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of num_heads {num_heads}")
        if attention_type not in ATTENTION_TYPES:
            raise ValueError(f"attention type {attention_type!r} not in {ATTENTION_TYPES}")
        if attention_type == "relative" and max_relative_length <= 0:
            raise ValueError("relative attention needs max_relative_length > 0")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.attention_type = attention_type
        self.kv_stride = kv_stride
        self.max_relative_length = max_relative_length
        self.attention_std_scale = attention_std_scale
        # (index, count): this module holds tensor-parallel rank index's 1 / count of the
        # heads (set by ``parallel.tensor_parallel``); its dropout draws are that rank's
        self.shard: Optional[Tuple[int, int]] = None
        self.q_proj = Linear(embed_dim, embed_dim)
        self.k_proj = Linear(kv_dim or embed_dim, embed_dim)
        self.v_proj = Linear(kv_dim or embed_dim, embed_dim)
        self.out_proj = Linear(embed_dim, embed_dim)
        if attention_type == "relative":
            self.relative_position_keys = nn.Parameter(
                torch.zeros(2 * max_relative_length + 1, self.head_dim))
        self.gauss = attention_type == "local" and gauss_mask_sigma != 0
        if self.gauss:
            self.gauss_sigma = nn.Parameter(torch.full((num_heads, 1, 1), float(gauss_mask_sigma)))
            self.gauss_mask_weight = nn.Parameter(
                torch.full((num_heads, 1, 1), float(init_mask_weight)))

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

    def _rope(self, q, k, start: Optional[int]):
        """q and k rotated at positions 0.. each (``start`` None), or both at ``start``
        (one incremental step)."""
        n = max(q.shape[1], k.shape[1]) if start is None else start + 1
        if n > ROPE_MAX_POSITIONS:
            raise ValueError(f"rope attention over {n} positions > {ROPE_MAX_POSITIONS}")
        cos, sin = rope_table(ROPE_MAX_POSITIONS, self.head_dim, q.dtype, q.device)
        if start is not None:
            cos, sin = cos[start:start + 1], sin[start:start + 1]
            return apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        Tq, Tk = q.shape[1], k.shape[1]
        return apply_rope(q, cos[:Tq], sin[:Tq]), apply_rope(k, cos[:Tk], sin[:Tk])

    def relative_bias(self, q, key_pos, q_pos):
        """The Shaw score q . keys[clip(key_pos - q_pos, -L, L) + L] / sqrt(Dh) as an
        additive (B, H, Tq, Tk) bias: the products with the 2L + 1 learned keys,
        gathered by distance."""
        L = self.max_relative_length
        dist = torch.clamp(key_pos[None, :] - q_pos[:, None], -L, L) + L  # (Tq, Tk)
        qr = torch.einsum("bqhd,ld->bhql", q, self.relative_position_keys.to(q.dtype))
        B, H, Tq, _ = qr.shape
        rel = torch.gather(qr, 3, dist[None, None].expand(B, H, Tq, dist.shape[1]))
        return rel / torch.tensor(math.sqrt(self.head_dim), dtype=q.dtype)

    def _gauss_mix(self, w, valid_mask):
        """((1 - g) w + g p_gauss) / 2 with g = sigmoid(gauss_mask_weight) and p_gauss
        the softmax over keys of -(k - q)^2 / (2 sigma^2), which sees no padding; the
        padded keys are zeroed after the mix, with no renormalisation (:619-640)."""
        Tq, Tk = w.shape[2], w.shape[3]
        d = torch.arange(Tk, dtype=torch.float32, device=w.device)
        dis2 = -((d[None, :] - d[:Tq, None]) ** 2) / 2.0
        inv_sig2 = 1.0 / torch.square(self.gauss_sigma.float())
        p_gauss = torch.softmax(dis2[None] * inv_sig2, dim=-1)[None].to(w.dtype)
        mw = torch.sigmoid(self.gauss_mask_weight.float())[None].to(w.dtype)
        w = ((1.0 - mw) * w + mw * p_gauss) / 2.0
        if valid_mask is not None:
            vm = valid_mask[:, ::self.kv_stride] if self.kv_stride > 1 else valid_mask
            w = w * vm[:, None, None, :].to(w.dtype)
        return w

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
        cache_ancestry: Optional[torch.Tensor] = None,
        key_order: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Optional[dict]]:
        """Returns (output (B, Tq, D), cache).

        Incremental mode: pass ``cache`` and ``cache_index`` (a Python int);
        query then has Tq == 1 and key/value are the new step only.
        ``generator``: the training step's; None means no dropout.
        ``cache_ancestry``: the lazy reorder's (B, K, L) slot map, this step's
        column already each beam's own slot.  ``key_order`` (B, Tk): a
        permutation that puts each row's valid keys first (``valid_first``), for a
        ``valid_mask`` that need not be a prefix; the fused kernel then takes the
        keys in that order under the prefix mask, the dense path ignores it."""
        out, cache, _ = self._attend(query, key, value, bias, cache, cache_index, valid_mask,
                                     kv_override, generator, cache_ancestry, key_order)
        return out, cache

    def forward_with_weights(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                             bias: Optional[torch.Tensor],
                             generator: Optional[torch.Generator] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Dense attention under ``bias``, outside incremental decoding: (output, the
        (B, H, Tq, Tk) probabilities before dropout), what the JAX module sows
        (attention.py:464-467)."""
        out, _, probs = self._attend(query, key, value, bias, generator=generator)
        return out, probs

    def _attend(self, query, key, value, bias=None, cache=None, cache_index=None,
                valid_mask=None, kv_override=None, generator=None, cache_ancestry=None,
                key_order=None):
        """``forward``'s body: (output, cache, the dense path's probabilities or None)."""
        s = self.kv_stride
        if s > 1 and cache is None:
            key, value = key[:, ::s], value[:, ::s]
            if bias is not None:
                bias = bias[..., ::s]
        q = self._split(self.q_proj(query))
        if kv_override is not None:
            k, v = kv_override
            if k.shape[0] != q.shape[0] and cache is None:
                # beam-shared cross K/V: one row per sentence, G beams per sentence
                return (*self._grouped_cross(q, k, v, bias), None)
        else:
            k = self._split(self.k_proj(key))
            v = self._split(self.v_proj(value))
        i = None if cache is None else int(cache_index)
        if self.attention_type == "rope":
            q, k = self._rope(q, k, i)

        if bias is None and valid_mask is not None and cache is None and kv_override is None \
                and ring_active() and q.shape[1] == k.shape[1]:
            # an encoder layer's slice of the frames under seq_parallel: the ring over the
            # "seq" group (s2t_tpu/modules/attention.py:254-262)
            out = ring_attention(q, k, v, valid_mask, get_mesh().group("seq"))
            return self.out_proj(self._merge(out)), None, None
        if bias is None and valid_mask is not None and cache is None and kv_override is None:
            if self.attention_type in FUSED_ATTENTION_TYPES and q.shape[1] == k.shape[1] \
                    and self.attention_std_scale == 0:
                # encoder self-attention with a pure padding mask: the fused
                # kernel (the (B, H, T, T) probabilities never reach memory)
                if key_order is not None:
                    # attention does not depend on the order of its keys: valid first,
                    # the mask becomes the prefix of each row's count that the kernel reads
                    rows = torch.arange(k.shape[0], device=k.device)[:, None]
                    k, v, valid_mask = k[rows, key_order], v[rows, key_order], \
                        valid_mask[rows, key_order]
                rate = self.dropout if generator is not None else 0.0
                seed = kernel_seed(generator) if rate > 0 else None
                if seed is not None and self.shard is not None:
                    seed = shard_seed(seed, self.shard[0])
                out = fused_attention(q, k, v, valid_mask, rate, seed)
                return self.out_proj(self._merge(out)), None, None
            # the dense path rebuilds the padding bias, strided as the keys are
            bias = padding_bias(valid_mask[:, ::s] if s > 1 else valid_mask, q.dtype)

        int8 = cache is not None and "k_scale" in cache
        if cache is not None:
            if q.shape[1] != 1:
                raise ValueError("incremental attention takes one query step at a time")
            if int8:
                (cache["k"][:, i:i + 1], cache["k_scale"][:, i:i + 1]) = quantize_int8(k)
                (cache["v"][:, i:i + 1], cache["v_scale"][:, i:i + 1]) = quantize_int8(v)
                k, v = cache["k"][:, :i + 1].to(q.dtype), cache["v"][:, :i + 1].to(q.dtype)
            else:
                cache["k"][:, i:i + 1] = k
                cache["v"][:, i:i + 1] = v
                k, v = cache["k"][:, :i + 1], cache["v"][:, :i + 1]
                if cache_ancestry is not None:
                    k, v = select_ancestors(k, cache_ancestry), select_ancestors(v, cache_ancestry)
            if bias is not None:
                bias = bias[..., :i + 1]

        if self.attention_type == "relative":
            dev = q.device
            q_pos = torch.arange(q.shape[1], device=dev) + (0 if i is None else i)
            key_pos = torch.arange(k.shape[1], device=dev) * (s if cache is None else 1)
            rel = self.relative_bias(q, key_pos, q_pos)
            bias = rel if bias is None else bias + rel

        if int8:
            return self.out_proj(self._merge(self._int8_attend(q, k, v, cache, i, bias))), \
                cache, None
        w = dot_attention_weights(q, k, bias, q.dtype, self.attention_std_scale)
        if self.gauss and cache is None:
            w = self._gauss_mix(w, valid_mask)
        probs = w
        w = drop(w, self.dropout, generator, None if self.shard is None else (1, *self.shard))
        out = torch.einsum("bhqk,bkhd->bqhd", w, v)
        return self.out_proj(self._merge(out)), cache, probs

    @staticmethod
    def _int8_attend(q, k8, v8, cache, i: int, bias):
        """One step over the int8 cache (s2t_tpu/modules/attention.py:345-395): the
        per-(position, head) scales commute out of the head-dim contractions, so
        scores = (q . k8) / sqrt(Dh) * s_k and out = sum_t (w s_v)[t] v8[t]; ``k8`` /
        ``v8``: the written prefix, in q's dtype."""
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k8) / torch.tensor(
            math.sqrt(q.shape[-1]), dtype=q.dtype)
        scores = scores * cache["k_scale"][:, :i + 1].to(q.dtype).transpose(1, 2)[:, :, None, :]
        if bias is not None:
            scores = scores + bias
        w = torch.softmax(scores.float(), dim=-1).to(q.dtype)
        wv = w * cache["v_scale"][:, :i + 1].to(q.dtype).transpose(1, 2)[:, :, None, :]
        return torch.einsum("bhqk,bkhd->bqhd", wv, v8)


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

"""Ring attention over the "seq" group: sequence parallelism for long audio
(counterpart of s2t_tpu/parallel/ring_attention.py).

Each of the P ranks holds (B, T/P, H, Dh) of q, k and v and its (B, T/P) validity.
P ring steps: score the local q block against the resident k / v block, fold it into
the (acc, m, l) online softmax in float32, then pass k, v and their validity one rank
on (``send`` / ``recv`` through ``batch_isend_irecv``).  The result equals dense masked
attention over the whole T up to float reassociation; masked keys score -1e30 and a
query row that is padding gives 0, as JAX's block does.  The block step is dense, as
JAX's is: no hand kernel runs here (ROADMAP.md section 2).

``ring_attention`` is a ``torch.autograd.Function``.  Its backward recomputes each
block's probabilities from the saved log-sum-exp and rotates k, v and their dK / dV
accumulators around the same ring; after P steps each rank holds the dK and dV of its
own keys, summed over every rank's queries.
"""

from __future__ import annotations

import math

import torch

from s2t_tpu_torch.parallel.collectives import group_size, next_prev, sendrecv

NEG = -1e30


def _scores(q, k, kv_valid, scale):
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    return s.masked_fill(~kv_valid[:, None, None, :], NEG)


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, valid, group):
        P = group_size(group)
        nxt, prv = next_prev(group)
        scale = 1.0 / math.sqrt(q.shape[-1])
        qf, kc, vc, vm = q.float(), k.float(), v.float(), valid
        B, Tl, H, Dh = q.shape
        acc = qf.new_zeros(B, H, Tl, Dh)
        m = qf.new_full((B, H, Tl), NEG)
        l = qf.new_zeros(B, H, Tl)
        for i in range(P):
            s = _scores(qf, kc, vm, scale)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vc)
            m = m_new
            if i < P - 1:
                kc, vc = sendrecv(kc, nxt, prv, group), sendrecv(vc, nxt, prv, group)
                vm = sendrecv(vm.to(torch.uint8), nxt, prv, group).bool()
        out = acc / torch.clamp(l[..., None], min=1e-30)
        out = out.masked_fill(~valid[:, None, :, None], 0.0).transpose(1, 2)  # (B, Tl, H, Dh)
        lse = m + torch.log(torch.clamp(l, min=1e-30))
        ctx.save_for_backward(q, k, v, valid, out, lse)
        ctx.group = group
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v, valid, out, lse = ctx.saved_tensors
        group = ctx.group
        P = group_size(group)
        nxt, prv = next_prev(group)
        scale = 1.0 / math.sqrt(q.shape[-1])
        qf = q.float()
        do = g.float().masked_fill(~valid[:, :, None, None], 0.0)
        delta = (do * out).sum(dim=-1).transpose(1, 2)  # (B, H, Tl)
        dq = torch.zeros_like(qf)
        kc, vc, vm = k.float(), v.float(), valid
        dk, dv = torch.zeros_like(kc), torch.zeros_like(vc)
        for i in range(P):
            p = torch.exp(_scores(qf, kc, vm, scale) - lse[..., None])
            dv = dv + torch.einsum("bhqk,bqhd->bkhd", p, do)
            dp = torch.einsum("bqhd,bkhd->bhqk", do, vc)
            ds = p * (dp - delta[..., None])
            dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kc) * scale
            dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
            # the block and its accumulators move on together; after P moves each
            # rank holds its own keys' dK / dV again
            dk, dv = sendrecv(dk, nxt, prv, group), sendrecv(dv, nxt, prv, group)
            if i < P - 1:
                kc, vc = sendrecv(kc, nxt, prv, group), sendrecv(vc, nxt, prv, group)
                vm = sendrecv(vm.to(torch.uint8), nxt, prv, group).bool()
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid: torch.Tensor,
                   group) -> torch.Tensor:
    """Sequence-parallel self-attention of this rank's (B, T/P, H, Dh) q / k / v and
    (B, T/P) bool validity over ``group``'s ring -> (B, T/P, H, Dh)."""
    return _Ring.apply(q, k, v, valid, group)

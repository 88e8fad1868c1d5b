"""Pipeline parallelism over the "pipe" group: GPipe's microbatches through the
encoder's stages (counterpart of s2t_tpu/parallel/pipeline.py and the pipelined stack
of s2t_tpu/models/s2t_transformer.py:636-679).

Rank p of the P pipe ranks runs stages [p S/P, (p + 1) S/P) of the S.  Microbatch m
enters at rank 0 (every rank holds the whole input; rank 0 reads it), rides the ranks
in order by point-to-point ``send`` / ``recv``, and leaves the last rank, which
broadcasts the outputs to every pipe rank (the CTC head and the decoder run on each).
The forward builds each microbatch's graph through the rank's own stages; the backward
takes the microbatches in the same order, receives the output gradient from the next
rank, runs ``torch.autograd.grad`` through its stages and sends the input gradient to
the rank before.  Only rank 0 returns the input's gradient, and each rank returns only
its own stages' parameter gradients: both are sums over the group (the sum convention
of ``parallel/collectives.py``).  A rank holds only its own stages' weights and
their optimizer state (``tensor_parallel.ShardedModel``), as the JAX mesh places a
stage's weights on its own devices.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from s2t_tpu_torch.parallel.collectives import broadcast, group_rank, group_size, recv, send


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, mesh, M, x, *params):
        group = mesh.group("pipe")
        P, p = group_size(group), group_rank(group)
        ranks = mesh.ranks("pipe")
        chunks = x.chunk(M, dim=0)
        graphs, outs = [], []
        for m in range(M):
            h_in = (chunks[m] if p == 0 else recv(chunks[m], ranks[p - 1], group)).detach()
            h_in.requires_grad_(True)
            with torch.enable_grad():
                h = run(p, m, h_in)
            graphs.append((h_in, h))
            if p < P - 1:
                send(h.detach(), ranks[p + 1], group)
            else:
                outs.append(h.detach())
        y = torch.cat(outs, dim=0) if p == P - 1 else torch.empty_like(x)
        ctx.graphs, ctx.mesh, ctx.n_params = graphs, mesh, len(params)
        ctx.params = params
        return y

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        group = mesh.group("pipe")
        P, p = group_size(group), group_rank(group)
        ranks = mesh.ranks("pipe")
        M = len(ctx.graphs)
        g_chunks = g.contiguous().chunk(M, dim=0)
        grads: List = [None] * ctx.n_params
        trainable = [i for i, t in enumerate(ctx.params) if t.requires_grad]
        dx = []
        for m in range(M):
            h_in, h = ctx.graphs[m]
            g_out = g_chunks[m] if p == P - 1 else recv(h, ranks[p + 1], group)
            got = torch.autograd.grad(h, [h_in] + [ctx.params[i] for i in trainable], g_out,
                                      allow_unused=True)
            for i, gi in zip(trainable, got[1:]):
                if gi is not None:
                    grads[i] = gi if grads[i] is None else grads[i] + gi
            if p > 0:
                send(got[0], ranks[p - 1], group)
            else:
                dx.append(got[0])
        ctx.graphs = None
        d_x = torch.cat(dx, dim=0) if p == 0 else torch.zeros_like(g)
        return (None, None, None, d_x, *grads)


def pipeline_apply(run: Callable[[int, int, torch.Tensor], torch.Tensor], x: torch.Tensor,
                   n_micro: int, mesh, params: Sequence[torch.Tensor]) -> torch.Tensor:
    """``run(pipe_rank, m, h)`` applies this rank's stages to microbatch m's ``h``;
    ``x`` (B, ...) the whole input on every pipe rank, split into ``n_micro`` along the
    batch; ``params``: the parameters ``run`` reads.  Returns the last stage's output
    (B, ...) on every pipe rank."""
    group = mesh.group("pipe")
    last = mesh.ranks("pipe")[-1]
    y = _Pipeline.apply(run, mesh, n_micro, x, *params)
    return broadcast(y, last, group)

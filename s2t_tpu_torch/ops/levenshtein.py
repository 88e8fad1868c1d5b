"""Levenshtein / LCS oracles and canvas edits for NAT training and decoding
(counterpart of s2t_tpu/ops/levenshtein.py and of the canvas helpers of
s2t_tpu/models/levenshtein_transformer.py:40-140).

* ``lcs_table``: the LCS table, one vectorised step per row over the batch.  LCS
  rows do not decrease, and where a[i] matches b[j] the diagonal + 1 is at least
  both neighbours, so row i = cummax_j(where(match_j, L[i-1, j-1] + 1, L[i-1, j]))
  -- the JAX cell recursion (``_lcs_table``, :25-49) exactly, in N steps where a
  cell-by-cell copy takes N M;
* ``del_targets``: its backtrace (``_del_backtrace``, :52-78) as a batched loop of
  N + M steps in which a finished row stands still;
* ``compact_tokens``, ``insert_placeholders`` (clamped greedily so the canvas never
  overflows, never after the last valid token), ``random_delete_with_mask`` (its
  ranks from a double stable argsort of the scores) and ``ins_oracle_leftmost``
  (greedy leftmost matching, one batched step per target column).

Every random draw is a uniform from the caller's ``torch.Generator``, or one
handed over (``scores`` / ``fractions``).  Plain PyTorch: no TPU kernel runs here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def uniform(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """U[0, 1) float32 draws from ``generator`` on ``device``."""
    return torch.rand(shape, generator=generator, device=device)


def lcs_table(a: torch.Tensor, b: torch.Tensor, a_valid: torch.Tensor,
              b_valid: torch.Tensor) -> torch.Tensor:
    """(B, N), (B, M) tokens and valid masks -> the (B, N + 1, M + 1) int32 LCS tables."""
    B, N = a.shape
    M = b.shape[1]
    row = torch.zeros((B, M + 1), dtype=torch.int32, device=a.device)
    rows = [row]
    for i in range(N):
        match = (a[:, i:i + 1] == b) & a_valid[:, i:i + 1] & b_valid  # (B, M)
        cand = torch.where(match, row[:, :-1] + 1, row[:, 1:])
        row = torch.cat([row[:, :1], torch.cummax(cand, dim=1).values], dim=1)
        rows.append(row)
    return torch.stack(rows, dim=1)


def del_targets(in_tokens: torch.Tensor, out_tokens: torch.Tensor,
                pad_id: int = 1) -> torch.Tensor:
    """(B, N) int32 deletion labels: 1 where in_tokens[i] is outside the LCS
    alignment with out_tokens (the backtrace prefers the diagonal, then up); pad
    positions 0."""
    a, b = in_tokens.long(), out_tokens.long()
    a_valid, b_valid = a != pad_id, b != pad_id
    L = lcs_table(a, b, a_valid, b_valid)
    B, N = a.shape
    M = b.shape[1]
    rows = torch.arange(B, device=a.device)
    i = a_valid.sum(dim=1)
    j = b_valid.sum(dim=1)
    keep = torch.zeros((B, N + 1), dtype=torch.bool, device=a.device)  # column N: a sink
    for _ in range(N + M):
        active = (i > 0) | (j > 0)
        im, jm = (i - 1).clamp(min=0), (j - 1).clamp(min=0)
        here = L[rows, i, j]
        can_diag = (i > 0) & (j > 0) & (a[rows, im] == b[rows, jm]) & \
            (here == L[rows, im, jm] + 1)
        can_up = (i > 0) & (here == L[rows, im, j])
        keep[rows, torch.where(active & can_diag, im, N)] = True
        step_i = can_diag | can_up
        i = torch.where(active & step_i, i - 1, i)
        j = torch.where(active & (can_diag | ~can_up), j - 1, j)
    return (~keep[:, :N] & a_valid).to(torch.int32)


def compact_tokens(tokens: torch.Tensor, keep: torch.Tensor,
                   pad_id: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Left-pack the kept tokens, the rest to pad: (packed (B, T), kept counts (B,))."""
    T = tokens.shape[1]
    pos = torch.arange(T, device=tokens.device)[None, :]
    order = torch.argsort(torch.where(keep, pos, T + pos), dim=1)
    packed = tokens.gather(1, order)
    n_keep = keep.sum(dim=1)
    return torch.where(pos < n_keep[:, None], packed, pad_id), n_keep


def insert_placeholders(tokens: torch.Tensor, counts: torch.Tensor, pad_id: int,
                        unk_id: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Insert ``counts[b, i]`` <unk> after left-packed token i (none after the last
    valid token), clamped greedily so the canvas fits its T: (canvas, lengths)."""
    B, T = tokens.shape
    valid = tokens != pad_id
    n_valid = valid.sum(dim=1)
    pos = torch.arange(T, device=tokens.device)[None, :]
    counts = torch.where(valid & (pos < (n_valid - 1)[:, None]), counts, 0)
    cs_excl = torch.cumsum(counts, dim=1) - counts
    counts = torch.minimum(counts, torch.clamp(T - n_valid[:, None] - cs_excl, min=0))
    new_idx = torch.where(valid, pos + torch.cumsum(counts, dim=1) - counts, T)
    out = torch.full((B, T + 1), unk_id, dtype=tokens.dtype, device=tokens.device)
    out.scatter_(1, new_idx, tokens)  # pads land in the dropped column T
    new_len = n_valid + counts.sum(dim=1)
    return torch.where(pos < new_len[:, None], out[:, :T], pad_id), new_len


def random_delete_with_mask(tgt: torch.Tensor, pad_id: int = 1, bos_id: int = 0,
                            eos_id: int = 2, generator: Optional[torch.Generator] = None,
                            scores: Optional[torch.Tensor] = None,
                            fractions: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop floor(n_deletable x fraction) of the non-special tokens, those of the
    highest uniform ``scores`` (B, T); ``fractions`` (B,) U[0, 1).  Returns the
    packed result and the kept-mask over the original positions."""
    deletable = (tgt != pad_id) & (tgt != bos_id) & (tgt != eos_id)
    if scores is None:
        scores = uniform(tgt.shape, generator, tgt.device)
    if fractions is None:
        fractions = uniform(tgt.shape[:1], generator, tgt.device)
    score = torch.where(deletable, scores.float(), -1.0)
    k = (deletable.sum(dim=1).float() * fractions.float()).to(torch.int32)
    order = torch.argsort(-score, dim=1, stable=True)  # deletable positions first
    rank = torch.argsort(order, dim=1, stable=True)
    keep = (tgt != pad_id) & ~(deletable & (rank < k[:, None]))
    return compact_tokens(tgt, keep, pad_id)[0], keep


def ins_oracle_leftmost(y_del: torch.Tensor, tgt: torch.Tensor, pad_id: int = 1) -> torch.Tensor:
    """Greedy leftmost matching of the packed subsequence ``y_del`` (B, T) inside
    ``tgt`` (B, T'): counts[b, i] = target tokens to insert after packed token i."""
    B, T = y_del.shape
    rows = torch.arange(B, device=y_del.device)
    n_keep = (y_del != pad_id).sum(dim=1)
    i = torch.zeros(B, dtype=torch.long, device=y_del.device)
    counts = torch.zeros((B, T), dtype=torch.int32, device=y_del.device)
    for jcol in range(tgt.shape[1]):
        b_tok = tgt[:, jcol]
        b_ok = b_tok != pad_id
        match = b_ok & (i < n_keep) & (b_tok == y_del[rows, i.clamp(max=T - 1)])
        dropped = (b_ok & ~match).to(torch.int32)
        counts[rows, (i - 1).clamp(min=0)] += dropped
        i = i + match.long()
    return counts

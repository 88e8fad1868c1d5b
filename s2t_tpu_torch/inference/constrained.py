"""Lexically constrained beam search (counterpart of
s2t_tpu/inference/constrained.py:46-362).

The constraint state is dense, per hypothesis: ``done`` (B, K, C) phrases
fully emitted, ``active`` (B, K) the phrase in progress (-1: none) and ``pos``
(B, K) its matched length.  Each step half the beam is chosen by score (the
free bank) and half from candidates that advance the constraints (the
progress bank, ranked by constraint tokens met, then score).  EOS is banned
until a hypothesis has met every constraint, except at the last step, where a
hypothesis with unmet constraints may finish ranked below every satisfying
one.  ``ordered`` requires the phrases in the given order.

Constraints are a (B, C, Lc) id tensor padded with ``pad_id``
(``pack_constraints``).  The step loop runs all ``max_len`` steps, as the
JAX scan does.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch

from s2t_tpu_torch.inference.beam_search import (
    NEG_INF, finalize, length_penalty, reorder_cache, stable_topk)

BONUS = 1e5  # the progress bank's selection key per constraint token met


def pack_constraints(batch_constraints: List[List[List[int]]], pad_id: int = 1) -> np.ndarray:
    """[[phrase ids...] per constraint] per sentence -> (B, C, Lc) array."""
    B = len(batch_constraints)
    C = max((len(cs) for cs in batch_constraints), default=1) or 1
    Lc = max((len(p) for cs in batch_constraints for p in cs), default=1) or 1
    out = np.full((B, C, Lc), pad_id, np.int32)
    for b, cs in enumerate(batch_constraints):
        for c, phrase in enumerate(cs):
            out[b, c, :len(phrase)] = phrase
    return out


def constrained_beam_search(
    decode_step: Callable,
    init_cache: Any,
    constraints: torch.Tensor,
    batch_size: int,
    beam_size: int,
    max_len: int,
    eos_id: int = 2,
    pad_id: int = 1,
    bos_id: int = 2,
    blank_id: int = 0,
    lenpen: float = 1.0,
    min_len: int = 1,
    ordered: bool = False,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (tokens (B, K, L) best first, scores (B, K))."""
    B, K, L = batch_size, beam_size, max_len
    dev = device
    constraints = constraints.to(device=dev, dtype=torch.long)
    C, Lc = constraints.shape[1], constraints.shape[2]
    Kp = K // 2  # the progress bank
    Kf = K - Kp  # the free bank
    if Kp == 0:
        Kp, Kf = 1, max(K - 1, 1)
    con_len = (constraints != pad_id).sum(dim=-1)  # (B, C)
    con_exists = con_len > 0
    b_ix = torch.arange(B, device=dev)[:, None]
    c_ar = torch.arange(C, device=dev)[None, None, :]
    rows_b = b_ix * K

    alive_tokens = torch.full((B, K, L), pad_id, dtype=torch.long, device=dev)
    alive_scores = torch.full((B, K), NEG_INF, device=dev)
    alive_scores[:, 0] = 0.0
    done = ~con_exists[:, None, :].expand(B, K, C)
    active = torch.full((B, K), -1, dtype=torch.long, device=dev)
    pos = torch.zeros((B, K), dtype=torch.long, device=dev)
    finished_tokens = torch.full((B, K, L), pad_id, dtype=torch.long, device=dev)
    finished_scores = torch.full((B, K), NEG_INF, device=dev)
    finished_mask = torch.zeros((B, K), dtype=torch.bool, device=dev)
    cache = init_cache
    total_con = torch.where(con_exists, con_len, 0).sum(dim=-1)  # (B,)

    def startable(done, active):
        """(B, K, C): the constraints a beam may begin now."""
        can = ~done & con_exists[:, None, :] & (active < 0)[:, :, None]
        if ordered:
            first_undone = (~done).int().argmax(dim=-1)  # only the first not-done one
            can = can & (c_ar == first_undone[..., None])
        return can

    def phrase_tok(active, pos):
        """(B, K): the next token of each beam's active phrase."""
        return constraints[b_ix, active.clamp(min=0), pos.clamp(0, Lc - 1)]

    for i in range(L):
        prev = (torch.full((B * K, 1), bos_id, dtype=torch.long, device=dev) if i == 0
                else alive_tokens[:, :, i - 1].reshape(B * K, 1))
        logprobs, cache = decode_step(prev, cache, i)
        V = logprobs.shape[-1]
        logprobs = logprobs.reshape(B, K, V).clone()
        vocab = torch.arange(V, device=dev)[None, None, :]
        all_done = done.all(dim=-1)
        if i < L - 1:
            # EOS once every constraint is met (and not before min_len); at the
            # horizon the forced EOS takes precedence
            logprobs[:, :, eos_id] = logprobs[:, :, eos_id].masked_fill(
                ~all_done | (i < min_len), NEG_INF)
        logprobs[:, :, pad_id] = NEG_INF
        if blank_id is not None and blank_id >= 0:
            logprobs[:, :, blank_id] = NEG_INF
        if i == L - 1:
            logprobs = logprobs.masked_fill(vocab != eos_id, NEG_INF)

        # ---- progress: tokens that advance constraint coverage ---------------
        prog = (vocab == phrase_tok(active, pos)[..., None]) & (active >= 0)[..., None]
        start_hot = constraints[:, :, 0, None] == vocab[0, 0][None, None, :]  # (B, C, V)
        can_start = startable(done, active)
        prog = prog | (start_hot[:, None] & can_start[..., None]).any(dim=2)
        prog = prog | all_done[..., None]  # satisfied: any continuation counts

        flat = (alive_scores[:, :, None] + logprobs).reshape(B, K * V)
        free_scores, free_idx = stable_topk(flat, 2 * Kf)
        met_parent = torch.where(done & con_exists[:, None, :], con_len[:, None, :], 0).sum(
            dim=-1) + torch.where(active >= 0, pos, 0)  # (B, K)
        met_after = met_parent[:, :, None] + (prog & ~all_done[..., None]).long()
        sel_flat = torch.where(prog.reshape(B, K * V),
                               flat + BONUS * met_after.reshape(B, K * V).to(flat.dtype), NEG_INF)
        # blank the free bank's alive survivors (its first Kf non-EOS entries) and
        # every EOS it lists, so the progress bank duplicates neither
        free_is_eos = (free_idx % V) == eos_id
        kept_free = free_is_eos | (torch.cumsum((~free_is_eos).int(), dim=1) <= Kf)
        cur = sel_flat.gather(1, free_idx)
        sel_flat = sel_flat.scatter(1, free_idx, torch.where(kept_free, NEG_INF, cur))
        prog_sel_scores, prog_idx = stable_topk(sel_flat, 2 * Kp)
        prog_true = torch.where(prog_sel_scores > NEG_INF / 2, flat.gather(1, prog_idx), NEG_INF)

        cand_scores = torch.cat([free_scores, prog_true], dim=1)
        cand_sel_scores = torch.cat([free_scores, prog_sel_scores], dim=1)
        cand_flat_idx = torch.cat([free_idx, prog_idx], dim=1)
        n_cand = cand_scores.shape[1]
        beam_idx = cand_flat_idx // V
        tok_idx = cand_flat_idx % V
        cand_tokens = torch.gather(alive_tokens, 1,
                                   beam_idx[..., None].expand(B, n_cand, L)).clone()
        cand_tokens[:, :, i] = tok_idx
        is_eos = (tok_idx == eos_id) & (cand_scores > NEG_INF / 2)

        # ---- finished set: an unmet constraint ranks below every satisfying one
        norm = length_penalty(torch.tensor(i + 1), lenpen).to(dev)
        unmet = (total_con[:, None] - met_parent.gather(1, beam_idx)).float()
        eos_norm = torch.where(is_eos, cand_scores / norm - 1e4 * unmet, NEG_INF)
        all_fin_scores = torch.cat([finished_scores, eos_norm], dim=1)
        all_fin_tokens = torch.cat([finished_tokens, cand_tokens], dim=1)
        all_fin_mask = torch.cat([finished_mask, is_eos], dim=1)
        finished_scores, fin_sel = stable_topk(all_fin_scores, K)
        finished_tokens = torch.gather(all_fin_tokens, 1, fin_sel[..., None].expand(B, K, L))
        finished_mask = torch.gather(all_fin_mask, 1, fin_sel) & (finished_scores > NEG_INF / 2)

        # ---- alive: Kf from the free half, Kp from the progress half --------
        alive_cand = torch.where(is_eos, NEG_INF, cand_sel_scores)
        _, f_sel = stable_topk(alive_cand[:, :2 * Kf], Kf)
        _, p_sel = stable_topk(alive_cand[:, 2 * Kf:], Kp)
        if K == 1:
            # a single beam: the progress candidate takes the slot whenever it exists
            p_val = alive_cand[:, 2 * Kf:].gather(1, p_sel[:, :1])
            alive_sel = torch.where(p_val > NEG_INF / 2, p_sel[:, :1] + 2 * Kf, f_sel[:, :1])
        else:
            alive_sel = torch.cat([f_sel, p_sel + 2 * Kf], dim=1)[:, :K]
        alive_scores = torch.where(is_eos, NEG_INF, cand_scores).gather(1, alive_sel)
        alive_tokens = torch.gather(cand_tokens, 1, alive_sel[..., None].expand(B, K, L))
        new_beam_idx = beam_idx.gather(1, alive_sel)
        new_tok = tok_idx.gather(1, alive_sel)
        reorder_cache(cache, (rows_b + new_beam_idx).reshape(-1), i + 1)

        # ---- the constraint state of the chosen tokens ------------------------
        g_done = done.gather(1, new_beam_idx[..., None].expand(B, K, C))
        g_active = active.gather(1, new_beam_idx)
        g_pos = pos.gather(1, new_beam_idx)
        act_len = con_len[b_ix, g_active.clamp(min=0)]
        continues = (g_active >= 0) & (new_tok == phrase_tok(g_active, g_pos))
        completes = continues & (g_pos + 1 >= act_len)
        # a token that abandons the active phrase may itself start another
        can_start = startable(g_done, torch.where(continues, g_active, -1))
        starts_c = can_start & (constraints[:, None, :, 0] == new_tok[..., None])
        any_start = starts_c.any(dim=-1) & ~continues
        start_idx = starts_c.int().argmax(dim=-1)
        start_completes = any_start & (con_len[b_ix, start_idx] <= 1)
        done = (g_done | (completes[..., None] & (c_ar == g_active.clamp(min=0)[..., None]))
                | (start_completes[..., None] & (c_ar == start_idx[..., None])))
        keep_going = continues & ~completes
        starting = any_start & ~start_completes
        active = torch.where(keep_going, g_active, torch.where(starting, start_idx, -1))
        pos = torch.where(keep_going, g_pos + 1, torch.where(starting, 1, 0))

    return finalize(finished_scores, finished_tokens, alive_scores, alive_tokens, L, lenpen,
                    eos_id, pad_id)

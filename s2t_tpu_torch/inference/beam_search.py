"""Batched beam search over an incremental decoder
(counterpart of s2t_tpu/inference/beam_search.py:44-499).

Layout: everything is (B, K, ...) reshaped to (B*K, ...) for the model.
Scores follow fairseq semantics: cumulative log-prob; finished hypotheses are
ranked by score / length**lenpen.  The JAX version is one compiled scan; here
the step loop runs in Python on device tensors and the early-stop check reads
one flag back every CHUNK steps, exactly where the JAX loop checks it.

Beside the plain beam: joint CTC/attention scoring of the decoder's top
candidates with a ``CTCPrefixScorer`` (``ctc_scorer``), prefix forcing,
diverse beam groups (Hamming penalty, per-group selection) and diverse
siblings (a rank penalty within each beam).

Top-k selections use a stable sort, so ties resolve to the lower index as
``jax.lax.top_k`` does.  The KV cache is reordered in place by name (the
``KV_LEAVES`` of every nested dict: each layer's "k" and "v" and, in the int8
cache, their scales), over the positions written so far, and the conv decoders'
rolling windows (``conv{i}``) and the LSTM decoders' states (``h{i}``, ``c{i}``,
``feed``) whole; a ``reorder_fn`` (the lazy reorder) replaces that.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Optional, Tuple

import torch

NEG_INF = -1e9
CHUNK = 16  # steps between early-stop checks (beam_search.py:362)
KV_LEAVES = ("k", "v", "k_scale", "v_scale")
# leaves gathered whole: a conv decoder's window of its last inputs, an LSTM decoder's
# layer states and input feed
WHOLE_LEAF = re.compile(r"^(conv\d+|[hc]\d+|feed)$")


def length_penalty(lengths: torch.Tensor, lenpen: float) -> torch.Tensor:
    return torch.pow(lengths.float(), lenpen)


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top k along the last dim, ties to the lower index (lax.top_k order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _ngram_block(logprobs, tokens, i: int, n: int):
    """Ban continuations that would repeat an n-gram of the hypothesis so far.
    logprobs (B, K, V); tokens (B, K, L); step i."""
    if n <= 1 or i < n - 1:
        return logprobs
    B, K, V = logprobs.shape
    cur_ctx = tokens[:, :, i - n + 1:i]                  # (B, K, n-1)
    starts = torch.arange(i - n + 1, device=tokens.device)  # n-grams fully in history
    ctx_idx = starts[:, None] + torch.arange(n - 1, device=tokens.device)[None, :]
    hist_ctx = tokens[:, :, ctx_idx]                     # (B, K, S, n-1)
    hist_next = tokens[:, :, starts + n - 1]             # (B, K, S)
    match = (hist_ctx == cur_ctx[:, :, None, :]).all(dim=-1)
    # unmatched n-grams scatter into a spare column V that is dropped
    banned = torch.zeros((B, K, V + 1), dtype=torch.bool, device=logprobs.device)
    banned.scatter_(2, torch.where(match, hist_next, V), True)
    return logprobs.masked_fill(banned[..., :V], NEG_INF)


def reorder_cache(cache: Any, rows: torch.Tensor, upto: int) -> None:
    """Gather beam rows of every KV leaf (picked by name, in nested dicts)
    over positions [0, upto), and of every rolling conv window (``conv{i}``, fconv's
    and lightconv's (N, k - 1, C) inputs, which have no length axis) and LSTM state
    (``h{i}``, ``c{i}``, ``feed``) whole, in place.  A leaf of
    another name raises: it would not follow the beam."""
    for name, leaf in cache.items():
        if isinstance(leaf, dict):
            reorder_cache(leaf, rows, upto)
        elif name in KV_LEAVES:
            leaf[:, :upto] = leaf[rows, :upto]
        elif WHOLE_LEAF.match(name):
            leaf.copy_(leaf[rows])
        else:
            raise KeyError(f"cache leaf {name!r} has no beam reorder (KV_LEAVES: {KV_LEAVES}, "
                           f"whole: {WHOLE_LEAF.pattern})")


def finalize(finished_scores, finished_tokens, alive_scores, alive_tokens, L: int, lenpen: float,
             eos_id: int, pad_id: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The best K of the finished and the still-alive hypotheses (these at the
    final length norm), padded after their first EOS."""
    B, K = finished_scores.shape
    dev = finished_scores.device
    alive_final = alive_scores / length_penalty(torch.tensor(L), lenpen).to(dev)
    all_scores = torch.cat([finished_scores, alive_final], dim=1)
    all_tokens = torch.cat([finished_tokens, alive_tokens], dim=1)
    best_scores, sel = stable_topk(all_scores, K)
    best_tokens = torch.gather(all_tokens, 1, sel[..., None].expand(B, K, L))
    is_eos = best_tokens == eos_id
    eos_pos = torch.where(is_eos.any(dim=-1), is_eos.int().argmax(dim=-1), L - 1)
    pos = torch.arange(L, device=dev)[None, None, :]
    return best_tokens.masked_fill(pos > eos_pos[..., None], pad_id), best_scores


def _diverse_penalty(logprobs, alive_scores, G: int, strength: float):
    """Diverse beam search's Hamming penalty (beam_search.py:207-228): group g's
    log-probs lose ``strength`` times the count of each token among the top 2 Kg
    candidates of the groups before it."""
    B, K, V = logprobs.shape
    Kg = K // G
    lp_groups = logprobs.reshape(B, G, Kg, V)
    div_buf = torch.zeros((B, V), device=logprobs.device)
    penalised = []
    for g in range(G):
        lp_g = lp_groups[:, g] - strength * div_buf[:, None, :]
        penalised.append(lp_g)
        total_g = alive_scores.reshape(B, G, Kg)[:, g][..., None] + lp_g
        _, top_g = stable_topk(total_g.reshape(B, Kg * V), min(2 * Kg, Kg * V - 1))
        div_buf = div_buf.scatter_add(1, top_g % V, torch.ones(top_g.shape, device=div_buf.device))
    return torch.stack(penalised, dim=1).reshape(B, K, V)


def _sibling_penalty(logprobs, gamma: float):
    """Diverse siblings (beam_search.py:230-244): the r-th best continuation of a
    beam loses gamma * r; only each beam's top 2K stay finite."""
    B, K, V = logprobs.shape
    kk = min(2 * K, V)
    s_lp, s_idx = stable_topk(logprobs, kk)
    s_lp = s_lp - gamma * torch.arange(1, kk + 1, dtype=s_lp.dtype, device=s_lp.device)
    return torch.full_like(logprobs, NEG_INF).scatter(2, s_idx, s_lp)


def beam_search(
    decode_step: Callable[[torch.Tensor, Any, int], Tuple[torch.Tensor, Any]],
    init_cache: Any,
    batch_size: int,
    beam_size: int,
    max_len: int,
    eos_id: int = 2,
    pad_id: int = 1,
    bos_id: int = 2,
    blank_id: int = 0,
    lenpen: float = 1.0,
    min_len: int = 1,
    no_repeat_ngram_size: int = 0,
    ctc_scorer=None,
    ctc_weight: float = 0.0,
    ctc_prune_k: int = 8,
    prefix_tokens: Optional[torch.Tensor] = None,
    diverse_groups: int = 1,
    diverse_strength: float = 0.5,
    diverse_siblings_gamma: float = 0.0,
    reorder_fn: Optional[Callable] = None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run beam search.

    decode_step: fn(tokens (N, 1) int64, cache, index int) -> (logprobs (N, V)
      float32, cache), N = batch*beam; it must already apply
      temperature/log_softmax.
    init_cache: nested dicts whose KV leaves have N = batch*beam rows.
    ctc_scorer / ctc_weight / ctc_prune_k: joint CTC scoring; each beam's top
      ``ctc_prune_k`` - 1 decoder candidates plus EOS are scored by the prefix
      lattice and blended as (1 - w) decoder + w CTC, the rest stay at -1e9.
    prefix_tokens: (B, P) tokens forced at the first P steps (pad: free).
    diverse_groups > 1: K / G beams a group, one live seed each, selected
      group by group; diverse_siblings_gamma > 0: the sibling rank penalty.
    reorder_fn: fn(cache, parent (B, K), step) -> cache, in place of the
      physical reorder of the KV leaves.

    Returns tokens (B, K, max_len) int64, finished hypotheses, EOS-terminated,
    best first, pad after EOS; and scores (B, K) float32, length-normalised,
    descending.
    """
    B, K, L = batch_size, beam_size, max_len
    G = diverse_groups
    dev = device
    alive_tokens = torch.full((B, K, L), pad_id, dtype=torch.long, device=dev)
    alive_scores = torch.full((B, K), NEG_INF, device=dev)
    # one live seed per diverse group (all groups share the start)
    alive_scores[:, ::K // G if G > 1 else K] = 0.0
    finished_tokens = torch.full((B, K, L), pad_id, dtype=torch.long, device=dev)
    finished_scores = torch.full((B, K), NEG_INF, device=dev)
    finished_mask = torch.zeros((B, K), dtype=torch.bool, device=dev)
    cache = init_cache
    ctc_state = ctc_scorer.init_state() if ctc_scorer is not None else None
    arange_b = torch.arange(B, device=dev)[:, None] * K

    def should_continue(i: int) -> bool:
        # optimistic bound: cumulative logprobs only decrease, so a future
        # finished score is <= alive_score / max attainable norm
        norm_bound = torch.maximum(
            length_penalty(torch.tensor(max(i, 1)), lenpen),
            length_penalty(torch.tensor(L), lenpen),
        ).to(dev)
        bound = alive_scores / norm_bound
        can_improve = (bound.max(dim=1).values > finished_scores.min(dim=1).values).any()
        return bool((~finished_mask.all()) | can_improve)

    for i in range(L):
        if i % CHUNK == 0 and not should_continue(i):
            break
        if i == 0:
            prev_tok = torch.full((B * K, 1), bos_id, dtype=torch.long, device=dev)
        else:
            prev_tok = alive_tokens[:, :, i - 1].reshape(B * K, 1)
        logprobs, cache = decode_step(prev_tok, cache, i)
        V = logprobs.shape[-1]
        logprobs = logprobs.reshape(B, K, V).clone()

        if i < min_len:
            logprobs[:, :, eos_id] = NEG_INF
        logprobs[:, :, pad_id] = NEG_INF
        if blank_id is not None and blank_id >= 0:
            logprobs[:, :, blank_id] = NEG_INF
        if i == L - 1:
            # force EOS so every hypothesis terminates
            eos_col = logprobs[:, :, eos_id].clone()
            logprobs.fill_(NEG_INF)
            logprobs[:, :, eos_id] = eos_col
        if no_repeat_ngram_size > 0:
            logprobs = _ngram_block(logprobs, alive_tokens, i, no_repeat_ngram_size)
        if prefix_tokens is not None:
            # the forced token keeps its own log-prob; every other token is banned
            forced = prefix_tokens[:, min(i, prefix_tokens.shape[1] - 1)]
            active = (forced != pad_id) & (i < prefix_tokens.shape[1])
            ban = active[:, None] & (torch.arange(V, device=dev)[None, :] != forced[:, None])
            logprobs = logprobs.masked_fill(ban[:, None, :], NEG_INF)
        if G > 1:
            logprobs = _diverse_penalty(logprobs, alive_scores, G, diverse_strength)
        if diverse_siblings_gamma > 0:
            logprobs = _sibling_penalty(logprobs, diverse_siblings_gamma)

        if ctc_scorer is not None:
            # the decoder's top kc - 1 plus an EOS column (a duplicate EOS writes the same value)
            dec_cand, cand_idx = stable_topk(logprobs, ctc_prune_k - 1)
            cand_idx = torch.cat([cand_idx, torch.full((B, K, 1), eos_id, device=dev)], dim=-1)
            dec_cand = torch.cat([dec_cand, logprobs[:, :, eos_id:eos_id + 1]], dim=-1)
            delta, cand_r, cand_psi = ctc_scorer.score_candidates(
                ctc_state, cand_idx.reshape(B * K, ctc_prune_k))
            blended = (1.0 - ctc_weight) * dec_cand + ctc_weight * delta.reshape(B, K, -1)
            logprobs = torch.full_like(logprobs, NEG_INF).scatter(2, cand_idx, blended)

        total = alive_scores[:, :, None] + logprobs
        # top 2K so that K non-EOS survive even if K EOS appear; diverse groups pick
        # 2 Kg each, so no group starves another
        if G > 1:
            Kg = K // G
            ts_g, ti_g = stable_topk(total.reshape(B, G, Kg * V), 2 * Kg)
            group0 = (torch.arange(G, device=dev) * Kg)[None, :, None]
            top_scores = ts_g.reshape(B, 2 * K)
            beam_idx = (ti_g // V + group0).reshape(B, 2 * K)
            tok_idx = (ti_g % V).reshape(B, 2 * K)
        else:
            top_scores, top_idx = stable_topk(total.reshape(B, K * V), 2 * K)
            beam_idx = top_idx // V
            tok_idx = top_idx % V

        cand_tokens = torch.gather(alive_tokens, 1, beam_idx[..., None].expand(B, 2 * K, L)).clone()
        cand_tokens[:, :, i] = tok_idx
        is_eos = tok_idx == eos_id

        # ---- finished set: merge EOS candidates, keep the top K ------------
        norm = length_penalty(torch.tensor(i + 1), lenpen).to(dev)
        eos_norm_scores = torch.where(is_eos, top_scores / norm, NEG_INF)
        all_fin_scores = torch.cat([finished_scores, eos_norm_scores], dim=1)
        all_fin_tokens = torch.cat([finished_tokens, cand_tokens], dim=1)
        all_fin_mask = torch.cat([finished_mask, is_eos], dim=1)
        finished_scores, fin_sel = stable_topk(all_fin_scores, K)
        finished_tokens = torch.gather(all_fin_tokens, 1, fin_sel[..., None].expand(B, K, L))
        finished_mask = torch.gather(all_fin_mask, 1, fin_sel) & (finished_scores > NEG_INF / 2)

        # ---- alive set: top K non-EOS candidates (Kg a group) ---------------
        alive_cand_scores = torch.where(is_eos, NEG_INF, top_scores)
        if G > 1:
            s_g, sel_g = stable_topk(alive_cand_scores.reshape(B, G, 2 * Kg), Kg)
            alive_scores = s_g.reshape(B, K)
            alive_sel = (sel_g + 2 * group0).reshape(B, K)
        else:
            alive_scores, alive_sel = stable_topk(alive_cand_scores, K)
        alive_tokens = torch.gather(cand_tokens, 1, alive_sel[..., None].expand(B, K, L))
        new_beam_idx = torch.gather(beam_idx, 1, alive_sel)
        if reorder_fn is not None:
            cache = reorder_fn(cache, new_beam_idx, i)
        else:
            reorder_cache(cache, (arange_b + new_beam_idx).reshape(-1), i + 1)

        if ctc_scorer is not None:
            # each survivor's lattice: its token's first slot in its parent's candidates
            alive_tok = torch.gather(tok_idx, 1, alive_sel)
            parent_cand = torch.gather(cand_idx, 1,
                                       new_beam_idx[..., None].expand(B, K, ctc_prune_k))
            cand_pos = (parent_cand == alive_tok[..., None]).int().argmax(dim=-1)
            ctc_state = ctc_scorer.select(ctc_state, cand_idx, cand_r, cand_psi, new_beam_idx,
                                          cand_pos, alive_tok)

    return finalize(finished_scores, finished_tokens, alive_scores, alive_tokens, L, lenpen,
                    eos_id, pad_id)

"""Batched beam search over an incremental decoder
(counterpart of s2t_tpu/inference/beam_search.py:44-499, plain single-model beam).

Layout: everything is (B, K, ...) reshaped to (B*K, ...) for the model.
Scores follow fairseq semantics: cumulative log-prob; finished hypotheses are
ranked by score / length**lenpen.  The JAX version is one compiled scan; here
the step loop runs in Python on device tensors and the early-stop check reads
one flag back every CHUNK steps, exactly where the JAX loop checks it.

Top-k selections use a stable sort, so ties resolve to the lower index as
``jax.lax.top_k`` does.  The KV cache is reordered in place by name ("k" and
"v" leaves of each layer), over the positions written so far.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

NEG_INF = -1e9
CHUNK = 16  # steps between early-stop checks (beam_search.py:362)
KV_LEAVES = ("k", "v")


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
    """Gather beam rows of every KV leaf (picked by name) over positions
    [0, upto), in place."""
    for layer in cache.values():
        for name in KV_LEAVES:
            t = layer[name]
            t[:, :upto] = t[rows, :upto]


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
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run beam search.

    decode_step: fn(tokens (N, 1) int64, cache, index int) -> (logprobs (N, V)
      float32, cache), N = batch*beam; it must already apply
      temperature/log_softmax.
    init_cache: {"layer{i}": {"k": (N, L, H, Dh), "v": ...}} with N = batch*beam.

    Returns tokens (B, K, max_len) int64, finished hypotheses, EOS-terminated,
    best first, pad after EOS; and scores (B, K) float32, length-normalised,
    descending.
    """
    B, K, L = batch_size, beam_size, max_len
    dev = device
    alive_tokens = torch.full((B, K, L), pad_id, dtype=torch.long, device=dev)
    alive_scores = torch.full((B, K), NEG_INF, device=dev)
    alive_scores[:, 0] = 0.0
    finished_tokens = torch.full((B, K, L), pad_id, dtype=torch.long, device=dev)
    finished_scores = torch.full((B, K), NEG_INF, device=dev)
    finished_mask = torch.zeros((B, K), dtype=torch.bool, device=dev)
    cache = init_cache
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

        total = alive_scores[:, :, None] + logprobs
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

        # ---- alive set: top K non-EOS candidates ---------------------------
        alive_cand_scores = torch.where(is_eos, NEG_INF, top_scores)
        alive_scores, alive_sel = stable_topk(alive_cand_scores, K)
        alive_tokens = torch.gather(cand_tokens, 1, alive_sel[..., None].expand(B, K, L))
        new_beam_idx = torch.gather(beam_idx, 1, alive_sel)
        reorder_cache(cache, (arange_b + new_beam_idx).reshape(-1), i + 1)

    # any still-alive beams compete with finished ones at final length norm
    alive_final = alive_scores / length_penalty(torch.tensor(L), lenpen).to(dev)
    all_scores = torch.cat([finished_scores, alive_final], dim=1)
    all_tokens = torch.cat([finished_tokens, alive_tokens], dim=1)
    best_scores, sel = stable_topk(all_scores, K)
    best_tokens = torch.gather(all_tokens, 1, sel[..., None].expand(B, K, L))

    # pad everything after the first EOS
    is_eos = best_tokens == eos_id
    eos_pos = torch.where(is_eos.any(dim=-1), is_eos.int().argmax(dim=-1), L - 1)
    pos = torch.arange(L, device=dev)[None, None, :]
    best_tokens = best_tokens.masked_fill(pos > eos_pos[..., None], pad_id)
    return best_tokens, best_scores

"""Sampling-based decoding: K independent samples a sentence, top-k / top-p
filtered (counterpart of s2t_tpu/inference/sampling.py:20-128).

Every step draws by inverse CDF over the filtered distribution sorted in
descending order (ties to the lower index): a uniform u picks the first
token whose cumulative mass exceeds u times the total.  The uniforms come
from a ``torch.Generator`` or, for parity with the JAX package on the same
draws, from ``noise_uniforms`` (max_len, N).  Finished rows emit pad.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from s2t_tpu_torch.inference.beam_search import CHUNK, stable_topk

NEG = -1e9


def filter_topk(logprobs: torch.Tensor, k: int) -> torch.Tensor:
    if k <= 0:
        return logprobs
    kth = stable_topk(logprobs, k)[0][..., -1:]
    return logprobs.masked_fill(logprobs < kth, NEG)


def filter_topp(logprobs: torch.Tensor, p: float) -> torch.Tensor:
    """The smallest set of most probable tokens with mass >= p (the top token always)."""
    if p <= 0 or p >= 1:
        return logprobs
    sorted_lp = stable_topk(logprobs, logprobs.shape[-1])[0]
    cum = torch.cumsum(torch.exp(sorted_lp), dim=-1)
    keep = torch.cat([torch.ones_like(cum[..., :1], dtype=torch.bool), cum[..., :-1] < p], dim=-1)
    cutoff = torch.where(keep, sorted_lp, torch.inf).min(dim=-1, keepdim=True).values
    return logprobs.masked_fill(logprobs < cutoff, NEG)


def sampling_decode(
    decode_step: Callable,
    init_cache: Any,
    generator: Optional[torch.Generator],
    batch_size: int,
    num_samples: int,
    max_len: int,
    eos_id: int = 2,
    pad_id: int = 1,
    bos_id: int = 2,
    blank_id: int = 0,
    temperature: float = 1.0,
    topk: int = -1,
    topp: float = -1.0,
    min_len: int = 1,
    noise_uniforms=None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (tokens (B, K, L), scores (B, K): the total log-prob of each
    sample under the unfiltered distribution), samples sorted best first.
    ``generator`` draws the uniforms unless ``noise_uniforms`` (L, B*K) is given."""
    B, K, L = batch_size, num_samples, max_len
    N = B * K
    dev = device
    if noise_uniforms is not None:
        noise_uniforms = torch.as_tensor(np.asarray(noise_uniforms, np.float32), device=dev)
        if tuple(noise_uniforms.shape) != (L, N):
            raise ValueError(f"noise_uniforms {tuple(noise_uniforms.shape)}, expected {(L, N)}")
    tokens = torch.full((N, L), pad_id, dtype=torch.long, device=dev)
    scores = torch.zeros((N,), device=dev)
    finished = torch.zeros((N,), dtype=torch.bool, device=dev)
    cache = init_cache
    for i in range(L):
        if i % CHUNK == 0 and i > 0 and bool(finished.all()):
            break  # every later step would emit pad and add 0
        prev = (torch.full((N,), bos_id, dtype=torch.long, device=dev) if i == 0
                else tokens[:, i - 1])
        logprobs, cache = decode_step(prev[:, None], cache, i)
        if temperature != 1.0:
            # decode_step's log-probs are normalised: renormalise after sharpening
            logprobs = torch.log_softmax(logprobs / temperature, dim=-1)
        logprobs = logprobs.clone()
        logprobs[:, pad_id] = NEG
        if blank_id is not None and blank_id >= 0:
            logprobs[:, blank_id] = NEG
        if i < min_len:
            logprobs[:, eos_id] = NEG
        filtered = torch.log_softmax(filter_topp(filter_topk(logprobs, topk), topp), dim=-1)
        kk = topk if topk > 0 else filtered.shape[-1]
        top_lp, top_idx = stable_topk(filtered, kk)
        cdf = torch.cumsum(torch.exp(top_lp), dim=-1)
        u = (noise_uniforms[i] if noise_uniforms is not None
             else torch.rand((N,), generator=generator, device=dev)) * cdf[:, -1]
        pos = torch.clamp((cdf <= u[:, None]).int().sum(dim=-1), max=kk - 1)
        samp = top_idx.gather(1, pos[:, None].long())[:, 0]
        if i == L - 1:
            samp = torch.full_like(samp, eos_id)
        samp = torch.where(finished, pad_id, samp)
        tok_lp = logprobs.gather(1, samp[:, None])[:, 0]
        scores = scores + torch.where(finished, 0.0, tok_lp)
        tokens[:, i] = samp
        finished = finished | (samp == eos_id)
    tokens, scores = tokens.reshape(B, K, L), scores.reshape(B, K)
    order = torch.argsort(-scores, dim=1, stable=True)
    return tokens.gather(1, order[..., None].expand(B, K, L)), scores.gather(1, order)

"""Token-budget batch packing over a static bucket lattice (counterpart of
s2t_tpu/data/batching.py).

Every batch is padded to a (T_bucket, U_bucket, B multiple) shape drawn from
a small lattice, and the token budget is charged for the padded sizes.
``batch_by_size`` is the JAX package's pure-Python loop (:98-125); the JAX
package's ctypes fast path (``s2t_tpu/clib``, host C++) gives the same
batches and waits for a later slice.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def make_buckets(max_val: int, num_buckets: int, min_val: int = 16,
                 sizes: Optional[np.ndarray] = None) -> np.ndarray:
    """Static bucket lattice up to max_val (inclusive): length quantiles of
    ``sizes`` when given, else a geometric span; boundaries snap up to
    multiples of 8 (never past max_val)."""
    if num_buckets <= 1:
        return np.asarray([max_val], dtype=np.int64)
    if sizes is not None and len(sizes) > 0:
        s = np.minimum(np.asarray(sizes, np.int64), max_val)
        qs = np.quantile(s, np.linspace(0.0, 1.0, num_buckets + 1)[1:])
        buckets = np.ceil(qs).astype(np.int64)
    else:
        buckets = np.ceil(np.geomspace(min_val, max_val, num_buckets)).astype(np.int64)
        buckets[-1] = max_val
    buckets = np.maximum(buckets, 1)
    buckets = np.minimum(((buckets + 7) // 8) * 8, max_val)
    return np.unique(buckets)


def bucketize(values: np.ndarray, buckets: np.ndarray) -> np.ndarray:
    """Smallest bucket >= value (values above the top bucket get the top)."""
    idx = np.searchsorted(buckets, values, side="left")
    idx = np.minimum(idx, len(buckets) - 1)
    return buckets[idx]


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def batch_by_size(
    indices: np.ndarray,
    frame_lengths: np.ndarray,
    token_lengths: Optional[np.ndarray] = None,
    max_tokens: Optional[int] = 40000,
    max_sentences: Optional[int] = None,
    frame_buckets: Optional[np.ndarray] = None,
    required_batch_size_multiple: int = 8,
) -> List[np.ndarray]:
    """Pack ``indices`` (pre-sorted by the caller) into batches under the
    budget.  Cost of a batch = B rounded up to the multiple x the bucket of
    its longest frame length.  Returns a list of index arrays."""
    lens = np.asarray(frame_lengths, np.int64)[np.asarray(indices, np.int64)]
    if frame_buckets is not None:
        lens = bucketize(lens, frame_buckets)  # monotone: the bucket of the max is the max
    batches: List[np.ndarray] = []
    cur: List[int] = []
    cur_max = 0
    for i, fl in zip(indices, lens.tolist()):
        new_max = max(cur_max, fl)
        if cur and (
            (max_tokens is not None
             and round_up(len(cur) + 1, required_batch_size_multiple) * new_max > max_tokens)
            or (max_sentences is not None and len(cur) >= max_sentences)
        ):
            batches.append(np.asarray(cur, dtype=np.int64))
            cur, new_max = [], fl
        cur.append(int(i))
        cur_max = new_max
    if cur:
        batches.append(np.asarray(cur, dtype=np.int64))
    return batches


def filter_by_size(frame_lengths: np.ndarray, token_lengths: Optional[np.ndarray],
                   max_frames: int, max_tokens: int, min_frames: int = 1) -> np.ndarray:
    """Indices of samples within size limits."""
    keep = (frame_lengths <= max_frames) & (frame_lengths >= min_frames)
    if token_lengths is not None:
        keep &= token_lengths <= max_tokens
    return np.nonzero(keep)[0]


def collate_targets(samples_targets, B, max_U, pad_id=1, eos_id=2):
    """Pad target id sequences to (B, max_U) with EOS-shifted prev_tokens;
    over-long sequences are truncated keeping the terminal EOS.  Returns
    (target, prev_tokens, tgt_lengths)."""
    target = np.full((B, max_U), pad_id, dtype=np.int32)
    prev = np.full((B, max_U), pad_id, dtype=np.int32)
    tgt_lengths = np.zeros((B,), dtype=np.int32)
    for i, t_full in enumerate(samples_targets):
        t = np.asarray(t_full)[:max_U]
        if len(t_full) > max_U:
            t = np.concatenate([t[: max_U - 1], [eos_id]])
        target[i, : len(t)] = t
        prev[i, 0] = eos_id
        prev[i, 1 : len(t)] = t[:-1]
        tgt_lengths[i] = len(t)
    return target, prev, tgt_lengths

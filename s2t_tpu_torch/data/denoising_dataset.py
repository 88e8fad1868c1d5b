"""BART's denoising dataset: sentence permutation, span infilling, random
deletion and insertion (counterpart of s2t_tpu/data/denoising_dataset.py).

The noise is host numpy, drawn for each item from one generator seeded by
(seed, epoch, index), so an epoch sees fresh corruptions and the batches equal
the JAX package's draw for draw:

1. sentence permutation: the lines split after each full stop, and
   max(2, round(n * permute_sentence_ratio)) of the n sentences (at most n)
   trade places;
2. text infilling: spans of Poisson(``poisson_lambda``) tokens, chosen until
   round(len * ``mask_ratio``) tokens are covered (at most 100 draws), each span
   replaced by one ``<mask>`` (by a random token with probability
   ``random_ratio``); a span of length 0 inserts one ``<mask>``;
3. random deletion (each token with probability ``delete_ratio``, a lone
   ``<mask>`` if none is left) and insertion of round(len * ``insert_ratio``)
   random tokens.

``DenoisingDataset`` reads one line a sentence; the source is the noised ids,
the target the clean ones, and with ``lang_tag`` (mBART) the tag is appended to
the source and prepended to the target.  Batches collate as a language pair's.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from s2t_tpu_torch.data.dictionary import Dictionary
from s2t_tpu_torch.data.text_dataset import TranslationDataset


def _permute_sentences(core: List[int], rng: np.random.Generator, ratio: float,
                       full_stop_id: int) -> List[int]:
    sents: List[List[int]] = []
    cur: List[int] = []
    for t in core:
        cur.append(int(t))
        if t == full_stop_id:
            sents.append(cur)
            cur = []
    if cur:
        sents.append(cur)
    if len(sents) <= 1:
        return core
    n_perm = min(max(2, int(round(len(sents) * ratio))), len(sents))
    which = rng.choice(len(sents), size=n_perm, replace=False)
    shuffled = rng.permutation(which)
    order = list(range(len(sents)))
    for a, b in zip(which, shuffled):
        order[a] = int(b)
    return [t for i in order for t in sents[i]]


def _infill(core: List[int], rng: np.random.Generator, n_to_mask: int, poisson_lambda: float,
            random_ratio: float, mask_id: int, vocab_size: int) -> List[int]:
    is_masked = np.zeros(len(core), bool)
    starts = []
    budget, guard = n_to_mask, 0
    while budget > 0 and guard < 100:
        guard += 1
        span = int(rng.poisson(poisson_lambda))
        start = int(rng.integers(0, len(core)))
        span = min(span, budget, len(core) - start)
        if span <= 0:  # a pure <mask> insertion at ``start``
            starts.append((start, 0))
            budget -= 1
            continue
        if is_masked[start:start + span].any():
            continue
        is_masked[start:start + span] = True
        starts.append((start, span))
        budget -= span
    insert_at = {s for s, sp in starts if sp == 0}
    span_start = {s for s, sp in starts if sp > 0}
    out: List[int] = []
    for i, tok in enumerate(core):
        if i in insert_at:
            out.append(mask_id)
        if not is_masked[i]:
            out.append(int(tok))
        elif i in span_start:  # a whole span -> one mask, or a random token
            out.append(int(rng.integers(4, vocab_size)) if rng.random() < random_ratio
                       else mask_id)
    return out


def bart_noise(tokens: np.ndarray, rng: np.random.Generator, mask_id: int, vocab_size: int,
               mask_ratio: float = 0.3, poisson_lambda: float = 3.5, random_ratio: float = 0.1,
               insert_ratio: float = 0.0, delete_ratio: float = 0.0,
               permute_sentence_ratio: float = 1.0, full_stop_id: Optional[int] = None,
               eos_id: int = 2) -> np.ndarray:
    """Corrupt ``tokens`` (ending with EOS) BART's way; returns the new ids (int32)."""
    core = list(tokens[:-1])
    if not core:
        return tokens
    if permute_sentence_ratio > 0 and full_stop_id is not None:
        core = _permute_sentences(core, rng, permute_sentence_ratio, full_stop_id)
    n_to_mask = int(round(len(core) * mask_ratio))
    out = (_infill(core, rng, n_to_mask, poisson_lambda, random_ratio, mask_id, vocab_size)
           if n_to_mask > 0 else list(core))
    if delete_ratio > 0:
        out = [t for t in out if rng.random() >= delete_ratio] or [mask_id]
    if insert_ratio > 0:
        for _ in range(int(round(len(out) * insert_ratio))):
            pos = int(rng.integers(0, len(out) + 1))
            out.insert(pos, int(rng.integers(4, vocab_size)))
    return np.asarray(out + [eos_id], dtype=np.int32)


class DenoisingDataset:
    """Lines of raw text; source = the BART-noised ids, target = the clean ids."""

    collater = TranslationDataset.collater  # a language pair's padding and prev tokens

    def __init__(self, path, dictionary: Dictionary, bpe=None, mask_ratio: float = 0.3,
                 poisson_lambda: float = 3.5, random_ratio: float = 0.1,
                 insert_ratio: float = 0.0, delete_ratio: float = 0.0,
                 permute_sentence_ratio: float = 1.0, seed: int = 1,
                 lang_tag: Optional[int] = None, noise: bool = True):
        self.dictionary = dictionary
        self.mask_id = dictionary.index("<mask>")
        self.full_stop_id = dictionary.index(".") if "." in dictionary.indices else None
        self.cfg = dict(mask_ratio=mask_ratio, poisson_lambda=poisson_lambda,
                        random_ratio=random_ratio, insert_ratio=insert_ratio,
                        delete_ratio=delete_ratio, permute_sentence_ratio=permute_sentence_ratio)
        self.seed = seed
        self.epoch = 1
        self.noise = noise
        self.lang_tag = lang_tag
        self.items: List[np.ndarray] = []
        with open(Path(path), encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                if bpe is not None:
                    line = bpe.encode_line(line)
                self.items.append(dictionary.encode_line(line, append_eos=True))
        self.n_frames = np.asarray([len(t) for t in self.items], np.int64)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        clean = self.items[index]
        src = clean
        if self.noise:
            rng = np.random.default_rng((self.seed * 1_000_003 + self.epoch) * 1_000_003 + index)
            src = bart_noise(clean, rng, self.mask_id, len(self.dictionary),
                             full_stop_id=self.full_stop_id, eos_id=self.dictionary.eos(),
                             **self.cfg)
        tgt = clean
        if self.lang_tag is not None:
            src = np.concatenate([src, [self.lang_tag]]).astype(np.int32)
            tgt = np.concatenate([[self.lang_tag], tgt]).astype(np.int32)
        return {"id": index, "source": src, "target": tgt}

    def ordered_indices(self, shuffle: bool = True, seed: int = 1, epoch: int = 1):
        perm = (np.random.default_rng(seed + epoch).permutation(len(self)) if shuffle
                else np.arange(len(self)))
        return perm[np.argsort(self.n_frames[perm], kind="stable")[::-1]]

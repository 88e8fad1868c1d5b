"""Scoring: WER / CER by edit distance, BLEU and chrF (counterpart of
s2t_tpu/utils/scoring.py).

The edit distance is the JAX package's numpy row recurrence (its ctypes
``clib`` fast path is host C++ and waits for a later slice).  sacreBLEU is
imported inside ``BLEUScorer`` and ``ChrFScorer``; ``fast_bleu`` needs the
``clib`` and raises.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from s2t_tpu_torch.registry import SCORERS, register_scorer


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance: the substitution / deletion part of each row is
    vectorised, the insertion prefix dependency is a short loop."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    if m == 0:
        return n
    hyp_arr = np.asarray([hash(h) for h in hyp])
    prev = np.arange(m + 1, dtype=np.int32)
    for i, r in enumerate(ref, 1):
        cur = np.empty(m + 1, dtype=np.int32)
        cur[0] = i
        cur[1:] = np.minimum(prev[1:] + 1, prev[:-1] + (hyp_arr != hash(r)))
        for j in range(1, m + 1):
            if cur[j] > cur[j - 1] + 1:
                cur[j] = cur[j - 1] + 1
        prev = cur
    return int(prev[m])


@register_scorer("wer")
class WERScorer:
    """Word error rate accumulator."""

    def __init__(self, char_level: bool = False):
        self.char_level = char_level
        self.distance = 0
        self.ref_length = 0

    def add(self, ref: str, hyp: str):
        if self.char_level:
            r, h = list(ref.replace(" ", "")), list(hyp.replace(" ", ""))
        else:
            r, h = ref.split(), hyp.split()
        self.distance += edit_distance(r, h)
        self.ref_length += len(r)

    def score(self) -> float:
        return 100.0 * self.distance / max(self.ref_length, 1)

    def result_string(self) -> str:
        return f"WER: {self.score():.2f}"


@register_scorer("cer")
class CERScorer(WERScorer):
    def __init__(self):
        super().__init__(char_level=True)


class _Corpus:
    def __init__(self):
        self.refs: List[str] = []
        self.hyps: List[str] = []

    def add(self, ref: str, hyp: str):
        self.refs.append(ref)
        self.hyps.append(hyp)


@register_scorer("sacrebleu")
@register_scorer("bleu")
class BLEUScorer(_Corpus):
    """Corpus BLEU through sacreBLEU."""

    def __init__(self, tokenize: str = "13a", lowercase: bool = False):
        super().__init__()
        self.tokenize = tokenize
        self.lowercase = lowercase

    def _bleu(self):
        import sacrebleu

        return sacrebleu.corpus_bleu(self.hyps, [self.refs], tokenize=self.tokenize,
                                     lowercase=self.lowercase)

    def score(self) -> float:
        return self._bleu().score if self.hyps else 0.0

    def result_string(self) -> str:
        return str(self._bleu()) if self.hyps else "BLEU: 0.0"


@register_scorer("chrf")
class ChrFScorer(_Corpus):
    """chrF: character n-gram F-score through sacreBLEU."""

    def __init__(self, char_order: int = 6, beta: float = 2.0):
        super().__init__()
        self.char_order = char_order
        self.beta = beta

    def score(self) -> float:
        import sacrebleu

        if not self.hyps:
            return 0.0
        return sacrebleu.corpus_chrf(self.hyps, [self.refs], char_order=self.char_order,
                                     beta=self.beta).score

    def result_string(self) -> str:
        return f"chrF{self.beta:g} = {self.score():.2f}"


def build_scorer(name: str):
    if name == "fast_bleu":
        raise NotImplementedError("scorer 'fast_bleu' needs the JAX package's native clib, "
                                  "which is not ported to s2t_tpu_torch")
    return SCORERS.get(name)()

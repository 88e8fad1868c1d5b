"""ARPA-format n-gram language model: load, save, train, score, n-best fusion
(the port's own copy of s2t_tpu/data/ngram_lm.py:1-200, which is plain Python).

A backoff ARPA reader and scorer and a Katz-backoff trainer (absolute
discounting), so a recipe can build a small word or character LM with no
external tool.  Scoring runs on the host: ``rescore_nbest`` re-ranks a decoded
n-best list, as the reference's ctcdecode + kenlm did on the host.

Probabilities are log10 in the ARPA convention; ``score`` returns the natural
log, to compose with the decoders' log-prob scores.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

LOG10 = math.log(10.0)
BOS, EOS, UNK = "<s>", "</s>", "<unk>"


class ArpaLM:
    """Backoff n-gram LM over whitespace tokens."""

    def __init__(self, order: int = 0):
        self.order = order
        # ngrams[n][tuple words] = (log10 prob, log10 backoff)
        self.ngrams: List[Dict[Tuple[str, ...], Tuple[float, float]]] = [
            {} for _ in range(order + 1)
        ]

    # ------------------------------------------------------------- loading
    @classmethod
    def load(cls, path: str | Path) -> "ArpaLM":
        lm = cls()
        section = 0
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line == "\\data\\":
                    continue
                if line.startswith("ngram "):
                    n = int(line.split()[1].split("=")[0])
                    lm.order = max(lm.order, n)
                    while len(lm.ngrams) <= lm.order:
                        lm.ngrams.append({})
                    continue
                if line.endswith("-grams:"):
                    section = int(line[1:].split("-")[0])
                    continue
                if line == "\\end\\":
                    break
                if section:
                    parts = line.split("\t") if "\t" in line else line.split()
                    logp = float(parts[0])
                    if "\t" in line:
                        words = tuple(parts[1].split())
                        bow = float(parts[2]) if len(parts) > 2 else 0.0
                    else:
                        # space-separated fallback
                        has_bow = len(parts) == section + 2
                        words = tuple(parts[1 : 1 + section])
                        bow = float(parts[-1]) if has_bow else 0.0
                    lm.ngrams[section][words] = (logp, bow)
        return lm

    def save(self, path: str | Path):
        with open(path, "w", encoding="utf-8") as f:
            f.write("\\data\\\n")
            for n in range(1, self.order + 1):
                f.write(f"ngram {n}={len(self.ngrams[n])}\n")
            for n in range(1, self.order + 1):
                f.write(f"\n\\{n}-grams:\n")
                for words, (logp, bow) in sorted(self.ngrams[n].items()):
                    tail = f"\t{bow:.6f}" if (n < self.order and bow != 0.0) else ""
                    f.write(f"{logp:.6f}\t{' '.join(words)}{tail}\n")
            f.write("\n\\end\\\n")

    # ------------------------------------------------------------- scoring
    def logprob10(self, context: Tuple[str, ...], word: str) -> float:
        """log10 p(word | context) with standard backoff recursion."""
        context = tuple(context[-(self.order - 1):]) if self.order > 1 else ()
        while True:
            entry = self.ngrams[len(context) + 1].get(context + (word,))
            if entry is not None:
                return entry[0]
            if not context:
                unk = self.ngrams[1].get((UNK,))
                return unk[0] if unk else -99.0
            hold = self.ngrams[len(context)].get(context)
            bow = hold[1] if hold else 0.0
            context = context[1:]
            if bow:
                return bow + self.logprob10(context, word)

    def score(self, words: Sequence[str], bos: bool = True,
              eos: bool = True) -> float:
        """Natural-log probability of the sentence."""
        seq = ([BOS] if bos else []) + list(words) + ([EOS] if eos else [])
        start = 1 if bos else 0
        total = 0.0
        for i in range(start, len(seq)):
            total += self.logprob10(tuple(seq[max(0, i - self.order + 1):i]),
                                    seq[i])
        return total * LOG10


def train_ngram_lm(
    lines: Iterable[str], order: int = 3, discount: float = 0.5
) -> ArpaLM:
    """Katz-backoff LM with absolute discounting (a lightweight stand-in for
    kenlm's lmplz; exact smoothing differs, API and format match)."""
    counts = [Counter() for _ in range(order + 1)]
    for line in lines:
        toks = [BOS] + line.split() + [EOS]
        for n in range(1, order + 1):
            for i in range(len(toks) - n + 1):
                g = tuple(toks[i : i + n])
                if n == 1 and g == (BOS,):
                    continue  # ARPA convention: <s> has no unigram prob
                counts[n][g] += 1
    # context totals
    ctx_tot = [defaultdict(int) for _ in range(order + 1)]
    for n in range(2, order + 1):
        for g, c in counts[n].items():
            ctx_tot[n][g[:-1]] += c
    uni_total = sum(counts[1].values())

    lm = ArpaLM(order)
    # unigrams: reserve discounted mass for <unk>
    n_types = len(counts[1])
    unk_mass = discount * n_types / max(uni_total, 1)
    for g, c in counts[1].items():
        p = max(c - discount, 1e-12) / uni_total
        lm.ngrams[1][g] = (math.log10(p), 0.0)
    lm.ngrams[1][(UNK,)] = (math.log10(max(unk_mass, 1e-12)), 0.0)
    lm.ngrams[1][(BOS,)] = (-99.0, 0.0)  # placeholder prob, carries backoff

    for n in range(2, order + 1):
        for g, c in counts[n].items():
            tot = ctx_tot[n][g[:-1]]
            p = max(c - discount, 1e-12) / tot
            lm.ngrams[n][g] = (math.log10(p), 0.0)

    # backoff weights: bow(h) = leftover mass / leftover lower-order mass
    for n in range(1, order):
        by_ctx: Dict[Tuple[str, ...], List[Tuple[str, ...]]] = defaultdict(list)
        for g in counts[n + 1]:
            by_ctx[g[:-1]].append(g)
        for h, seen in by_ctx.items():
            num = 1.0 - sum(10 ** lm.ngrams[n + 1][g][0] for g in seen)
            # lower-order gram for h=(w1..wn), w  is  (w2..wn, w) == g[1:]
            den = 1.0 - sum(
                10 ** lm.ngrams[n].get(g[1:], (-99.0, 0.0))[0] for g in seen
            )
            num = max(num, 1e-12)
            den = max(den, 1e-12)
            logp, _ = lm.ngrams[n].get(h, (-99.0, 0.0))
            lm.ngrams[n][h] = (logp, math.log10(num / den))
    return lm


def rescore_nbest(
    tokens: np.ndarray,  # (B, K, T) token ids, pad after end
    scores: np.ndarray,  # (B, K) decoder/CTC scores (natural log domain)
    dictionary,
    lm: ArpaLM,
    lm_weight: float = 0.5,
    word_bonus: float = 0.0,
    pad_id: int = 1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Shallow n-gram fusion over a decoded n-best list:
    score' = score + lm_weight * ln p_LM(words) + word_bonus * |words|
    (the kenlm alpha/beta convention).  Returns re-sorted (tokens, scores')."""
    tokens = np.asarray(tokens)
    scores = np.asarray(scores).astype(np.float64)
    B, K, T = tokens.shape
    fused = np.full((B, K), -np.inf)
    for b in range(B):
        for k_i in range(K):
            ids = [int(t) for t in tokens[b, k_i] if t != pad_id]
            text = dictionary.string(ids)
            words = text.split()
            lm_s = lm.score(words) if words else 0.0
            fused[b, k_i] = (
                scores[b, k_i] + lm_weight * lm_s + word_bonus * len(words)
            )
    order = np.argsort(-fused, axis=1)
    new_tokens = np.take_along_axis(tokens, order[..., None], axis=1)
    new_scores = np.take_along_axis(fused, order, axis=1)
    return new_tokens, new_scores.astype(np.float32)

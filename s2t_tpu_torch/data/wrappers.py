"""Dataset wrappers: word noising, token-level transforms, LM context windows,
corpus subsampling and per-epoch resampling (counterpart of
s2t_tpu/data/wrappers.py, whole).

Host-side numpy, as in the JAX package: every draw is a numpy generator of the
JAX module's own seed ((seed, epoch, index) for the per-sample noise, seed +
epoch for the per-epoch deals), so each wrapper yields the JAX arrays exactly.
Samples are dicts with "id" and 1-D int "source" (optionally "target") arrays;
padding and bucketing happen in the base dataset's collater.

``NoisingDataset`` is the denoising stream of ``semisupervised_translation``
(shuffle -> word dropout -> word blanking, whole BPE words);
``LMContextWindowDataset`` prefixes each LM block with the tail of the previous
one as unscored context; ``MultiCorpusSampledDataset`` draws a corpus per index.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np


# --------------------------------------------------------------------- #
# word-level noising (reference: fairseq/data/noising.py)
# --------------------------------------------------------------------- #
class WordNoiser:
    """Whole-word shuffle / dropout / blanking over BPE token sequences.

    Word grouping: a token ends a word unless it carries the BPE
    continuation marker (reference WordNoising._get_bpe_word_idx — "y@@",
    "ou" belong to one word; with no marker every token is a word).
    """

    def __init__(self, dictionary, bpe_cont_marker: Optional[str] = "@@",
                 bpe_end_marker: Optional[str] = None):
        self.dictionary = dictionary
        if bpe_cont_marker:
            bpe_end = np.array([
                not dictionary[i].endswith(bpe_cont_marker)
                for i in range(len(dictionary))
            ])
        elif bpe_end_marker:
            bpe_end = np.array([
                dictionary[i].endswith(bpe_end_marker)
                for i in range(len(dictionary))
            ])
        else:
            bpe_end = None
        self.bpe_end = bpe_end

    def word_ids(self, tokens: np.ndarray) -> np.ndarray:
        """Token index -> word index (reference _get_bpe_word_idx: reverse
        cumsum of word-end flags)."""
        if self.bpe_end is None:
            return np.arange(len(tokens))
        end = self.bpe_end[tokens]
        rev = end[::-1].cumsum()[::-1]
        return rev.max() - rev

    def shuffle(self, tokens: np.ndarray, max_distance: int,
                rng: np.random.Generator) -> np.ndarray:
        """Move whole words by at most ``max_distance`` positions
        (reference WordShuffle.noising: argsort of word_idx + U[0, k),
        eos pinned at the end, tie-break keeps within-word order)."""
        if max_distance <= 1:
            return tokens
        eos = self.dictionary.eos()
        n = len(tokens)
        n_noeos = n - 1 if n and tokens[-1] == eos else n
        if n_noeos <= 1:
            return tokens
        widx = self.word_ids(tokens[:n_noeos])
        noise = rng.uniform(0, max_distance, size=int(widx.max()) + 1)
        noise[0] = -1  # never move the first word
        scores = widx + noise[widx] + 1e-6 * np.arange(n_noeos)
        out = tokens.copy()
        out[:n_noeos] = tokens[:n_noeos][np.argsort(scores, kind="stable")]
        return out

    def dropout(self, tokens: np.ndarray, prob: float,
                rng: np.random.Generator,
                blank_idx: Optional[int] = None) -> np.ndarray:
        """Drop (or blank) whole words with probability ``prob``; eos is
        always kept, and at least one non-eos token survives (reference
        WordDropout.noising: re-inserts a random word when everything was
        dropped)."""
        if prob <= 0:
            return tokens
        eos = self.dictionary.eos()
        n = len(tokens)
        has_eos = bool(n) and tokens[-1] == eos
        body = tokens[:-1] if has_eos else tokens
        if len(body) == 0:
            return tokens
        widx = self.word_ids(body)
        keep_words = rng.random(int(widx.max()) + 1) >= prob
        keep = keep_words[widx]
        if blank_idx is not None:
            body = np.where(keep, body, blank_idx)
        else:
            body = body[keep]
        if len(body) == 0:
            body = np.array([tokens[rng.integers(0, n)]], tokens.dtype)
        return np.concatenate([body, tokens[-1:]]) if has_eos else body

    def unsupervised_mt(self, tokens: np.ndarray,
                        rng: np.random.Generator,
                        max_word_shuffle_distance: float = 3,
                        word_dropout_prob: float = 0.1,
                        word_blanking_prob: float = 0.1) -> np.ndarray:
        """shuffle → dropout → blank-with-unk (reference
        UnsupervisedMTNoising.noising order)."""
        x = self.shuffle(tokens, int(max_word_shuffle_distance), rng)
        x = self.dropout(x, word_dropout_prob, rng)
        x = self.dropout(x, word_blanking_prob, rng,
                         blank_idx=self.dictionary.unk())
        return x


class BaseWrapperDataset:
    """Delegates everything to the wrapped dataset; subclasses override
    __getitem__ (reference: base_wrapper_dataset.py)."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, index):
        return self.dataset[index]

    @property
    def n_frames(self):
        return self.dataset.n_frames

    def collater(self, samples, **kw):
        return self.dataset.collater(samples, **kw)

    def ordered_indices(self, shuffle: bool = True, seed: int = 1,
                        epoch: int = 1):
        return self.dataset.ordered_indices(shuffle=shuffle, seed=seed,
                                            epoch=epoch)

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)


class NoisingDataset(BaseWrapperDataset):
    """Apply UnsupervisedMT noise to "source" (reference: noising.py:253
    NoisingDataset; used by semisupervised translation/DAE)."""

    def __init__(self, dataset, dictionary, seed: int = 1,
                 max_word_shuffle_distance: float = 3,
                 word_dropout_prob: float = 0.1,
                 word_blanking_prob: float = 0.1,
                 bpe_cont_marker: Optional[str] = "@@"):
        super().__init__(dataset)
        self.noiser = WordNoiser(dictionary, bpe_cont_marker)
        self.seed = seed
        self.epoch = 1
        self.kw = dict(
            max_word_shuffle_distance=max_word_shuffle_distance,
            word_dropout_prob=word_dropout_prob,
            word_blanking_prob=word_blanking_prob,
        )

    def __getitem__(self, index):
        item = dict(self.dataset[index])
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + self.epoch) * 1_000_003 + index
        )
        item["source"] = self.noiser.unsupervised_mt(
            np.asarray(item["source"]), rng, **self.kw
        )
        return item


# --------------------------------------------------------------------- #
# token-level transforms
# --------------------------------------------------------------------- #
class _FieldTransform(BaseWrapperDataset):
    field = "source"

    def __init__(self, dataset, field: str = "source"):
        super().__init__(dataset)
        self.field = field

    def _apply(self, tokens: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def __getitem__(self, index):
        item = dict(self.dataset[index])
        item[self.field] = self._apply(np.asarray(item[self.field]))
        return item


class TruncateDataset(_FieldTransform):
    """Keep the first ``max_len`` tokens (reference: shorten_dataset.py
    TruncateDataset)."""

    def __init__(self, dataset, max_len: int, field: str = "source"):
        super().__init__(dataset, field)
        self.max_len = max_len

    def _apply(self, t):
        return t[: self.max_len]


class RandomCropDataset(_FieldTransform):
    """Random contiguous crop to ``max_len`` per epoch (reference:
    shorten_dataset.py RandomCropDataset)."""

    def __init__(self, dataset, max_len: int, seed: int = 1,
                 field: str = "source"):
        super().__init__(dataset, field)
        self.max_len = max_len
        self.seed = seed
        self.epoch = 1
        self._index = 0

    def __getitem__(self, index):
        item = dict(self.dataset[index])
        t = np.asarray(item[self.field])
        if len(t) > self.max_len:
            rng = np.random.default_rng(
                (self.seed * 1_000_003 + self.epoch) * 1_000_003 + index
            )
            start = int(rng.integers(0, len(t) - self.max_len + 1))
            t = t[start: start + self.max_len]
        item[self.field] = t
        return item


class AppendTokenDataset(_FieldTransform):
    def __init__(self, dataset, token: int, field: str = "source"):
        super().__init__(dataset, field)
        self.token = token

    def _apply(self, t):
        return np.concatenate([t, np.array([self.token], t.dtype)])


class PrependTokenDataset(_FieldTransform):
    def __init__(self, dataset, token: int, field: str = "source"):
        super().__init__(dataset, field)
        self.token = token

    def _apply(self, t):
        return np.concatenate([np.array([self.token], t.dtype), t])


class StripTokenDataset(_FieldTransform):
    """Remove every occurrence of ``token`` (reference:
    strip_token_dataset.py — strips eos before re-wrapping)."""

    def __init__(self, dataset, token: int, field: str = "source"):
        super().__init__(dataset, field)
        self.token = token

    def _apply(self, t):
        return t[t != self.token]


class OffsetTokensDataset(_FieldTransform):
    def __init__(self, dataset, offset: int, field: str = "source"):
        super().__init__(dataset, field)
        self.offset = offset

    def _apply(self, t):
        return t + self.offset


class ReplaceDataset(_FieldTransform):
    """Replace token ids via a mapping (reference: replace_dataset.py)."""

    def __init__(self, dataset, replace_map: Dict[int, int],
                 field: str = "source"):
        super().__init__(dataset, field)
        self.replace_map = dict(replace_map)

    def _apply(self, t):
        out = t.copy()
        for old, new in self.replace_map.items():
            out[t == old] = new
        return out


class RollDataset(_FieldTransform):
    def __init__(self, dataset, shift: int, field: str = "source"):
        super().__init__(dataset, field)
        self.shift = shift

    def _apply(self, t):
        return np.roll(t, self.shift)


class TransformEosLangPairDataset(BaseWrapperDataset):
    """mBART-style eos handling: replace source eos with a language id and
    seed the decoder with the target language id (reference:
    transform_eos_lang_pair_dataset.py — used by translation_from_
    pretrained_bart)."""

    def __init__(self, dataset, src_eos: int,
                 new_src_eos: Optional[int] = None,
                 tgt_bos: Optional[int] = None,
                 new_tgt_bos: Optional[int] = None):
        super().__init__(dataset)
        self.src_eos = src_eos
        self.new_src_eos = new_src_eos
        self.tgt_bos = tgt_bos
        self.new_tgt_bos = new_tgt_bos

    def __getitem__(self, index):
        item = dict(self.dataset[index])
        if self.new_src_eos is not None:
            src = np.asarray(item["source"]).copy()
            if len(src) and src[-1] == self.src_eos:
                src[-1] = self.new_src_eos
            item["source"] = src
        if self.new_tgt_bos is not None and "target" in item:
            item["tgt_lang_tag"] = self.new_tgt_bos
        return item


class LMContextWindowDataset(BaseWrapperDataset):
    """Prefix each LM block with the tail of the PREVIOUS block as unscored
    context (reference: data/lm_context_window_dataset.py + eval_lm
    --context-window: perplexity improves because block boundaries no
    longer truncate the history).  Context positions score as pad in
    ``target``; the model still attends to them through ``prev_tokens``."""

    def __init__(self, dataset, context_window: int, pad_id: int = 1,
                 eos_id: int = 2):
        super().__init__(dataset)
        assert context_window > 0
        self.cw = context_window
        self.pad_id = pad_id
        self.eos_id = eos_id

    def __getitem__(self, index):
        item = dict(self.dataset[index])
        toks = np.asarray(item["tokens"])
        if index > 0:
            prev_blk = np.asarray(self.dataset[index - 1]["tokens"])
            ctx = prev_blk[-self.cw:]
        else:
            ctx = np.full((self.cw,), self.pad_id, toks.dtype)
        item["context"] = ctx
        return item

    def collater(self, samples, batch_multiple: int = 1, pad_id: int = None,
                 eos_id: int = None, **kw):
        pad_id = self.pad_id if pad_id is None else pad_id
        eos_id = self.eos_id if eos_id is None else eos_id
        B = len(samples)
        L = samples[0]["tokens"].shape[0]
        W = self.cw
        full = np.full((B, W + L), pad_id, dtype=np.int32)
        target = np.full((B, W + L), pad_id, dtype=np.int32)
        for i, s in enumerate(samples):
            full[i, :W] = s["context"]
            full[i, W:] = s["tokens"]
            target[i, W:] = s["tokens"]  # only the block is scored
        prev = np.roll(full, 1, axis=1)
        prev[:, 0] = eos_id
        return {
            "prev_tokens": prev,
            "target": target,
            "target_lengths": np.full((B,), L, np.int32),
            "ntokens": float(L * B),
            "ids": np.asarray([s["id"] for s in samples]),
            "nsentences": B,
        }


# --------------------------------------------------------------------- #
# corpus-level sampling
# --------------------------------------------------------------------- #
class SubsampleDataset(BaseWrapperDataset):
    """Fixed random fraction of the base dataset (reference:
    subsample_dataset.py)."""

    def __init__(self, dataset, size_ratio: float, seed: int = 1):
        super().__init__(dataset)
        assert 0 < size_ratio <= 1
        n = max(int(len(dataset) * size_ratio), 1)
        rng = np.random.default_rng(seed)
        self.indices = np.sort(rng.choice(len(dataset), n, replace=False))

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, index):
        item = dict(self.dataset[int(self.indices[index])])
        item["id"] = index
        return item

    @property
    def n_frames(self):
        return self.dataset.n_frames[self.indices]

    def ordered_indices(self, shuffle=True, seed=1, epoch=1):
        order = np.arange(len(self))
        if shuffle:
            order = np.random.default_rng(seed + epoch).permutation(order)
        return order[np.argsort(self.n_frames[order], kind="stable")[::-1]]


class ResamplingDataset(BaseWrapperDataset):
    """Per-epoch weighted resample with replacement (reference:
    resampling_dataset.py — multilingual temperature sampling upstream of
    concat)."""

    def __init__(self, dataset, weights: Optional[Sequence[float]] = None,
                 size_ratio: float = 1.0, seed: int = 1):
        super().__init__(dataset)
        self.weights = None if weights is None else (
            np.asarray(weights, np.float64) / np.sum(weights)
        )
        self.size = max(int(len(dataset) * size_ratio), 1)
        self.seed = seed
        self.epoch = 1
        self._deal()

    def _deal(self):
        rng = np.random.default_rng(self.seed + self.epoch)
        self.indices = rng.choice(
            len(self.dataset), self.size, replace=True, p=self.weights
        )

    def set_epoch(self, epoch: int):
        super().set_epoch(epoch)
        self._deal()

    def __len__(self):
        return self.size

    def __getitem__(self, index):
        item = dict(self.dataset[int(self.indices[index])])
        item["id"] = index
        return item

    @property
    def n_frames(self):
        return self.dataset.n_frames[self.indices]

    def ordered_indices(self, shuffle=True, seed=1, epoch=1):
        order = np.arange(len(self))
        if shuffle:
            order = np.random.default_rng(seed + epoch).permutation(order)
        return order[np.argsort(self.n_frames[order], kind="stable")[::-1]]


class MultiCorpusSampledDataset(BaseWrapperDataset):
    """Per-index corpus choice by a sampling function; len = max corpus len
    (reference: multi_corpus_sampled_dataset.py — each index draws a corpus
    via ``sampling_func`` then maps the index modulo that corpus size)."""

    def __init__(self, datasets: Dict[str, Any],
                 sampling_func: Optional[Callable[[List[str]], int]] = None,
                 seed: int = 1):
        assert datasets, "no datasets"
        self.datasets = dict(datasets)
        self.keys = list(self.datasets)
        self.sampling_func = sampling_func
        self.seed = seed
        self.epoch = 1

    def __len__(self):
        return max(len(d) for d in self.datasets.values())

    def _pick(self, index: int) -> str:
        if self.sampling_func is not None:
            return self.keys[self.sampling_func(self.keys)]
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + self.epoch) * 1_000_003 + index
        )
        return self.keys[int(rng.integers(0, len(self.keys)))]

    def __getitem__(self, index):
        key = self._pick(index)
        ds = self.datasets[key]
        item = dict(ds[index % len(ds)])
        item["id"] = index
        return item

    @property
    def n_frames(self):
        # cost upper bound per index (corpus choice is per-epoch random)
        n = len(self)
        out = np.zeros(n, np.int64)
        for d in self.datasets.values():
            out = np.maximum(out, d.n_frames[np.arange(n) % len(d)])
        return out

    def collater(self, samples, **kw):
        return self.datasets[self.keys[0]].collater(samples, **kw)

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        for d in self.datasets.values():
            if hasattr(d, "set_epoch"):
                d.set_epoch(epoch)

    def ordered_indices(self, shuffle=True, seed=1, epoch=1):
        order = np.arange(len(self))
        if shuffle:
            order = np.random.default_rng(seed + epoch).permutation(order)
        nf = self.n_frames
        return order[np.argsort(nf[order], kind="stable")[::-1]]

"""Multilingual datasets (counterpart of s2t_tpu/data/multilingual.py).

``MultilingualS2TDataset``: comma-separated per-language splits are concatenated
and, in training, upsampled per epoch by the reference's size ratios: with
temperature alpha, ratio_l = (p_l^alpha / sum p^alpha) / p_l where p_l = n_l / N,
so the low-resource languages are seen more often as alpha -> 0.

``RoundRobinZipDataset`` (:17-85): the per-pair datasets of the multilingual
Transformer zipped, one row carrying one item of every pair (the shorter pairs
wrap), so one batch is ``{"pairs": {pair: sub-batch}}`` and one update trains every
pair.  A row's cost is the sum of its items' costs (all pairs ride in the same
step), recomputed whenever ``ordered_indices`` deals the pairs a new order.

The draws are numpy's, seeded as in JAX, so the batches equal JAX's index for index.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np


class RoundRobinZipDataset:
    def __init__(self, datasets: Dict[str, Any]):
        if not datasets:
            raise ValueError("RoundRobinZipDataset needs at least one dataset")
        self.datasets = dict(datasets)
        self.longest_key = max(self.datasets, key=lambda k: len(self.datasets[k]))
        self._orders = {k: np.arange(len(d)) for k, d in self.datasets.items()}
        self._recompute_frames()

    def _recompute_frames(self) -> None:
        rows = np.arange(len(self))
        total = np.zeros(len(self), dtype=np.int64)
        for k, d in self.datasets.items():
            order = self._orders[k]
            total += d.n_frames[order[rows % len(order)]]
        self.n_frames = total

    def __len__(self):
        return len(self.datasets[self.longest_key])

    def __getitem__(self, index: int) -> Dict[str, Any]:
        return {k: d[int(self._orders[k][index % len(self._orders[k])])]
                for k, d in self.datasets.items()}

    def collater(self, samples, **kw):
        if not samples:
            return None
        pairs = {k: d.collater([s[k] for s in samples], **kw) for k, d in self.datasets.items()}
        return {"pairs": pairs,
                "ntokens": sum(b["ntokens"] for b in pairs.values() if "ntokens" in b)}

    def set_epoch(self, epoch: int) -> None:
        for d in self.datasets.values():
            if hasattr(d, "set_epoch"):
                d.set_epoch(epoch)

    def ordered_indices(self, shuffle: bool = True, seed: int = 1, epoch: int = 1) -> np.ndarray:
        """Deal each pair a fresh order (one generator, pair after pair, as JAX draws),
        then sort the rows by their total cost, longest first by a stable sort."""
        rng = np.random.default_rng(seed + epoch)
        for k, d in self.datasets.items():
            base = np.arange(len(d))
            self._orders[k] = rng.permutation(base) if shuffle else base
        self._recompute_frames()
        order = np.arange(len(self))
        if shuffle:
            order = rng.permutation(order)
        return order[np.argsort(self.n_frames[order], kind="stable")[::-1]]


def get_size_ratios(sizes: Sequence[int], alpha: float = 1.0) -> np.ndarray:
    """Per-dataset upsampling ratios (fairseq's ``_get_size_ratios``)."""
    sizes = np.asarray(sizes, np.float64)
    probs = sizes / sizes.sum()
    smoothed = probs ** alpha
    smoothed = smoothed / smoothed.sum()
    return smoothed / probs


class MultilingualS2TDataset:
    """Per-language ``SpeechToTextDataset``s end to end; ``ordered_indices``
    upsamples them by their ratios when ``resample`` (the train split) and
    alpha != 1."""

    def __init__(self, datasets: List[Any], alpha: float = 1.0, resample: bool = True):
        if not datasets:
            raise ValueError("MultilingualS2TDataset needs at least one dataset")
        self.datasets = datasets
        self.alpha = alpha
        self.resample = resample and len(datasets) > 1 and alpha != 1.0
        self.offsets = np.cumsum([0] + [len(d) for d in datasets])
        self.n_frames = np.concatenate([d.n_frames for d in datasets])
        self.ratios = (get_size_ratios([len(d) for d in datasets], alpha) if self.resample
                       else np.ones(len(datasets)))

    def __len__(self):
        return int(self.offsets[-1])

    def _route(self, index: int):
        d = int(np.searchsorted(self.offsets, index, side="right") - 1)
        return self.datasets[d], index - int(self.offsets[d])

    def __getitem__(self, index: int) -> Dict[str, Any]:
        ds, local = self._route(index)
        item = dict(ds[local])
        item["id"] = index  # the global id
        return item

    def collater(self, samples, **kw):
        return self.datasets[0].collater(samples, **kw)

    def set_epoch(self, epoch: int) -> None:
        for ds in self.datasets:
            if hasattr(ds, "set_epoch"):
                ds.set_epoch(epoch)

    def ordered_indices(self, shuffle: bool = True, seed: int = 1, epoch: int = 1) -> np.ndarray:
        """Global indices, dataset d contributing int(ratio_d * len(d)) of them this
        epoch, sorted longest first by a stable sort (multilingual.py:131-156)."""
        rng = np.random.default_rng(seed + epoch)
        parts = []
        for d, ds in enumerate(self.datasets):
            n = len(ds)
            n_take = int(n * float(self.ratios[d]))
            base = np.arange(n) + self.offsets[d]
            if n_take <= n:
                idx = (rng.choice(base, size=max(n_take, 1), replace=False) if shuffle
                       else base[:max(n_take, 1)])
            else:
                reps = np.concatenate([base] * (n_take // n))
                idx = np.concatenate([reps, rng.choice(base, size=n_take % n, replace=False)])
            parts.append(idx)
        order = np.concatenate(parts)
        if shuffle:
            order = rng.permutation(order)
        return order[np.argsort(self.n_frames[order], kind="stable")[::-1]]

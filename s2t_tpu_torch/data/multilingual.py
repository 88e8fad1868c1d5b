"""Multilingual speech datasets with temperature resampling (counterpart of
s2t_tpu/data/multilingual.py:84-156).

Comma-separated per-language splits are concatenated and, in training,
upsampled per epoch by the reference's size ratios: with temperature alpha,
ratio_l = (p_l^alpha / sum p^alpha) / p_l where p_l = n_l / N, so the
low-resource languages are seen more often as alpha -> 0.  The draws are
numpy's, seeded as in JAX, so the batches equal JAX's index for index.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np


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

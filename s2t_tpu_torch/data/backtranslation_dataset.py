"""Backtranslation: synthetic-parallel pairs from monolingual target text
(counterpart of s2t_tpu/data/backtranslation_dataset.py:25-165).

``BacktranslationDataset`` holds monolingual TARGET sentences; its collater pads a
batch of them (the width snapped to the token buckets, so the reverse model's beam
and the train step see few shapes) and asks ``backtranslation_fn(target,
target_lengths)`` for the synthetic SOURCES.  ``make_backtranslator`` builds that
function over a reverse (tgt -> src) model and its ``SequenceGenerator``: the batch
goes to the model's device, the beam runs in eval mode without gradients (every
encoder self-attention through the fused kernel on the card), and the best
hypothesis of each row comes back to the host.

``ConcatHomogeneous`` concatenates datasets whose batches differ (bitext,
backtranslation, denoising) so that batches stay single-origin: each dataset's
indices are one contiguous run of the order, and the one boundary batch between two
runs keeps only its majority origin (the minority samples are dropped, as in JAX).
"""

from __future__ import annotations

from typing import Any, Callable, List

import numpy as np
import torch

from s2t_tpu_torch.data.batching import bucketize, collate_targets, round_up
from s2t_tpu_torch.data.dictionary import Dictionary


class BacktranslationDataset:
    """Monolingual target text -> (synthetic source, real target) batches."""

    def __init__(self, tgt_lines_or_path, tgt_dict: Dictionary,
                 backtranslation_fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
                 tgt_bpe=None, max_len: int = 256):
        self.tgt_dict = tgt_dict
        self.backtranslation_fn = backtranslation_fn
        if isinstance(tgt_lines_or_path, (list, tuple)):
            lines = list(tgt_lines_or_path)
        else:
            with open(tgt_lines_or_path, encoding="utf-8") as f:
                lines = [line.rstrip("\n") for line in f if line.strip()]
        self.targets: List[np.ndarray] = []
        for line in lines:
            if tgt_bpe is not None:
                line = tgt_bpe.encode_line(line)
            self.targets.append(tgt_dict.encode_line(line, append_eos=True)[:max_len])
        self.n_frames = np.asarray([len(t) for t in self.targets], np.int64)

    def __len__(self):
        return len(self.targets)

    def __getitem__(self, index):
        return {"id": index, "target": self.targets[index]}

    def ordered_indices(self, shuffle=True, seed=1, epoch=1):
        perm = (np.random.default_rng(seed + epoch).permutation(len(self)) if shuffle
                else np.arange(len(self)))
        return perm[np.argsort(self.n_frames[perm], kind="stable")[::-1]]

    def collater(self, samples, frame_buckets=None, token_buckets=None, batch_multiple=1,
                 pad_id=1, eos_id=2, **kw):
        B_real = len(samples)
        B = round_up(B_real, batch_multiple)
        U = max(len(s["target"]) for s in samples)
        if token_buckets is not None:
            U = int(bucketize(np.asarray([U]), token_buckets)[0])
        target, prev, tgt_lengths = collate_targets([s["target"] for s in samples], B, U,
                                                    pad_id, eos_id)
        src = np.asarray(self.backtranslation_fn(target, tgt_lengths), np.int32)
        return {
            "src_tokens": src,
            "src_lengths": np.sum((src != pad_id).astype(np.int32), axis=1),
            "target": target,
            "prev_tokens": prev,
            "target_lengths": tgt_lengths,
            "ntokens": float(tgt_lengths.sum()),
            "ids": np.asarray([s["id"] for s in samples] + [-1] * (B - B_real)),
            "nsentences": B_real,
        }


class ConcatHomogeneous:
    """Datasets end to end, every batch of one origin (see the module docstring)."""

    def __init__(self, datasets: List[Any]):
        if not datasets:
            raise ValueError("ConcatHomogeneous needs at least one dataset")
        self.datasets = datasets
        self.offsets = np.cumsum([0] + [len(d) for d in datasets])
        self.n_frames = np.concatenate([d.n_frames for d in datasets])

    def __len__(self):
        return int(self.offsets[-1])

    def _route(self, index: int):
        d = int(np.searchsorted(self.offsets, index, side="right") - 1)
        return d, index - int(self.offsets[d])

    def __getitem__(self, index: int):
        d, local = self._route(index)
        item = dict(self.datasets[d][local])
        item["id"] = index
        item["_origin"] = d
        return item

    def set_epoch(self, epoch: int):
        for d in self.datasets:
            if hasattr(d, "set_epoch"):
                d.set_epoch(epoch)

    def ordered_indices(self, shuffle: bool = True, seed: int = 1, epoch: int = 1):
        return np.concatenate([
            np.asarray(ds.ordered_indices(shuffle=shuffle, seed=seed, epoch=epoch))
            + self.offsets[d] for d, ds in enumerate(self.datasets)])

    def collater(self, samples, **kw):
        origins = [s["_origin"] for s in samples]
        counts = {o: origins.count(o) for o in set(origins)}
        major = max(counts, key=counts.get)
        batch = self.datasets[major].collater(
            [s for s in samples if s["_origin"] == major], **kw)
        batch["origin"] = major
        return batch


def make_backtranslator(reverse_model, generator) -> Callable:
    """``(tgt_tokens (B, U), tgt_lengths (B,)) -> (B, L)`` synthetic sources: the best
    beam of ``generator`` (a ``SequenceGenerator`` over ``reverse_model`` with
    ``input_keys=("src_tokens", "src_lengths")``) on the model's device."""

    def fn(tgt_tokens: np.ndarray, tgt_lengths: np.ndarray) -> np.ndarray:
        dev = next(reverse_model.parameters()).device
        reverse_model.eval()
        with torch.no_grad():
            tokens, _scores, _enc = generator.generate({
                "src_tokens": torch.as_tensor(np.asarray(tgt_tokens), device=dev),
                "src_lengths": torch.as_tensor(np.asarray(tgt_lengths), device=dev)})
        return tokens[:, 0].cpu().numpy()

    return fn

"""Epoch batch iterators: checkpointable position, per-epoch shuffle,
background prefetch (counterpart of s2t_tpu/data/iterators.py, all of it:
``CountingIterator``, ``BufferedIterator``, ``EpochBatchIterator`` with
``state_dict`` / ``load_state_dict`` / ``rewind``).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, List, Optional

import numpy as np


class CountingIterator:
    def __init__(self, iterable, start: int = 0, total: Optional[int] = None):
        self._it = iter(iterable)
        self.n = start
        self.total = total

    def __iter__(self):
        return self

    def __next__(self):
        x = next(self._it)
        self.n += 1
        return x

    def has_next(self):
        return self.total is None or self.n < self.total


class BufferedIterator:
    """Background-thread prefetch (reference: iterators.py:570-653) — keeps the
    host data path off the device-feed critical path."""

    def __init__(self, iterable, buffer_size: int = 4):
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(buffer_size, 1))
        self._sentinel = object()
        self._exc: Optional[BaseException] = None

        def worker():
            try:
                for item in iterable:
                    self._queue.put(item)
            except BaseException as e:  # propagate to consumer
                self._exc = e
            finally:
                self._queue.put(self._sentinel)

        # lazy start: the thread spins up on first __next__, so an iterator
        # built and abandoned (init-peek / rewind in cli/train.py) never
        # collates buffer_size batches for nothing — for backtranslation
        # datasets each collate is a full jitted beam decode
        self._thread = threading.Thread(target=worker, daemon=True)

    def __iter__(self):
        return self

    def __next__(self):
        if not self._thread.is_alive() and not self._thread.ident:
            self._thread.start()
        item = self._queue.get()
        if item is self._sentinel:
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        return item


class EpochBatchIterator:
    """Iterates batches (index lists) over a dataset with a collater.

    state_dict()/load_state_dict() resume mid-epoch at batch granularity
    (reference: EpochBatchIterator, iterators.py:251-504).
    """

    def __init__(
        self,
        dataset,
        batches_fn: Callable[[int], List[np.ndarray]],
        collate_fn: Callable[[List[Dict[str, Any]]], Dict[str, Any]],
        seed: int = 1,
        num_shards: int = 1,
        shard_id: int = 0,
        buffer_size: int = 4,
        shuffle_batches: bool = True,
    ):
        self.dataset = dataset
        self.batches_fn = batches_fn
        self.collate_fn = collate_fn
        self.seed = seed
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.buffer_size = buffer_size
        self.shuffle_batches = shuffle_batches
        self.epoch = 1
        self._consumed = 0
        self._cur: Optional[CountingIterator] = None

    def _epoch_batches(self, epoch: int) -> List[np.ndarray]:
        batches = self.batches_fn(epoch)
        if self.shuffle_batches:
            rng = np.random.default_rng(self.seed + epoch)
            order = rng.permutation(len(batches))
            batches = [batches[i] for i in order]
        # shard across processes, dropping the ragged tail uniformly so every
        # shard sees the same batch count and step counters stay in sync
        if self.num_shards > 1:
            usable = len(batches) - len(batches) % self.num_shards
            batches = batches[:usable][self.shard_id :: self.num_shards]
        return batches

    def __len__(self):
        return len(self._epoch_batches(self.epoch))

    def next_epoch_itr(self) -> CountingIterator:
        batches = self._epoch_batches(self.epoch)
        start = self._consumed
        remaining = batches[start:]

        def gen():
            for idx in remaining:
                samples = [self.dataset[int(i)] for i in idx]
                yield self.collate_fn(samples)

        buffered = BufferedIterator(gen(), self.buffer_size)

        outer = self

        class _Tracking:
            def __init__(self):
                self._inner = iter(buffered)

            def __iter__(self):
                return self

            def __next__(self):
                batch = next(self._inner)
                outer._consumed += 1
                return batch

        self._cur = CountingIterator(_Tracking(), start=start, total=len(batches))
        return self._cur

    def rewind(self) -> None:
        """Reset the consumed-batch counter so the current epoch restarts from
        its first batch (used after peeking a batch for model init)."""
        self._consumed = 0
        self._cur = None

    def end_of_epoch(self) -> bool:
        return self._consumed >= len(self._epoch_batches(self.epoch))

    def next_epoch(self):
        self.epoch += 1
        self._consumed = 0
        # datasets with epoch-varying noise (e.g. BART denoising)
        self._sync_dataset_epoch()

    def state_dict(self) -> Dict[str, Any]:
        return {"epoch": self.epoch, "consumed": self._consumed, "seed": self.seed}

    def _sync_dataset_epoch(self):
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self.epoch)

    def load_state_dict(self, d: Dict[str, Any]):
        self.epoch = d["epoch"]
        self._consumed = d["consumed"]
        self.seed = d.get("seed", self.seed)
        # epoch-aware datasets (denoising noise) must resume at epoch N,
        # not their constructor default
        self._sync_dataset_epoch()

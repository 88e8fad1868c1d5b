"""Task base class: the batch-iterator pipeline and the default build methods
(counterpart of s2t_tpu/tasks/base.py).

``get_batch_iterator`` is filter-by-size -> length-sorted order ->
``batch_by_size`` -> ``EpochBatchIterator``.  The port trains on one card,
so ``batch_size_multiple`` defaults to 1 where the JAX package takes
``jax.device_count()``; ``dataset.required_batch_size_multiple`` still pads
every batch with zero-length dummy rows.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np

from s2t_tpu_torch.config import TrainConfig
from s2t_tpu_torch.data.batching import batch_by_size, filter_by_size, make_buckets
from s2t_tpu_torch.data.iterators import EpochBatchIterator
from s2t_tpu_torch.registry import TASKS


def setup_task(cfg: TrainConfig) -> "Task":
    return TASKS.get(cfg.task).setup(cfg)


class Task:
    # where a task runs models of its own while loading data (the reverse model of
    # semisupervised_translation); cli.train sets it to the training device
    device = "cuda"

    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg
        self.datasets: Dict[str, Any] = {}

    @classmethod
    def setup(cls, cfg: TrainConfig) -> "Task":
        return cls(cfg)

    def load_dataset(self, split: str, is_train: bool = False):
        raise NotImplementedError

    def build_model(self, **kwargs):
        raise NotImplementedError

    def build_criterion(self):
        from s2t_tpu_torch.criterions.build import build_criterion

        return build_criterion(self.cfg.criterion, self.cfg.criterion_cfg)

    def forward_fn(self):
        """The forward adapter the Trainer calls (feature transforms first,
        where a task has them)."""
        from s2t_tpu_torch.trainer import s2t_forward

        return s2t_forward

    def get_batch_iterator(
        self,
        dataset,
        max_tokens: Optional[int] = None,
        max_sentences: Optional[int] = None,
        seed: int = 1,
        shuffle: bool = True,
        num_shards: int = 1,
        shard_id: int = 0,
        buffer_size: int = 4,
        batch_size_multiple: int = 1,
    ) -> EpochBatchIterator:
        ds_cfg = self.cfg.dataset
        max_tokens = max_tokens or ds_cfg.max_tokens
        multiple = math.lcm(ds_cfg.required_batch_size_multiple, batch_size_multiple)
        # datasets whose n_frames are not 10 ms frame counts declare their own cap
        frame_cap = getattr(dataset, "frame_cap", None) or ds_cfg.max_source_positions
        frame_buckets = make_buckets(frame_cap, ds_cfg.num_buckets, sizes=dataset.n_frames)
        token_buckets = make_buckets(
            ds_cfg.max_target_positions, max(ds_cfg.num_buckets // 2, 4), min_val=8,
            sizes=getattr(dataset, "n_tokens", None),
        )
        keep = filter_by_size(
            dataset.n_frames, getattr(dataset, "n_tokens", None),
            max_frames=frame_cap, max_tokens=ds_cfg.max_target_positions,
        )

        def batches_fn(epoch: int):
            order = dataset.ordered_indices(shuffle=shuffle, seed=seed, epoch=epoch)
            keep_set = np.zeros(len(dataset), dtype=bool)
            keep_set[keep] = True
            order = order[keep_set[order]]
            return batch_by_size(
                order, dataset.n_frames, max_tokens=max_tokens,
                max_sentences=max_sentences or ds_cfg.batch_size,
                frame_buckets=frame_buckets, required_batch_size_multiple=multiple,
            )

        def collate(samples):
            return dataset.collater(samples, frame_buckets=frame_buckets,
                                    token_buckets=token_buckets, batch_multiple=multiple)

        return EpochBatchIterator(
            dataset, batches_fn, collate, seed=seed, num_shards=num_shards,
            shard_id=shard_id, buffer_size=buffer_size, shuffle_batches=shuffle,
        )

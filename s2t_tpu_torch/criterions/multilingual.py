"""The round-robin criterion of the multilingual Transformer (counterpart of
s2t_tpu/criterions/multilingual.py:17-48).

It sums a base criterion's summed loss and sample size over the pairs of a
``RoundRobinZipDataset`` batch (model output ``{"pairs": {pair: out}}``, batch
``{"pairs": {pair: sub-batch}}``); the Trainer then normalises by the global sample
size.  Each pair's logs come out as ``"{pair}:{key}"`` and their sums under the
plain keys, so the Trainer's and the CLI's meters read them unchanged.  Attributes
it lacks (``cfg``, ...) are the base criterion's.
"""

from __future__ import annotations

from typing import Any, Dict

import torch


class MultilingualCriterion:
    def __init__(self, base):
        self.base = base

    def __getattr__(self, name):
        return getattr(self.base, name)

    def __call__(self, model_out: Dict[str, Any], batch: Dict[str, Any]):
        total, sample_size = 0.0, 0.0
        logs: Dict[str, torch.Tensor] = {}
        summed: Dict[str, torch.Tensor] = {}
        for pair, out in model_out["pairs"].items():
            loss, size, pair_logs = self.base(out, batch["pairs"][pair])
            total = total + loss
            sample_size = sample_size + size
            for key, val in pair_logs.items():
                logs[f"{pair}:{key}"] = val
                summed[key] = summed.get(key, 0.0) + val
        logs.update(summed)
        return total, sample_size, logs

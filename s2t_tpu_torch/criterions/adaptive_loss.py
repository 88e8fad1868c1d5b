"""Adaptive loss: the NLL of the adaptive softmax's exact target path
(counterpart of s2t_tpu/criterions/adaptive_loss.py).

The model returns ``target_logprob`` (B, U), log p(target) per position; the loss
sums its negation over the non-pad targets, and the sample size is the token count
(or the sentence count with ``sentence_avg``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch


class AdaptiveLoss:
    @dataclass
    class Config:
        sentence_avg: bool = False
        pad_id: int = 1

    def __init__(self, cfg: "AdaptiveLoss.Config"):
        self.cfg = cfg

    def __call__(self, model_out: Dict[str, Any], batch: Dict[str, Any]):
        targets = batch["target"]
        mask = targets != self.cfg.pad_id
        loss = torch.where(mask, -model_out["target_logprob"].float(), 0.0).sum()
        ntokens = mask.sum(dtype=torch.float32)
        nsent = torch.tensor(float(targets.shape[0]), device=targets.device)
        sample_size = nsent if self.cfg.sentence_avg else ntokens
        return loss, sample_size, {"loss": loss, "nll_loss": loss, "ntokens": ntokens,
                                   "nsentences": nsent}

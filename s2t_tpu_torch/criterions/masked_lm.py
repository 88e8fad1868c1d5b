"""Masked-LM criteria (counterpart of s2t_tpu/criterions/masked_lm.py:18-86).

``masked_lm``: the cross-entropy of ``lm_logits`` (log-softmax in float32) against
``mlm_targets`` at the masked positions ``mlm_mask``, summed; the sample size is the
number of masked tokens (at least 1).  ``legacy_masked_lm`` (BERT) adds
``nsp_loss_weight`` x the next-sentence cross-entropy of ``cls_logits`` against
``batch["nsp_label"]``, over the rows that hold a token (``valid_row``: a collater's
dummy rows are all pad).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    lp = torch.log_softmax(logits.float(), dim=-1)
    return -lp.gather(-1, labels.long()[..., None])[..., 0]


class MaskedLMCriterion:
    @dataclass
    class Config:
        pad_id: int = 1

    def __init__(self, cfg: "MaskedLMCriterion.Config"):
        self.cfg = cfg

    def __call__(self, model_out: Dict[str, Any], batch: Dict[str, Any]):
        logits = model_out["lm_logits"]
        targets, mask = model_out["mlm_targets"], model_out["mlm_mask"]
        loss = torch.where(mask, _nll(logits, targets), 0.0).sum()
        sample_size = torch.clamp(mask.sum(dtype=torch.float32), min=1.0)
        correct = ((logits.argmax(dim=-1) == targets) & mask).sum(dtype=torch.float32)
        nsent = torch.tensor(float(targets.shape[0]), device=targets.device)
        return loss, sample_size, {"loss": loss, "nll_loss": loss, "ntokens": sample_size,
                                   "nsentences": nsent, "n_correct": correct,
                                   "total": sample_size}


class LegacyMaskedLMCriterion:
    @dataclass
    class Config:
        pad_id: int = 1
        nsp_loss_weight: float = 1.0

    def __init__(self, cfg: "LegacyMaskedLMCriterion.Config"):
        self.cfg = cfg
        self.mlm = MaskedLMCriterion(MaskedLMCriterion.Config(pad_id=cfg.pad_id))

    def __call__(self, model_out: Dict[str, Any], batch: Dict[str, Any]):
        loss, sample_size, logs = self.mlm(model_out, batch)
        cls_logits = model_out.get("cls_logits")
        if cls_logits is not None and "nsp_label" in batch:
            labels = batch["nsp_label"]
            valid_row = (model_out["mlm_targets"] != self.cfg.pad_id).any(dim=1)
            nsp_loss = torch.where(valid_row, _nll(cls_logits, labels), 0.0).sum()
            nsp_correct = ((cls_logits.argmax(dim=-1) == labels) & valid_row).sum(
                dtype=torch.float32)
            loss = loss + self.cfg.nsp_loss_weight * nsp_loss
            logs = {**logs, "loss": loss, "nsp_loss": nsp_loss, "nsp_correct": nsp_correct,
                    "nsp_total": valid_row.sum(dtype=torch.float32)}
        return loss, sample_size, logs

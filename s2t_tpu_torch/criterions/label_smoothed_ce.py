"""Label-smoothed cross-entropy (counterpart of s2t_tpu/criterions/label_smoothed_ce.py:17-72,
107-145, without mixup).

fairseq's formulation: eps_i = eps / (V - 1);
loss = (1 - eps - eps_i) * nll + eps_i * sum_v(-log p_v), summed over non-pad
target positions, with the log-softmax in float32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch


def label_smoothed_nll_loss(logits: torch.Tensor, targets: torch.Tensor, epsilon: float,
                            pad_id: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (smoothed_loss_sum, nll_loss_sum) over non-pad positions."""
    lprobs = torch.log_softmax(logits.float(), dim=-1)
    V = lprobs.shape[-1]
    nll = -lprobs.gather(-1, targets.long()[..., None])[..., 0]
    smooth = -lprobs.sum(dim=-1)
    mask = targets != pad_id
    nll = torch.where(mask, nll, 0.0)
    smooth = torch.where(mask, smooth, 0.0)
    eps_i = epsilon / (V - 1)
    loss = (1.0 - epsilon - eps_i) * nll + eps_i * smooth
    return loss.sum(), nll.sum()


def ce_accuracy(logits: torch.Tensor, targets: torch.Tensor, pad_id: int = 1):
    """(correct, total) over non-pad positions, as float32 scalars."""
    mask = targets != pad_id
    correct = ((logits.argmax(dim=-1) == targets) & mask).sum(dtype=torch.float32)
    return correct, mask.sum(dtype=torch.float32)


class LabelSmoothedCE:
    @dataclass
    class Config:
        label_smoothing: float = 0.1
        sentence_avg: bool = False
        report_accuracy: bool = True
        pad_id: int = 1

    def __init__(self, cfg: "LabelSmoothedCE.Config"):
        self.cfg = cfg

    def __call__(self, model_out: Dict[str, Any], batch: Dict[str, Any]):
        logits = model_out["decoder_logits"]
        targets = batch["target"]
        loss, nll = label_smoothed_nll_loss(logits, targets, self.cfg.label_smoothing,
                                            self.cfg.pad_id)
        ntokens = (targets != self.cfg.pad_id).sum(dtype=torch.float32)
        nsent = torch.tensor(float(targets.shape[0]), device=targets.device)
        sample_size = nsent if self.cfg.sentence_avg else ntokens
        logs = {"loss": loss, "nll_loss": nll, "ntokens": ntokens, "nsentences": nsent}
        if self.cfg.report_accuracy:
            logs["n_correct"], logs["total"] = ce_accuracy(logits, targets, self.cfg.pad_id)
        return loss, sample_size, logs

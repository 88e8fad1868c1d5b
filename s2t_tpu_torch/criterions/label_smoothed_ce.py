"""Label-smoothed cross-entropy (counterpart of s2t_tpu/criterions/label_smoothed_ce.py:17-145).

fairseq's formulation: eps_i = eps / (V - 1);
loss = (1 - eps - eps_i) * nll + eps_i * sum_v(-log p_v), summed over non-pad
target positions, with the log-softmax in float32.  Under encoder mixup a
decoder row r is scored against both source utterances' targets,
coef_r loss(target[index1_r]) + (1 - coef_r) loss(target[index2_r]), and
``decoder_mixup_consistent_loss`` pulls the mixed rows towards their
originals (AIPA).  ``LabelSmoothedCEWithAlignment`` adds the supervised
alignment term (label_smoothed_ce.py:148-187).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch


def label_smoothed_nll_loss_per_row(logits: torch.Tensor, targets: torch.Tensor,
                                    epsilon: float, pad_id: int = 1
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sentence (B,) smoothed loss and nll sums over non-pad positions."""
    lprobs = torch.log_softmax(logits.float(), dim=-1)
    V = lprobs.shape[-1]
    nll = -lprobs.gather(-1, targets.long()[..., None])[..., 0]
    smooth = -lprobs.sum(dim=-1)
    mask = targets != pad_id
    nll = torch.where(mask, nll, 0.0)
    smooth = torch.where(mask, smooth, 0.0)
    eps_i = epsilon / (V - 1)
    loss = (1.0 - epsilon - eps_i) * nll + eps_i * smooth
    return loss.sum(dim=-1), nll.sum(dim=-1)


def label_smoothed_nll_loss(logits: torch.Tensor, targets: torch.Tensor, epsilon: float,
                            pad_id: int = 1, mixup: Optional[dict] = None,
                            cal_mixup_loss: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (smoothed_loss_sum, nll_loss_sum) over non-pad positions.  With
    ``mixup`` (the encoder's), mixed rows take coef loss(target[index1]) +
    (1 - coef) loss(target[index2]), or 0 when not ``cal_mixup_loss``; the
    rows are weighted by ``mixup["weight"]``."""
    if mixup is None:
        loss, nll = label_smoothed_nll_loss_per_row(logits, targets, epsilon, pad_id)
        return loss.sum(), nll.sum()
    coef, i1, i2, flag = mixup["coef"], mixup["index1"], mixup["index2"], mixup["flag"]
    l1, n1 = label_smoothed_nll_loss_per_row(logits, targets[i1], epsilon, pad_id)
    l2, n2 = label_smoothed_nll_loss_per_row(logits, targets[i2], epsilon, pad_id)
    mixed_l = coef * l1 + (1.0 - coef) * l2 if cal_mixup_loss else 0.0
    mixed_n = coef * n1 + (1.0 - coef) * n2 if cal_mixup_loss else 0.0
    loss = torch.where(flag, mixed_l, l1)
    nll = torch.where(flag, mixed_n, n1)
    w = mixup.get("weight")
    if w is not None:  # ratio-decayed / appended-but-inactive rows
        loss, nll = loss * w, nll * w
    return loss.sum(), nll.sum()


def decoder_mixup_consistent_loss(logits: torch.Tensor, targets: torch.Tensor, mixup: dict,
                                  pad_id: int = 1) -> torch.Tensor:
    """KL(student = mixed decoder rows || teacher = the detached original rows),
    coef-weighted per source and masked by the teacher target's pads
    (s2t_tpu/criterions/label_smoothed_ce.py:71-96).  Original utterance j sits
    at row j - keep_boundary; a source whose original row was dropped is skipped."""
    coef, i1, i2, flag = mixup["coef"], mixup["index1"], mixup["index2"], mixup["flag"]
    kb = mixup["keep_boundary"]
    lp = torch.log_softmax(logits.float(), dim=-1)

    def term(idx, w):
        avail = flag & (idx >= kb)
        teacher = lp[(idx - kb).clamp(0, lp.shape[0] - 1)].detach()
        kl = (teacher.exp() * (teacher - lp)).sum(dim=-1).clamp_min(0.0)  # (B, U)
        pad_mask = targets[idx.clamp(0, targets.shape[0] - 1)] != pad_id
        kl = torch.where(pad_mask & avail[:, None], kl, 0.0)
        return (kl.sum(dim=1) * w).sum()

    return term(i1, coef) + term(i2, 1.0 - coef)


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
                                            self.cfg.pad_id, mixup=model_out.get("mixup"))
        ntokens = (targets != self.cfg.pad_id).sum(dtype=torch.float32)
        nsent = torch.tensor(float(targets.shape[0]), device=targets.device)
        sample_size = nsent if self.cfg.sentence_avg else ntokens
        logs = {"loss": loss, "nll_loss": nll, "ntokens": ntokens, "nsentences": nsent}
        if self.cfg.report_accuracy:
            logs["n_correct"], logs["total"] = ce_accuracy(logits, targets, self.cfg.pad_id)
        return loss, sample_size, logs


class LabelSmoothedCEWithAlignment:
    """The label-smoothed CE plus ``alignment_lambda`` x the alignment NLL: -log of
    the model's ``align_attn`` (B, U, S) at each word-aligned pair of
    ``batch["alignments"]`` (B, P, 2) = (source index, target index), -1 padded,
    clipped at 1e-9 and summed (logged as ``alignment_loss``; ``loss`` is the sum)."""

    @dataclass
    class Config:
        label_smoothing: float = 0.1
        sentence_avg: bool = False
        report_accuracy: bool = True
        pad_id: int = 1
        alignment_lambda: float = 0.05

    def __init__(self, cfg: "LabelSmoothedCEWithAlignment.Config"):
        self.cfg = cfg
        self.ce = LabelSmoothedCE(LabelSmoothedCE.Config(
            label_smoothing=cfg.label_smoothing, sentence_avg=cfg.sentence_avg,
            report_accuracy=cfg.report_accuracy, pad_id=cfg.pad_id))

    def __call__(self, model_out: Dict[str, Any], batch: Dict[str, Any]):
        loss, sample_size, logs = self.ce(model_out, batch)
        attn, pairs = model_out.get("align_attn"), batch.get("alignments")
        if attn is not None and pairs is not None:
            src_i, tgt_j = pairs[..., 0].long(), pairs[..., 1].long()
            valid = (src_i >= 0) & (tgt_j >= 0)
            b = torch.arange(attn.shape[0], device=attn.device)[:, None]
            p = attn[b, tgt_j.clamp(min=0), src_i.clamp(min=0)].float()
            align_loss = torch.where(valid, -torch.log(p.clamp(min=1e-9)), 0.0).sum()
            loss = loss + self.cfg.alignment_lambda * align_loss
            logs["alignment_loss"] = align_loss
            logs["loss"] = loss
        return loss, sample_size, logs

"""CTC criteria (counterpart of s2t_tpu/criterions/ctc.py, the ``ctc_weight`` branch).

``CTCCriterion.compute_ctc_loss`` (:117-151) scores the CTC head against the
transcript, or against the target with EOS rewritten to pad when the batch
has no transcript (:134-142); ``LabelSmoothedCEWithCTC`` (:342-404) adds it to
the label-smoothed CE, with the sample size the non-pad target tokens.  Every
other branch (inter-CTC, XCTC, AXCTC, entropy, self-distillation, mixup)
raises ``NotImplementedError`` by name when its weight is set.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Any, Dict, Tuple

import torch

from s2t_tpu_torch.criterions.label_smoothed_ce import ce_accuracy, label_smoothed_nll_loss
from s2t_tpu_torch.ops.ctc import ctc_loss

_UNPORTED_WEIGHTS = (
    "inter_ctc_weight", "xctc_weight", "inter_xctc_weight", "axctc_weight",
    "inter_axctc_weight", "ctc_entropy_weight", "ctc_self_distill_weight",
    "ctc_mixup_consistent_weight", "inter_ctc_mixup_consistent_weight",
)


def _raise_unported(cfg, names) -> None:
    for name in names:
        if getattr(cfg, name) != next(f.default for f in fields(cfg) if f.name == name):
            raise NotImplementedError(
                f"{type(cfg).__qualname__}.{name}={getattr(cfg, name)!r} is not ported to "
                "s2t_tpu_torch (only the ctc_weight branch is)")


class CTCCriterion:
    @dataclass
    class Config:
        ctc_weight: float = 1.0
        inter_ctc_weight: float = 0.0
        xctc_weight: float = 0.0
        inter_xctc_weight: float = 0.0
        axctc_weight: float = 0.0
        inter_axctc_weight: float = 0.0
        ctc_entropy_weight: float = 0.0
        ctc_self_distill_weight: float = 0.0
        ctc_self_distill_temperature: float = 1.0
        ctc_mixup_consistent_weight: float = 0.0
        inter_ctc_mixup_consistent_weight: float = 0.0
        inter_ctc_mlo: Tuple[int, ...] = ()
        sentence_avg: bool = False
        pad_id: int = 1
        eos_id: int = 2
        blank_id: int = 0
        zero_infinity: bool = True

    def __init__(self, cfg: "CTCCriterion.Config"):
        _raise_unported(cfg, _UNPORTED_WEIGHTS + ("inter_ctc_mlo",))
        self.cfg = cfg

    def compute_ctc_loss(self, model_out: Dict[str, Any],
                         batch: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        if model_out.get("mixup") is not None:
            raise NotImplementedError("CTC mixup is not ported to s2t_tpu_torch")
        enc_lengths = model_out.get("ctc_lengths")
        if enc_lengths is None:
            enc_lengths = model_out["encoder_lengths"]
        logits = model_out.get("ctc_logits")
        device = (logits if logits is not None else enc_lengths).device
        total = torch.zeros((), dtype=torch.float32, device=device)
        logs: Dict[str, torch.Tensor] = {}
        transcript = batch.get("transcript")
        transcript_lengths = batch.get("transcript_lengths")
        if transcript is None:
            # ASR: CTC over the target with the terminal EOS stripped; the lengths
            # are recomputed after the rewrite
            tgt = batch["target"]
            transcript = torch.where(tgt == cfg.eos_id, cfg.pad_id, tgt)
            transcript_lengths = (transcript != cfg.pad_id).sum(dim=1, dtype=torch.int32)
        if cfg.ctc_weight > 0 and logits is not None:
            loss = ctc_loss(logits, transcript.long(), enc_lengths, transcript_lengths,
                            blank_id=cfg.blank_id, reduction="none",
                            zero_infinity=cfg.zero_infinity, normalized=False).sum()
            logs["ctc_loss"] = loss
            total = total + cfg.ctc_weight * loss
        return total, logs

    def __call__(self, model_out, batch):
        loss, logs = self.compute_ctc_loss(model_out, batch)
        ntokens = torch.as_tensor(batch.get("ntokens", 1), dtype=torch.float32,
                                  device=loss.device)
        ref = batch.get("target", batch.get("transcript"))
        nsent = torch.tensor(float(ref.shape[0]), device=loss.device)
        sample_size = nsent if self.cfg.sentence_avg else ntokens
        logs.update({"loss": loss, "ntokens": ntokens, "nsentences": nsent})
        return loss, sample_size, logs


class LabelSmoothedCEWithCTC:
    """Label-smoothed CE + weighted CTC (the default ST/ASR loss)."""

    @dataclass
    class Config:
        label_smoothing: float = 0.1
        sentence_avg: bool = False
        report_accuracy: bool = True
        pad_id: int = 1
        cal_mixup_loss: bool = True
        mixup_consistent_weight: float = 0.0
        ctc: "CTCCriterion.Config" = field(default_factory=lambda: CTCCriterion.Config())

    def __init__(self, cfg: "LabelSmoothedCEWithCTC.Config"):
        _raise_unported(cfg, ("mixup_consistent_weight",))
        self.cfg = cfg
        self.ctc = CTCCriterion(cfg.ctc)

    def __call__(self, model_out, batch):
        logits = model_out["decoder_logits"]
        targets = batch["target"]
        ce, nll = label_smoothed_nll_loss(logits, targets, self.cfg.label_smoothing,
                                          self.cfg.pad_id)
        ctc_total, ctc_logs = self.ctc.compute_ctc_loss(model_out, batch)
        loss = ce + ctc_total
        ntokens = (targets != self.cfg.pad_id).sum(dtype=torch.float32)
        nsent = torch.tensor(float(targets.shape[0]), device=targets.device)
        sample_size = nsent if self.cfg.sentence_avg else ntokens
        logs = {"loss": loss, "ce_loss": ce, "nll_loss": nll, "ntokens": ntokens,
                "nsentences": nsent, **ctc_logs}
        if self.cfg.report_accuracy:
            logs["n_correct"], logs["total"] = ce_accuracy(logits, targets, self.cfg.pad_id)
        return loss, sample_size, logs

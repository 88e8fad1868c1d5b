"""CTC criteria (counterpart of s2t_tpu/criterions/ctc.py:31-404).

``CTCCriterion.compute_ctc_loss`` composes every CTC branch of the JAX
criterion: the final CTC head against the transcript (or the target with EOS
rewritten to pad when the batch has no transcript), the inter-CTC taps (each
against its MLO level ``transcript{k}`` when ``inter_ctc_mlo`` names one),
XCTC and inter-XCTC against the target, AXCTC and inter-AXCTC against the
``aligned_target``, the mixup-consistency KLs, the entropy of the CTC
posterior and inter-layer self-distillation (the final head's posterior
detached as the teacher).  Under encoder mixup every CTC term scores each row
against both source utterances' labels, so it runs the lattice twice.  An
inter tap has no lengths of its own: it is scored with the final encoder
lengths, as in JAX.  ``LabelSmoothedCEWithCTC`` adds the label-smoothed CE,
with mixup and the decoder's mixup consistency; ``JoinSpeechAndTextLoss``
(the dual and multibranch models' criterion) down-weights that CE by the main
CTC weight: (1 - w) CE + the CTC terms.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

import torch

from s2t_tpu_torch.criterions.label_smoothed_ce import (
    ce_accuracy, decoder_mixup_consistent_loss, label_smoothed_nll_loss)
from s2t_tpu_torch.ops.ctc import ctc_loss


def _log_softmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(logits.float(), dim=-1)


def _strip_eos(tokens: torch.Tensor, eos_id: int, pad_id: int):
    """CTC labels from a target: EOS -> pad, the lengths counted after the rewrite."""
    tokens = torch.where(tokens == eos_id, pad_id, tokens)
    return tokens, (tokens != pad_id).sum(dim=1, dtype=torch.int32)


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
        self.cfg = cfg

    def _one_ctc(self, logits, enc_lengths, tokens, token_lengths, mixup=None) -> torch.Tensor:
        """Summed CTC of ``logits``; under mixup row r scores coef_r CTC(labels of
        index1_r) + (1 - coef_r) CTC(labels of index2_r), the unmixed rows
        CTC(index1_r) (computed twice, as in JAX), times the row weight."""
        cfg = self.cfg

        def rows(tk, tl):
            return ctc_loss(logits, tk.long(), enc_lengths, tl, blank_id=cfg.blank_id,
                            reduction="none", zero_infinity=cfg.zero_infinity, normalized=False)

        if mixup is None:
            return rows(tokens, token_lengths).sum()
        coef, i1, i2, flag = mixup["coef"], mixup["index1"], mixup["index2"], mixup["flag"]
        l1 = rows(tokens[i1], token_lengths[i1])
        l2 = rows(tokens[i2], token_lengths[i2])
        loss = torch.where(flag, coef * l1 + (1.0 - coef) * l2, l1)
        w = mixup.get("weight")
        if w is not None:  # ratio-decayed / appended-but-inactive rows
            loss = loss * w
        return loss.sum()

    @staticmethod
    def _mixup_consistent(logits, enc_lengths, mixup) -> torch.Tensor:
        """KL(student = mixed rows || teacher = the detached unmixed source rows),
        each source weighted by its mixing coefficient; original j sits at row
        j - keep_boundary."""
        coef, i1, i2, flag = mixup["coef"], mixup["index1"], mixup["index2"], mixup["flag"]
        m = mixup["keep_boundary"]
        lp = _log_softmax(logits)
        frames = torch.arange(lp.shape[1], device=lp.device)[None, :]

        def term(idx, w):
            avail = flag & (idx >= m)
            trow = (idx - m).clamp(0, lp.shape[0] - 1)
            teacher = lp[trow].detach()
            kl = (teacher.exp() * (teacher - lp)).sum(dim=-1).clamp_min(0.0)  # (B, T)
            valid = frames < enc_lengths[trow][:, None]
            kl = torch.where(valid & avail[:, None], kl, 0.0)
            return (kl.sum(dim=1) * w).sum()

        return term(i1, coef) + term(i2, 1.0 - coef)

    def _taps_ctc(self, taps, enc_lengths, tokens, token_lengths, mixup) -> torch.Tensor:
        """Mean over the taps of each tap's summed CTC (a tap's own lengths when it
        carries them, else the final encoder lengths)."""
        total = sum(self._one_ctc(entry[1], entry[2] if len(entry) > 2 else enc_lengths,
                                  tokens, token_lengths, mixup) for entry in taps)
        return total / len(taps)

    def compute_ctc_loss(self, model_out: Dict[str, Any],
                         batch: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        # ctc_lengths diverges from encoder_lengths when an encoder pools its output
        # back after CTC upsampling
        enc_lengths = model_out.get("ctc_lengths")
        if enc_lengths is None:
            enc_lengths = model_out["encoder_lengths"]
        mixup = model_out.get("mixup")
        logs: Dict[str, torch.Tensor] = {}
        total = torch.zeros((), dtype=torch.float32, device=enc_lengths.device)
        transcript = batch.get("transcript")
        transcript_lengths = batch.get("transcript_lengths")
        if transcript is None:
            # ASR: CTC over the target with the terminal EOS stripped
            transcript, transcript_lengths = _strip_eos(batch["target"], cfg.eos_id, cfg.pad_id)

        logits = model_out.get("ctc_logits")
        if cfg.ctc_weight > 0 and logits is not None:
            loss = self._one_ctc(logits, enc_lengths, transcript, transcript_lengths, mixup)
            logs["ctc_loss"] = loss
            total = total + cfg.ctc_weight * loss

        inter = model_out.get("inter_ctc_logits") or ()
        if cfg.inter_ctc_weight > 0 and len(inter) > 0:
            il = 0.0
            for i, entry in enumerate(inter):
                tk, tl = transcript, transcript_lengths
                if cfg.inter_ctc_mlo and i < len(cfg.inter_ctc_mlo):
                    # MLO: inter head i scores transcript level k
                    k = cfg.inter_ctc_mlo[i]
                    if f"transcript{k}" in batch:
                        tk, tl = batch[f"transcript{k}"], batch[f"transcript{k}_lengths"]
                il = il + self._one_ctc(entry[1], entry[2] if len(entry) > 2 else enc_lengths,
                                        tk, tl, mixup)
            il = il / len(inter)
            logs["inter_ctc_loss"] = il
            total = total + cfg.inter_ctc_weight * il

        xlogits = model_out.get("xctc_logits")
        inter_x = model_out.get("inter_xctc_logits") or ()
        if (cfg.xctc_weight > 0 and xlogits is not None) or \
                (cfg.inter_xctc_weight > 0 and len(inter_x) > 0):
            tgt, tgt_lengths = _strip_eos(batch["target"], cfg.eos_id, cfg.pad_id)
            if cfg.xctc_weight > 0 and xlogits is not None:
                loss = self._one_ctc(xlogits, enc_lengths, tgt, tgt_lengths, mixup)
                logs["xctc_loss"] = loss
                total = total + cfg.xctc_weight * loss
            if cfg.inter_xctc_weight > 0 and len(inter_x) > 0:
                il = self._taps_ctc(inter_x, enc_lengths, tgt, tgt_lengths, mixup)
                logs["inter_xctc_loss"] = il
                total = total + cfg.inter_xctc_weight * il

        # AXCTC: the aligned target on the AXCTC head, or on the XCTC head's logits
        # when the model has none
        if (cfg.axctc_weight > 0 or cfg.inter_axctc_weight > 0) and "aligned_target" in batch:
            atgt, alen = _strip_eos(batch["aligned_target"], cfg.eos_id, cfg.pad_id)
            ax_logits = model_out.get("axctc_logits")
            if ax_logits is None:
                ax_logits = xlogits
            if cfg.axctc_weight > 0 and ax_logits is not None:
                loss = self._one_ctc(ax_logits, enc_lengths, atgt, alen, mixup)
                logs["axctc_loss"] = loss
                total = total + cfg.axctc_weight * loss
            inter_ax = model_out.get("inter_axctc_logits") or inter_x
            if cfg.inter_axctc_weight > 0 and len(inter_ax) > 0:
                il = self._taps_ctc(inter_ax, enc_lengths, atgt, alen, mixup)
                logs["inter_axctc_loss"] = il
                total = total + cfg.inter_axctc_weight * il

        if cfg.ctc_mixup_consistent_weight > 0 and mixup is not None and logits is not None:
            cl = self._mixup_consistent(logits, enc_lengths, mixup)
            logs["ctc_mixup_consistent_loss"] = cl
            total = total + cfg.ctc_mixup_consistent_weight * cl
        if cfg.inter_ctc_mixup_consistent_weight > 0 and mixup is not None and len(inter) > 0:
            il = sum(self._mixup_consistent(tap, enc_lengths, mixup) for _, tap in inter)
            il = il / len(inter)
            logs["inter_ctc_mixup_consistent_loss"] = il
            total = total + cfg.inter_ctc_mixup_consistent_weight * il

        frames = None if logits is None else \
            torch.arange(logits.shape[1], device=logits.device)[None, :] < enc_lengths[:, None]
        if cfg.ctc_entropy_weight > 0 and logits is not None:
            # the mean per-frame entropy of the CTC posterior
            lp = _log_softmax(logits)
            ent = -(lp.exp() * lp).sum(dim=-1)
            ent = torch.where(frames, ent, 0.0).sum() / frames.sum().clamp(min=1)
            logs["ctc_entropy"] = ent
            total = total + cfg.ctc_entropy_weight * ent

        if cfg.ctc_self_distill_weight > 0 and len(inter) > 0 and logits is not None:
            # KL(final || inter) per frame; the teacher is detached, so the gradient
            # reaches only the inter-layer students
            tau = cfg.ctc_self_distill_temperature
            teacher = _log_softmax(logits.detach() / tau)
            kd = 0.0
            for _, tap in inter:
                kl = teacher.exp() * (teacher - _log_softmax(tap / tau))
                kd = kd + torch.where(frames[..., None], kl, 0.0).sum()
            kd = kd / len(inter)
            logs["ctc_self_distill_loss"] = kd
            total = total + cfg.ctc_self_distill_weight * kd
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
    """Label-smoothed CE + the weighted CTC branches (the default ST/ASR loss).
    Under mixup the CE scores both sources of a mixed row (``cal_mixup_loss``
    off: none), ``mixup_consistent_weight`` adds the decoder's consistency KL,
    and accuracy and the token count follow the index1 targets."""

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
        self.cfg = cfg
        self.ctc = CTCCriterion(cfg.ctc)

    def __call__(self, model_out, batch):
        cfg = self.cfg
        logits = model_out["decoder_logits"]
        targets = batch["target"]
        mixup = model_out.get("mixup")
        ce, nll = label_smoothed_nll_loss(logits, targets, cfg.label_smoothing, cfg.pad_id,
                                          mixup=mixup, cal_mixup_loss=cfg.cal_mixup_loss)
        ctc_total, ctc_logs = self.ctc.compute_ctc_loss(model_out, batch)
        loss = ce + ctc_total
        if cfg.mixup_consistent_weight > 0 and mixup is not None:
            mc = decoder_mixup_consistent_loss(logits, targets, mixup, cfg.pad_id)
            ctc_logs = {**ctc_logs, "mixup_consistent_loss": mc}
            loss = loss + cfg.mixup_consistent_weight * mc
        # under mixup decoder row r is scored against target[index1[r]]
        acc_targets = targets if mixup is None else targets[mixup["index1"]]
        ntokens = (acc_targets != cfg.pad_id).sum(dtype=torch.float32)
        nsent = torch.tensor(float(targets.shape[0]), device=targets.device)
        sample_size = nsent if cfg.sentence_avg else ntokens
        logs = {"loss": loss, "ce_loss": ce, "nll_loss": nll, "ntokens": ntokens,
                "nsentences": nsent, **ctc_logs}
        if cfg.report_accuracy:
            logs["n_correct"], logs["total"] = ce_accuracy(logits, acc_targets, cfg.pad_id)
        return loss, sample_size, logs


class JoinSpeechAndTextLoss:
    """(1 - ctc_weight) CE + the CTC branches, for the dual and multibranch
    models (s2t_tpu/criterions/ctc.py:306-340): ``LabelSmoothedCEWithCTC``'s
    loss less ctc_weight times its CE term, logged as ``trans_loss``."""

    @dataclass
    class Config:
        label_smoothing: float = 0.1
        sentence_avg: bool = False
        report_accuracy: bool = True
        pad_id: int = 1
        ctc: "CTCCriterion.Config" = field(default_factory=lambda: CTCCriterion.Config())

    def __init__(self, cfg: "JoinSpeechAndTextLoss.Config"):
        self.cfg = cfg
        self.inner = LabelSmoothedCEWithCTC(LabelSmoothedCEWithCTC.Config(
            label_smoothing=cfg.label_smoothing, sentence_avg=cfg.sentence_avg,
            report_accuracy=cfg.report_accuracy, pad_id=cfg.pad_id, ctc=cfg.ctc))

    def __call__(self, model_out, batch):
        loss, sample_size, logs = self.inner(model_out, batch)
        w = self.cfg.ctc.ctc_weight
        if w > 0:
            ce = logs["ce_loss"]
            loss = loss - w * ce
            logs = {**logs, "loss": loss, "trans_loss": (1.0 - w) * ce}
        return loss, sample_size, logs

"""NAT loss (counterpart of s2t_tpu/criterions/nat_loss.py): each head's loss is
mean-reduced over its own mask and the heads add up, so ``sample_size`` is 1 and
the Trainer's normalisation leaves the loss as it is.

* the insertion slots: the soft slot targets' cross-entropy over the valid slots;
* the words: label-smoothed CE over ``word_ins_mask`` (smoothing eps spread as
  eps x the mean negative log-prob), against ``word_ins_tgt`` where the model
  gives one (Levenshtein's bos-prefixed target), else the batch's target;
* NACRF: ``word_ins_factor`` x that CE + the CRF NLL summed over rows / target tokens;
* Levenshtein's insertion-count and deletion heads at smoothing 0.01;
* the length head: ``length_loss_factor`` x its mean CE.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch


def masked_ls_ce(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
                 label_smoothing: float):
    """(loss, nll) means over ``mask``."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    nll = -lp.gather(-1, targets.long()[..., None])[..., 0]
    loss = (1.0 - label_smoothing) * nll + label_smoothing * -lp.mean(dim=-1)
    m = mask.float()
    denom = torch.clamp(m.sum(), min=1.0)
    return (loss * m).sum() / denom, (nll * m).sum() / denom


class NATLoss:
    @dataclass
    class Config:
        label_smoothing: float = 0.1
        length_loss_factor: float = 0.1
        pad_id: int = 1

    def __init__(self, cfg: "NATLoss.Config"):
        self.cfg = cfg

    def __call__(self, model_out: Dict[str, Any], batch: Dict[str, Any]):
        pad = self.cfg.pad_id
        one = torch.ones((), dtype=torch.float32, device=batch["target"].device)
        if "slot_logits" in model_out:
            lp = torch.log_softmax(model_out["slot_logits"].float(), dim=-1)
            valid = model_out["slot_valid"].float()
            per_slot = -(model_out["slot_tgt"] * lp).sum(dim=-1)
            loss = (per_slot * valid).sum() / torch.clamp(valid.sum(), min=1.0)
            tgt = batch["target"]
            return loss, one, {"loss": loss, "nll_loss": loss,
                               "ntokens": (tgt != pad).sum(dtype=torch.float32),
                               "nsentences": one * tgt.shape[0]}
        targets = model_out.get("word_ins_tgt", batch["target"])
        word_loss, word_nll = masked_ls_ce(model_out["word_ins_logits"], targets,
                                           model_out["word_ins_mask"], self.cfg.label_smoothing)
        loss = word_loss
        logs: Dict[str, torch.Tensor] = {"word_ins_loss": word_loss, "nll_loss": word_nll}
        ntokens = (targets != pad).sum(dtype=torch.float32)
        if "crf_nll" in model_out:
            crf_loss = model_out["crf_nll"].sum() / torch.clamp(ntokens, min=1.0)
            loss = model_out.get("word_ins_factor", 0.5) * word_loss + crf_loss
            logs["crf_loss"] = logs["nll_loss"] = crf_loss
        for head in ("ins", "del"):
            if f"{head}_logits" in model_out:
                head_loss, _ = masked_ls_ce(model_out[f"{head}_logits"], model_out[f"{head}_tgt"],
                                            model_out[f"{head}_mask"], 0.01)
                loss = loss + head_loss
                logs[f"{head}_loss"] = head_loss
        if "length_logits" in model_out and "length_tgt" in model_out:
            llp = torch.log_softmax(model_out["length_logits"].float(), dim=-1)
            length_loss = -llp.gather(-1, model_out["length_tgt"].long()[:, None]).mean()
            loss = loss + self.cfg.length_loss_factor * length_loss
            logs["length_loss"] = length_loss
        logs.update(loss=loss, ntokens=ntokens, nsentences=one * targets.shape[0])
        return loss, one, logs

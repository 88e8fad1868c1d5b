"""wav2vec criterion: wav2vec v1's CPC loss, and wav2vec 2.0's InfoNCE + codebook
diversity + feature penalty (counterpart of s2t_tpu/criterions/wav2vec.py).

Cross entropy over the (1 + N, B, M) contrastive logits with the positive at
index 0, over the valid masked positions (the sample size); plus
``prob_ppl_weight`` (V - prob_perplexity) / V and ``features_pen_weight`` times
the extractor's mean squared feature, each times the sample size.

wav2vec v1 (its dense ``cpc_logits`` (B, T', steps, 1 + N), :31-84): InfoNCE
(the model's ``infonce``: cross entropy with the positive at index 0) or binary
cross entropy with the positive labelled 1, the negatives weighed 1 / N under
``balanced_classes``, over the valid scores; the sample size is the count of
valid positives; plus the k-means quantizer's loss times the sample size, or the
Gumbel quantizer's ``prob_ppl_weight`` diversity term.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch


class Wav2VecCriterion:
    @dataclass
    class Config:
        infonce: bool = True
        prob_ppl_weight: float = 0.1
        features_pen_weight: float = 10.0

    def __init__(self, cfg: "Wav2VecCriterion.Config"):
        self.cfg = cfg

    def __call__(self, model_out: Dict[str, Any], batch: Dict[str, Any]):
        if "cpc_logits" in model_out:
            return self._cpc_v1(model_out)
        cfg = self.cfg
        logits = model_out["logits"].float()  # (1 + N, B, M)
        _, B, M = logits.shape
        valid = model_out.get("mask_valid")
        if valid is None:
            valid = torch.ones((B, M), dtype=torch.bool, device=logits.device)
        nll = torch.where(valid, -torch.log_softmax(logits, dim=0)[0], 0.0)
        sample_size = valid.sum(dtype=torch.float32)
        loss = nll.sum()
        logs = {"contrastive_loss": loss, "nll_loss": loss}
        if "prob_perplexity" in model_out and cfg.prob_ppl_weight > 0:
            num_vars = model_out["num_vars"]
            ppl_loss = cfg.prob_ppl_weight * (num_vars - model_out["prob_perplexity"]) \
                / num_vars * sample_size
            loss = loss + ppl_loss
            logs["prob_perplexity"] = model_out["prob_perplexity"]
            logs["diversity_loss"] = ppl_loss
        if "features_pen" in model_out and cfg.features_pen_weight > 0:
            loss = loss + cfg.features_pen_weight * model_out["features_pen"] * sample_size
            logs["features_pen"] = model_out["features_pen"]
        correct = torch.where(valid, logits.argmax(dim=0) == 0, False).sum(dtype=torch.float32)
        logs.update({"loss": loss, "ntokens": sample_size,
                     "nsentences": torch.tensor(float(B), device=logits.device),
                     "n_correct": correct, "total": sample_size})
        return loss, sample_size, logs

    def _cpc_v1(self, model_out: Dict[str, Any]):
        logits = model_out["cpc_logits"].float()  # (B, T, steps, 1 + N)
        valid = model_out["cpc_valid"]
        B = logits.shape[0]
        sample_size = valid.sum(dtype=torch.float32)
        if model_out.get("infonce"):
            nll = torch.where(valid, -torch.log_softmax(logits, dim=-1)[..., 0], 0.0)
            loss = nll.sum()
            correct = torch.where(valid, logits.argmax(dim=-1) == 0, False).sum(
                dtype=torch.float32)
        else:
            labels = torch.zeros_like(logits)
            labels[..., 0] = 1.0
            bce = torch.clamp(logits, min=0) - logits * labels + \
                torch.log1p(torch.exp(-logits.abs()))
            if model_out.get("balanced_classes"):
                w = torch.full_like(logits, 1.0 / max(model_out["num_negatives"], 1))
                w[..., 0] = 1.0
                bce = bce * w
            loss = torch.where(valid[..., None], bce, 0.0).sum()
            correct = torch.where(valid, logits[..., 0] > 0, False).sum(dtype=torch.float32)
        logs = {"nll_loss": loss, "ntokens": sample_size,
                "nsentences": torch.tensor(float(B), device=logits.device),
                "n_correct": correct, "total": sample_size}
        if "kmeans_loss" in model_out:
            loss = loss + model_out["kmeans_loss"] * sample_size
            logs["kmeans_loss"] = model_out["kmeans_loss"]
        elif "prob_perplexity" in model_out and self.cfg.prob_ppl_weight > 0:
            nv = model_out["num_vars"]
            extra = self.cfg.prob_ppl_weight * (nv - model_out["prob_perplexity"]) / nv * \
                sample_size
            loss = loss + extra
            logs["diversity_loss"] = extra
        logs["loss"] = loss
        return loss, sample_size, logs

"""wav2vec 2.0 criterion: InfoNCE + codebook diversity + feature penalty
(counterpart of s2t_tpu/criterions/wav2vec.py:92-127).

Cross entropy over the (1 + N, B, M) contrastive logits with the positive at
index 0, over the valid masked positions (the sample size); plus
``prob_ppl_weight`` (V - prob_perplexity) / V and ``features_pen_weight`` times
the extractor's mean squared feature, each times the sample size.  wav2vec v1's
CPC loss (its ``cpc_logits``) waits with that model (ROADMAP.md item 9).
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
            raise NotImplementedError("wav2vec v1's CPC loss is not ported to s2t_tpu_torch "
                                      "(ROADMAP.md section 1 item 9)")
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

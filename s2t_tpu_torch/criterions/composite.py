"""Composite and model-supplied criteria (counterpart of
s2t_tpu/criterions/composite.py:19-107).

``composite_loss`` averages an underlying criterion over the model output's
``outputs`` (one output dict per head; the output itself when absent), each scored
against the batch's matching ``targets[i]`` where the batch has them.  ``model``
takes the model's own ``losses`` dict (name -> scalar), weights each term by
``loss_weights`` (1.0 unless named; a weight of 0 leaves the term out) and logs the
model-output keys named in ``log_keys``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List

import torch


class CompositeLoss:
    @dataclass
    class Config:
        underlying_criterion: str = "label_smoothed_cross_entropy"
        underlying_cfg: Dict[str, Any] = field(default_factory=dict)

    def __init__(self, cfg: "CompositeLoss.Config"):
        from s2t_tpu_torch.criterions.build import build_criterion

        self.cfg = cfg
        self.underlying = build_criterion(cfg.underlying_criterion, cfg.underlying_cfg)

    def __call__(self, model_out: Dict[str, Any], batch: Dict[str, Any]):
        outputs = model_out.get("outputs", (model_out,))
        if not outputs:
            raise ValueError("composite_loss needs at least one model output")
        targets = batch.get("targets")
        total, n = 0.0, 0.0
        logs: Dict[str, torch.Tensor] = {}
        for i, out in enumerate(outputs):
            b = dict(batch)
            if targets is not None:
                b["target"] = targets[i]
            loss_i, n_i, logs_i = self.underlying(out, b)
            total = total + loss_i.float()
            n = n + torch.as_tensor(n_i, dtype=torch.float32)
            logs[f"loss_{i}"] = loss_i
        k = len(outputs)
        total, n = total / k, n / k
        logs["loss"] = total
        logs["ntokens"] = n
        logs.setdefault("nsentences", logs_i.get("nsentences", n))
        return total, n, logs


class ModelCriterion:
    @dataclass
    class Config:
        loss_weights: Dict[str, float] = field(default_factory=dict)
        log_keys: List[str] = field(default_factory=list)

    def __init__(self, cfg: "ModelCriterion.Config"):
        self.cfg = cfg

    def __call__(self, model_out: Dict[str, Any], batch: Dict[str, Any]):
        losses = model_out["losses"]
        ref = next(iter(losses.values()))
        sample_size = torch.as_tensor(model_out.get("sample_size", batch.get("ntokens", 1.0)),
                                      dtype=torch.float32, device=ref.device)
        total = torch.zeros((), dtype=torch.float32, device=ref.device)
        logs: Dict[str, torch.Tensor] = {}
        for name, value in losses.items():
            w = float(self.cfg.loss_weights.get(name, 1.0))
            if w == 0.0:
                continue
            contrib = w * value.float()
            total = total + contrib
            logs[f"loss_{name}"] = contrib
        for key in self.cfg.log_keys:
            if key in model_out:
                logs[key] = model_out[key]
        logs["loss"] = total
        logs["ntokens"] = sample_size
        logs["nsentences"] = torch.as_tensor(batch.get("nsentences", 1.0), dtype=torch.float32,
                                             device=ref.device)
        return total, sample_size, logs

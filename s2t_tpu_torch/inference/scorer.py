"""SequenceScorer: teacher-forced scoring of given target sequences
(counterpart of s2t_tpu/inference/scorer.py:1-54; fairseq's
--score-reference): per-token log-probs, their sum and mean per sentence.
"""

from __future__ import annotations

from typing import Any, Dict

import torch


class SequenceScorer:
    """``forward_fn``: a task's ``forward_fn()`` (fn(model, batch, train) ->
    outputs with "decoder_logits"); without one the model is called on the
    batch's features, lengths and prev_tokens."""

    def __init__(self, model, pad_id: int = 1, forward_fn=None):
        self.model = model
        self.pad_id = pad_id
        self.forward_fn = forward_fn

    @torch.inference_mode()
    def score(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """batch: "features", "feat_lengths", "prev_tokens" and "target" (B, U)
        as numpy arrays or tensors.  Returns positional_scores (B, U), score
        (B,), avg_score (B,) and ntokens (B,); pad positions score 0."""
        dev = self.model.device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items() if hasattr(v, "shape")}
        batch["features"] = batch["features"].float()
        if self.forward_fn is not None:
            out = self.forward_fn(self.model, batch, False)
        else:
            out = self.model(batch["features"], batch["feat_lengths"].long(),
                             batch["prev_tokens"].long())
        lp = torch.log_softmax(out["decoder_logits"].float(), dim=-1)
        target = batch["target"].long()
        mask = target != self.pad_id
        tok_lp = torch.where(mask, lp.gather(-1, target[..., None])[..., 0], 0.0)
        total = tok_lp.sum(dim=-1)
        ntok = mask.sum(dim=-1)
        return {"positional_scores": tok_lp, "score": total,
                "avg_score": total / ntok.clamp(min=1), "ntokens": ntok}

"""Iterative refinement decoding for the NAT models (counterpart of
s2t_tpu/inference/iterative_refinement.py).

``generate(batch)`` -> (tokens (B, 1, Tmax), scores (B, 1), the encoder dict), the
``SequenceGenerator`` contract, so ``cli.generate``, validation and the hub take it
as they are.  The canvas is a fixed (B, Tmax) and ``max_iter`` rounds step in a
Python loop:

* mask-predict (CMLM, vanilla NAT): the predicted length clamped to [2, Tmax]
  gives <unk> ... <unk> eos; each round fills every <unk> with its argmax and score
  and, except after the last, re-masks the (n - 2) x (1 - (i + 1) / max_iter)
  lowest-scoring positions (``skeptical_unmask``; a stable sort, as ``jnp.argsort``,
  so ties re-mask alike);
* NACRF: one parallel pass, then Viterbi over the CRF lattice;
* Levenshtein: [bos, eos] and delete -> insert -> fill rounds (``refine_step``).
"""

from __future__ import annotations

from typing import Any, Dict

import torch


def skeptical_unmask(scores: torch.Tensor, nonpad: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The ``(num_nonpad - 2) * p`` lowest-scoring positions of each row."""
    num = ((nonpad.sum(dim=1) - 2).float() * p).to(torch.int32)
    s = torch.where(nonpad, scores, torch.inf)
    rank = torch.argsort(torch.argsort(s, dim=1, stable=True), dim=1, stable=True)
    return rank < num[:, None]


class IterativeRefinementGenerator:
    def __init__(self, model, max_iter: int = 10, max_target_positions: int = 256,
                 bos_id: int = 0, pad_id: int = 1, eos_id: int = 2, unk_id: int = 3):
        self.model = model
        self.max_iter = max_iter
        self.Tmax = max_target_positions
        self.bos, self.pad, self.eos, self.unk = bos_id, pad_id, eos_id, unk_id

    @torch.inference_mode()
    def generate(self, batch: Dict[str, Any]):
        model, dev = self.model, self.model.device
        src = torch.as_tensor(batch.get("src_tokens", batch.get("features"))).long().to(dev)
        lens = torch.as_tensor(batch.get("src_lengths", batch.get("feat_lengths"))).long().to(dev)
        enc = model.encode(src, lens)
        enc_out, enc_valid = enc["encoder_out"], model.encoder_valid(enc)
        B, Tmax, pad, unk = src.shape[0], self.Tmax, self.pad, self.unk
        scores = torch.zeros((B, Tmax), dtype=torch.float32, device=dev)

        if hasattr(model, "refine_step"):  # Levenshtein: the model owns its rounds
            tokens = model.init_canvas(enc_out, enc_valid, Tmax)
            for i in range(self.max_iter):
                tokens, scores = model.refine_step(tokens, scores, enc_out, enc_valid, i)
            n = (tokens != pad).sum(dim=1).float()
            return tokens[:, None], (scores.sum(dim=1) / torch.clamp(n, min=1.0))[:, None], enc

        lengths = model.predict_length(enc_out, enc_valid).clamp(2, Tmax)
        pos = torch.arange(Tmax, device=dev)[None, :]
        tokens = torch.where(pos < lengths[:, None] - 1, unk, pad)
        tokens = torch.where(pos == lengths[:, None] - 1, self.eos, tokens)
        if hasattr(model, "crf_decode"):  # NACRF: one pass, then Viterbi
            fill = tokens == unk
            vit_tokens, vit_score = model.crf_decode(
                model.nat_decode(tokens, enc_out, enc_valid), fill)
            tokens = torch.where(fill, vit_tokens, tokens)
            return tokens[:, None], (vit_score / lengths.float().clamp(min=1.0))[:, None], enc

        for i in range(self.max_iter):
            lp = torch.log_softmax(model.nat_decode(tokens, enc_out, enc_valid).float(), dim=-1)
            step_scores, step_tokens = lp.max(dim=-1)
            masked = tokens == unk
            tokens = torch.where(masked, step_tokens, tokens)
            scores = torch.where(masked, step_scores, scores)
            if i + 1 < self.max_iter:  # skeptical re-masking, except after the last round
                p = 1.0 - torch.tensor(i + 1, dtype=torch.float32) / float(self.max_iter)
                remask = skeptical_unmask(scores, tokens != pad, p.to(dev))
                tokens = torch.where(remask, unk, tokens)
                scores = torch.where(remask, 0.0, scores)
        return tokens[:, None], (scores.sum(dim=1) / lengths.float().clamp(min=1.0))[:, None], enc

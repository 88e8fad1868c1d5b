"""CTC-drafted Jacobi decoding: exact greedy decoding without the sequential loop
(counterpart of s2t_tpu/inference/jacobi.py).

Greedy autoregressive decoding ``y_i = argmax p(y_i | y_<i, x)`` is the unique
fixpoint of the parallel iteration ``y <- argmax p(. | prefixes of y, x)``: each
iteration is one teacher-forced decoder pass over (B, L), the prefix that
already matches the greedy trajectory grows by at least one a pass, so the
fixpoint comes in at most L passes and equals beam-1 decoding.  The iteration
starts from the model's own CTC greedy output (blanks and repeats collapsed,
then EOS), which the encoder pass gives for free.

Plain PyTorch on the model's device, as the JAX package leaves it to XLA; the
fixpoint test reads one flag to the host a pass (JAX's ``while_loop`` tests it
on the device).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from s2t_tpu_torch.inference.generator import encoder_length_bound
from s2t_tpu_torch.utils.masking import lengths_to_mask


def ctc_greedy_draft(ctc_logits: torch.Tensor, enc_lengths: torch.Tensor, max_len: int,
                     blank_id: int = 0, pad_id: int = 1, eos_id: int = 2) -> torch.Tensor:
    """(B, max_len) int32 draft: argmax per frame, repeats and blanks dropped (the
    first frame's predecessor counts as blank), the kept tokens left-packed, at
    most max_len - 1 of them, then EOS, then pad."""
    B, T, _ = ctc_logits.shape
    pred = ctc_logits.argmax(dim=-1)
    valid = lengths_to_mask(enc_lengths, T)
    prev = torch.cat([pred.new_full((B, 1), blank_id), pred[:, :-1]], dim=1)
    keep = (pred != blank_id) & (pred != prev) & valid
    order = torch.argsort(torch.where(keep, 0, 1), dim=1, stable=True)
    packed = pred.gather(1, order)
    n = keep.sum(dim=1).clamp(max=max_len - 1)[:, None]
    if T >= max_len:
        packed = packed[:, :max_len]
    else:
        packed = torch.cat([packed, packed.new_zeros((B, max_len - T))], dim=1)
    pos = torch.arange(max_len, device=pred.device)[None, :]
    draft = torch.where(pos < n, packed, pad_id)
    return torch.where(pos == n, eos_id, draft).to(torch.int32)


def jacobi_greedy_decode(decode_fn: Callable[[torch.Tensor], torch.Tensor], y0: torch.Tensor,
                         max_iters: Optional[int] = None, pad_id: int = 1, eos_id: int = 2,
                         bos_id: int = 2, blank_id: Optional[int] = 0, min_len: int = 1
                         ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Iterate y <- argmax(decode_fn(prev(y))) to the greedy fixpoint
    (s2t_tpu/inference/jacobi.py:76-157).

    decode_fn: (B, L) prev_tokens -> (B, L, V) logits (teacher-forced).  The
    argmax bans pad and blank everywhere and EOS before ``min_len``, as the beam
    engine does; after each pass the positions past a row's first EOS become pad
    and a row with no EOS gets one in its last slot.  Returns (tokens (B, L)
    int32, scores (B,): the summed log-probs of the non-pad tokens from one more
    pass, the number of passes)."""
    B, L = y0.shape
    max_iters = L if max_iters is None else max_iters
    dev = y0.device

    def masked_argmax(logits):
        logits = logits.clone()
        logits[:, :, pad_id] = -1e9
        if blank_id is not None and blank_id >= 0:
            logits[:, :, blank_id] = -1e9
        if min_len > 0:
            logits[:, :min_len, eos_id] = -1e9
        return logits.argmax(dim=-1).to(torch.int32)

    def mask_after_eos(y):
        is_eos = (y == eos_id).to(torch.int32)
        after = (is_eos.cumsum(dim=1) - is_eos) > 0  # strictly after the first EOS
        y = torch.where(after, pad_id, y)
        last = torch.where(is_eos.any(dim=1), y[:, -1], eos_id)
        return torch.cat([y[:, :-1], last[:, None]], dim=1)

    def prev_of(y):
        return torch.cat([torch.full((B, 1), bos_id, dtype=y.dtype, device=dev), y[:, :-1]],
                         dim=1)

    y = mask_after_eos(y0.to(torch.int32))
    iters = 0
    while iters < max_iters:
        new_y = mask_after_eos(masked_argmax(decode_fn(prev_of(y))))
        iters += 1
        changed = bool((new_y != y).any())
        y = new_y
        if not changed:
            break
    lp = torch.log_softmax(decode_fn(prev_of(y)).float(), dim=-1)
    tok_lp = lp.gather(2, y.long()[:, :, None])[:, :, 0]
    scores = torch.where(y != pad_id, tok_lp, 0.0).sum(dim=1)
    return y, scores, iters


class JacobiGenerator:
    """``SequenceGenerator``'s interface (``generate(batch)`` -> tokens (B, 1, L),
    scores (B, 1), the encoder dict) with greedy decoding by CTC-drafted Jacobi
    iteration (s2t_tpu/inference/jacobi.py:160-239): the tokens of beam-1
    decoding, the score the beam engine gives them (divided by the length,
    EOS included, to the power ``lenpen``).  A model with no CTC head starts
    from EOS at position 0.  ``last_iters``: the passes of the last batch."""

    def __init__(self, model, max_len_b: int = 200, max_len_a: float = 0.0,
                 max_target_positions: int = 1024, max_iters: Optional[int] = None,
                 min_len: int = 1, lenpen: float = 1.0, eos_id: int = 2, pad_id: int = 1,
                 blank_id: int = 0, input_keys: Tuple[str, str] = ("features", "feat_lengths")):
        self.model = model
        self.max_len_b = max_len_b
        self.max_len_a = max_len_a
        self.max_target_positions = max_target_positions
        self.max_iters = max_iters
        self.min_len = min_len
        self.lenpen = lenpen
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.blank_id = blank_id
        self.input_keys = input_keys
        self.last_iters = 0

    @torch.inference_mode()
    def generate(self, batch: Dict[str, Any]) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, Any]]:
        model = self.model
        dev = model.device
        feats = torch.as_tensor(batch[self.input_keys[0]], dtype=torch.float32).to(dev)
        lengths = torch.as_tensor(batch[self.input_keys[1]]).to(device=dev, dtype=torch.long)
        # the beam engine's horizon: max_len_a scales the subsampled encoder length
        enc_T = encoder_length_bound(model.cfg, feats.shape[1])
        max_len = int(min(self.max_len_a * enc_T + self.max_len_b, self.max_target_positions - 1))
        enc = model.encode(feats, lengths)
        enc_out = enc["encoder_out"]
        enc_mask = lengths_to_mask(enc["encoder_lengths"], enc_out.shape[1])
        if enc.get("ctc_logits") is not None:
            y0 = ctc_greedy_draft(enc["ctc_logits"].float(), enc["encoder_lengths"], max_len,
                                  self.blank_id, self.pad_id, self.eos_id)
        else:  # no CTC head: a cold start from EOS at position 0
            y0 = torch.full((enc_out.shape[0], max_len), self.pad_id, dtype=torch.int32,
                            device=dev)
            y0[:, 0] = self.eos_id
        y, scores, iters = jacobi_greedy_decode(
            lambda prev: model.decode(prev.long(), enc_out, enc_mask), y0,
            max_iters=self.max_iters, pad_id=self.pad_id, eos_id=self.eos_id,
            bos_id=self.eos_id, blank_id=self.blank_id, min_len=self.min_len)
        hyp_len = (y != self.pad_id).sum(dim=1).float().clamp(min=1.0)
        self.last_iters = iters
        return y[:, None, :], (scores / hyp_len.pow(self.lenpen))[:, None], enc

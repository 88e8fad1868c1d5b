"""CTC loss over a lattice of S = 2U + 1 states (counterpart of s2t_tpu/ops/ctc.py:29-302).

The emission gather stays plain PyTorch, as the JAX package leaves it to XLA;
the lattice recurrences run in ``ops/ctc_cuda.py`` (CUDA kernels K3/K4 on the
card, their plain versions on the CPU) for every input: there is no size gate.
The JAX head-input gather (``fused_head`` / ``return_fused``, :130-162) is not
ported: gathering the same emissions from the logits is the same math
(``_lattice_logp`` :38-64).
"""

from __future__ import annotations

import torch

from s2t_tpu_torch.ops.ctc_cuda import NEG_INF, ctc_nll


def _extend_labels(labels: torch.Tensor, blank_id: int) -> torch.Tensor:
    """(B, U) labels -> (B, 2U+1) blank-interleaved extended sequence."""
    B, U = labels.shape
    ext = torch.full((B, 2 * U + 1), blank_id, dtype=labels.dtype, device=labels.device)
    ext[:, 1::2] = labels
    return ext


def _transition_mask(ext_labels: torch.Tensor, blank_id: int) -> torch.Tensor:
    """(B, S) bool: True where the skip transition s-2 -> s is allowed (s is a
    label state whose label differs from the one at s-2)."""
    B, S = ext_labels.shape
    is_label = torch.arange(S, device=ext_labels.device) % 2 == 1
    prev2 = torch.cat([ext_labels.new_full((B, 2), -1), ext_labels[:, :-2]], dim=1)[:, :S]
    return is_label[None, :] & (ext_labels != prev2)


def _lattice_logp(log_probs: torch.Tensor, ext_labels: torch.Tensor,
                  normalized: bool = True) -> torch.Tensor:
    """Per-state emission scores (B, T, V), (B, S) -> (B, T, S) f32.
    ``normalized=False`` takes raw logits and subtracts the f32 logsumexp over V."""
    lp = log_probs.float()
    B, T, _ = lp.shape
    emit = lp.gather(2, ext_labels[:, None, :].expand(B, T, ext_labels.shape[1]))
    if not normalized:
        emit = emit - torch.logsumexp(lp, dim=-1)[:, :, None]
    return emit


def ctc_loss(log_probs: torch.Tensor, labels: torch.Tensor, input_lengths: torch.Tensor,
             label_lengths: torch.Tensor, blank_id: int = 0, reduction: str = "sum",
             zero_infinity: bool = True, normalized: bool = True) -> torch.Tensor:
    """Negative log-likelihood CTC loss (torch.nn.functional.ctc_loss semantics).

    log_probs: (B, T, V) log-softmax outputs, or raw logits with
    ``normalized=False``; labels: (B, U) padded arbitrarily past
    label_lengths; input_lengths, label_lengths: (B,).  ``zero_infinity``
    zeroes infeasible rows (nll > 5e29, non-finite, or fewer frames than
    labels); rows with zero frames always give 0."""
    if reduction not in ("sum", "mean", "none"):
        raise ValueError(f"reduction {reduction!r} not in ('sum', 'mean', 'none')")
    ext = _extend_labels(labels, blank_id)
    emit = _lattice_logp(log_probs, ext, normalized)
    skip_ok = _transition_mask(ext, blank_id)
    label_lengths = label_lengths.long()
    nll = ctc_nll(emit, skip_ok, input_lengths, 2 * label_lengths - 1, 2 * label_lengths)
    if zero_infinity:
        bad = (nll > -NEG_INF / 2) | ~torch.isfinite(nll) | (input_lengths < label_lengths)
        nll = torch.where(bad, 0.0, nll)
    nll = torch.where(input_lengths > 0, nll, 0.0)
    if reduction == "sum":
        return nll.sum()
    if reduction == "mean":
        return (nll / label_lengths.clamp(min=1)).mean()
    return nll

"""CTC loss over a lattice of S = 2U + 1 states, the imputer loss over a lattice
constrained to given states, the Viterbi best alignment and greedy CTC decoding
(counterpart of s2t_tpu/ops/ctc.py:29-340, :344-420 and :423-446).

The emission gather stays plain PyTorch, as the JAX package leaves it to XLA;
the lattice recurrences run in ``ops/ctc_cuda.py`` (CUDA kernels K3/K4 on the
card, their plain versions on the CPU) for every input: there is no size gate.
The JAX head-input gather (``fused_head`` / ``return_fused``, :130-162) is not
ported: gathering the same emissions from the logits is the same math
(``_lattice_logp`` :38-64).  ``ctc_best_alignment`` is a ``lax.scan`` outside any
Pallas kernel in JAX, so its counterpart is a plain PyTorch loop over T on
every device.  JAX computes ``imputer_loss`` with its own ``lax.scan``
(``ctc_forward_alphas(force_emits=)``, which the Pallas CTC kernel does not
take); here the imputer's constraint is folded into the emissions (every
state but the forced one emits NEG_INF), so the constrained lattice runs
through K3/K4 as ``ctc_loss`` does.
"""

from __future__ import annotations

from typing import Optional

import torch

from s2t_tpu_torch.ops.ctc_cuda import NEG_INF, ctc_alpha_plain, ctc_nll


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


def _constrain(emit: torch.Tensor, force_emits: torch.Tensor) -> torch.Tensor:
    """The imputer's constraint on (B, T, S) emissions: at frame t a row with
    force_emits (B, T) >= 0 keeps only that lattice state, and every other state
    emits NEG_INF.  The alphas are then JAX's ``where(keep, new, NEG_INF)``
    (s2t_tpu/ops/ctc.py:209-233) and the masked states get no gradient."""
    f = force_emits.to(emit.device).long()[:, :, None]
    state = torch.arange(emit.shape[2], device=emit.device)
    return torch.where((f < 0) | (state == f), emit, NEG_INF)


def _lattice_loss(log_probs, labels, input_lengths, label_lengths, blank_id, reduction,
                  zero_infinity, normalized, force_emits):
    if reduction not in ("sum", "mean", "none"):
        raise ValueError(f"reduction {reduction!r} not in ('sum', 'mean', 'none')")
    ext = _extend_labels(labels.long(), blank_id)
    emit = _lattice_logp(log_probs, ext, normalized)
    if force_emits is not None:
        emit = _constrain(emit, force_emits)
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


def ctc_loss(log_probs: torch.Tensor, labels: torch.Tensor, input_lengths: torch.Tensor,
             label_lengths: torch.Tensor, blank_id: int = 0, reduction: str = "sum",
             zero_infinity: bool = True, normalized: bool = True) -> torch.Tensor:
    """Negative log-likelihood CTC loss (torch.nn.functional.ctc_loss semantics).

    log_probs: (B, T, V) log-softmax outputs, or raw logits with
    ``normalized=False``; labels: (B, U) padded arbitrarily past
    label_lengths; input_lengths, label_lengths: (B,).  ``zero_infinity``
    zeroes infeasible rows (nll > 5e29, non-finite, or fewer frames than
    labels); rows with zero frames always give 0."""
    return _lattice_loss(log_probs, labels, input_lengths, label_lengths, blank_id, reduction,
                         zero_infinity, normalized, None)


def ctc_forward_alphas(log_probs: torch.Tensor, labels: torch.Tensor,
                       input_lengths: torch.Tensor, blank_id: int = 0,
                       force_emits: Optional[torch.Tensor] = None, normalized: bool = True):
    """The alpha recurrence in log space (s2t_tpu/ops/ctc.py:184-240): (final alpha
    (B, S) f32, extended labels (B, S)).  ``force_emits`` (B, T) int: at frame t
    a row with force_emits >= 0 keeps only that lattice state (the imputer's
    constraint).  Frames at or past a row's length carry alpha unchanged.  The
    plain alpha recurrence on every device, differentiable by autograd; states
    no path reaches read NEG_INF, as JAX's."""
    ext = _extend_labels(labels.long(), blank_id)
    emit = _lattice_logp(log_probs, ext, normalized)
    if force_emits is not None:
        emit = _constrain(emit, force_emits)
    skip = torch.where(_transition_mask(ext, blank_id), 0.0, NEG_INF)
    alphas = ctc_alpha_plain(emit.transpose(0, 1), skip, input_lengths.to(emit.device))
    return alphas[-1].clamp(min=NEG_INF), ext


def imputer_loss(log_probs: torch.Tensor, labels: torch.Tensor, force_emits: torch.Tensor,
                 input_lengths: torch.Tensor, label_lengths: torch.Tensor, blank_id: int = 0,
                 reduction: str = "sum", zero_infinity: bool = True) -> torch.Tensor:
    """CTC loss over the lattice constrained to ``force_emits`` (B, T) states where
    >= 0 (s2t_tpu/ops/ctc.py:305-340, torch_imputer's ``imputer_loss``); with no
    state forced it is the CTC loss.  log_probs: (B, T, V) log-softmax outputs.
    ``zero_infinity`` and the rows of zero frames as in ``ctc_loss``."""
    return _lattice_loss(log_probs, labels, input_lengths, label_lengths, blank_id, reduction,
                         zero_infinity, True, force_emits)


def ctc_best_alignment(log_probs: torch.Tensor, labels: torch.Tensor,
                       input_lengths: torch.Tensor, label_lengths: torch.Tensor,
                       blank_id: int = 0):
    """Viterbi best CTC alignment (s2t_tpu/ops/ctc.py:344-420): a max-product
    forward pass with back-pointers, then the backtrace.  Returns (aligned
    tokens (B, T) int32: the token the best path emits at each frame, blank at
    blank frames; lattice states (B, T) int32).

    JAX's tie order: the candidates stack as (stay, step1, step2) and the first
    maximum wins; the final state is the last label only when its score is
    strictly above the last blank's; frames at or past a row's length keep the
    final state.  One Python step a frame, no host sync."""
    lp = log_probs.float()
    B, T, _ = lp.shape
    dev = lp.device
    ext = _extend_labels(labels.long(), blank_id)
    S = ext.shape[1]
    emit = _lattice_logp(lp, ext)  # (B, T, S)
    skip_ok = _transition_mask(ext, blank_id)
    input_lengths = input_lengths.to(dev).long()
    label_lengths = label_lengths.to(dev).long()
    alpha = torch.full((B, S), NEG_INF, dtype=torch.float32, device=dev)
    alpha[:, 0] = emit[:, 0, 0]
    if S > 1:
        alpha[:, 1] = emit[:, 0, 1]
    pad = torch.full((B, 2), NEG_INF, dtype=torch.float32, device=dev)
    backs = []  # backs[t - 1]: the move into frame t, 0 stay / 1 step / 2 skip
    for t in range(1, T):
        step1 = torch.cat([pad[:, :1], alpha[:, :-1]], dim=1)
        step2 = torch.where(skip_ok, torch.cat([pad, alpha[:, :-2]], dim=1)[:, :S], NEG_INF)
        best = torch.maximum(alpha, torch.maximum(step1, step2))
        back = torch.where(alpha >= best, 0, torch.where(step1 >= step2, 1, 2))
        active = (t < input_lengths)[:, None]
        alpha = torch.where(active, best + emit[:, t], alpha)
        backs.append(torch.where(active, back, 0).to(torch.uint8))
    last_label = (2 * label_lengths - 1).clamp(min=0)
    last_blank = 2 * label_lengths
    a_label = alpha.gather(1, last_label[:, None])[:, 0]
    a_label = torch.where(label_lengths > 0, a_label, NEG_INF)
    a_blank = alpha.gather(1, last_blank[:, None])[:, 0]
    state = torch.where(a_label > a_blank, last_label, last_blank)
    states = [state] * T
    for t in range(T - 1, 0, -1):
        states[t] = state
        delta = backs[t - 1].gather(1, state[:, None])[:, 0].long()
        state = torch.where(t < input_lengths, state - delta, state)
    states[0] = state
    states = torch.minimum(torch.stack(states, dim=1), 2 * label_lengths[:, None])
    return ext.gather(1, states).to(torch.int32), states.to(torch.int32)


def ctc_greedy_decode(log_probs_or_logits: torch.Tensor, input_lengths: torch.Tensor,
                      blank_id: int = 0, pad_id: int = 1):
    """Greedy CTC decode in tensor ops, with no host sync (counterpart of
    s2t_tpu/ops/ctc.py:423-446): argmax per frame, repeats collapsed, blanks
    dropped, the kept tokens left-packed into a (B, T) int32 buffer padded
    with ``pad_id``.  Returns (tokens, lengths (B,) int32)."""
    B, T = log_probs_or_logits.shape[:2]
    pred = log_probs_or_logits.argmax(dim=-1).to(torch.int32)  # first index of a tie, as jnp
    valid = torch.arange(T, device=pred.device)[None, :] < input_lengths.to(pred.device)[:, None]
    prev = torch.cat([pred.new_full((B, 1), -1), pred[:, :-1]], dim=1)
    keep = (pred != blank_id) & (pred != prev) & valid
    pos = keep.to(torch.int32).cumsum(dim=1) - 1  # the slot of each kept frame
    # dropped frames write to a spare column T, cut off after the scatter
    slot = torch.where(keep, pos, T).long()
    out = pred.new_full((B, T + 1), pad_id).scatter_(1, slot, pred)
    return out[:, :T], keep.sum(dim=1, dtype=torch.int32)

"""On-device CTC prefix scorer for joint CTC/attention beam decoding
(counterpart of s2t_tpu/inference/ctc_prefix.py:1-181).

Per hypothesis the state is (N, 2, T): the log-probs of the prefix ending in
non-blank / blank at each frame, the carried prefix score psi and the last
token.  Scoring kc candidate extensions runs the forward recurrence

    r_nb[t] = x_c[t] + (r_nb[t-1] (+) phi[t-1])
    r_b[t]  = x_b[t] + (r_b[t-1] (+) r_nb[t-1])

as a log-semiring scan over 3 x 3 transition matrices, in the recursive
odd / even tree of ``jax.lax.associative_scan`` (2 ceil(log2 T) batched levels,
no step per frame).  Frames past the input length are frozen (blank 0, the
rest -1e9); EOS takes the complete-sequence score, a blank candidate -1e9.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

NEG = -1e9


def log_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Log-semiring product over the last two dims: (..., i, k) (x) (..., k, j)."""
    return torch.logsumexp(a[..., :, :, None] + b[..., None, :, :], dim=-2)


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], ... along dim 0 (len(even) - len(odd) is 0 or 1)."""
    n = even.shape[0] + odd.shape[0]
    out = even.new_empty((n,) + even.shape[1:])
    out[0::2] = even
    out[1::2] = odd
    return out


def prefix_products(m: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of ``m`` (T, ..., 3, 3) along dim 0 under s[t] = M[t] (x) s[t-1]:
    out[t] = M[t] (x) ... (x) M[0], in the combine tree of ``jax.lax.associative_scan``."""
    n = m.shape[0]
    if n < 2:
        return m
    # combine adjacent pairs (the later matrix on the left), scan the halves, fill the evens
    odd = prefix_products(log_matmul(m[1::2], m[0:n - 1:2]))
    rest = m[2::2]
    even = log_matmul(rest, odd[:rest.shape[0]])
    return _interleave(torch.cat([m[:1], even]), odd)


class CTCPrefixState(NamedTuple):
    r: torch.Tensor  # (N, 2, T): [0] r_nb, [1] r_b of the current prefix
    psi: torch.Tensor  # (N,) carried prefix score
    last: torch.Tensor  # (N,) last token of the prefix (-1 if empty)


class CTCPrefixScorer:
    """Batched prefix scorer bound to one batch's CTC log-probs (B, T, V)
    and lengths (B,), expanded to ``beam_size`` hypotheses a row."""

    def __init__(self, ctc_log_probs: torch.Tensor, lengths: torch.Tensor, beam_size: int,
                 blank_id: int = 0, eos_id: int = 2):
        B, T, V = ctc_log_probs.shape
        dev = ctc_log_probs.device
        lp = ctc_log_probs.float()
        valid = (torch.arange(T, device=dev)[None, :] < lengths.to(dev)[:, None])[..., None]
        frozen = torch.full((V,), NEG, device=dev)
        frozen[blank_id] = 0.0
        # one copy a batch row, not a beam: the candidates' columns are gathered per row
        self.lp = torch.where(valid, lp, frozen)  # (B, T, V)
        self.lp_blank = self.lp[:, :, blank_id].repeat_interleave(beam_size, dim=0)  # (N, T)
        self.blank_id, self.eos_id = blank_id, eos_id
        self.B, self.K, self.T, self.V = B, beam_size, T, V

    def init_state(self) -> CTCPrefixState:
        N, T = self.B * self.K, self.T
        dev = self.lp.device
        # the empty prefix: r_b is the cumulative blank, r_nb impossible
        r = torch.stack([torch.full((N, T), NEG, device=dev), self.lp_blank.cumsum(dim=1)], dim=1)
        return CTCPrefixState(r=r, psi=torch.zeros((N,), device=dev),
                              last=torch.full((N,), -1, dtype=torch.long, device=dev))

    def score_candidates(self, state: CTCPrefixState, cand: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Score kc candidate extensions (``cand`` (N, kc)) of every hypothesis.
        Returns delta (N, kc) = psi(g.c) - psi(g) (EOS: the complete-sequence
        score; blank: -1e9), the candidates' lattices (N, kc, 2, T) and their
        psi (N, kc)."""
        N, kc = cand.shape
        T = self.T
        r_nb_prev, r_b_prev = state.r[:, 0], state.r[:, 1]  # (N, T)
        # phi[t] = r_b_prev[t] (+) (c != last: r_nb_prev[t]); shifted one frame right,
        # phi[-1] = 0 for the empty prefix
        same = cand == state.last[:, None]
        phi = torch.where(same[..., None], r_b_prev[:, None, :],
                          torch.logaddexp(r_b_prev, r_nb_prev)[:, None, :])
        phi_init = torch.where(state.last < 0, 0.0, NEG)
        phi_prev = torch.cat([phi_init[:, None, None].expand(N, kc, 1), phi[..., :-1]], dim=-1)
        B, K = self.B, self.K
        x_c = torch.gather(self.lp, 2, cand.reshape(B, 1, K * kc).expand(B, T, K * kc))
        x_c = x_c.reshape(B, T, K, kc).permute(0, 2, 3, 1).reshape(N, kc, T)
        x_b = self.lp_blank[:, None, :].expand(N, kc, T)

        # the transition matrices, built once per step, frames leading
        m = torch.full((T, N, kc, 3, 3), NEG, device=cand.device)
        m[..., 0, 0] = x_c.permute(2, 0, 1)
        m[..., 0, 2] = (x_c + phi_prev).permute(2, 0, 1)
        m[..., 1, 0] = x_b.permute(2, 0, 1)
        m[..., 1, 1] = x_b.permute(2, 0, 1)
        m[..., 2, 2] = 0.0
        p = prefix_products(m)
        new_r = p[..., :2, 2].permute(1, 2, 3, 0)  # (N, kc, 2, T)

        psi_new = torch.logsumexp(phi_prev + x_c, dim=-1)  # (N, kc)
        delta = psi_new - state.psi[:, None]
        complete = torch.logaddexp(r_b_prev[:, -1], r_nb_prev[:, -1])
        delta = torch.where(cand == self.eos_id, (complete - state.psi)[:, None], delta)
        delta = torch.where(cand == self.blank_id, NEG, delta)
        return delta, new_r, psi_new

    def select(self, state: CTCPrefixState, cand: torch.Tensor, new_r: torch.Tensor,
               psi_new: torch.Tensor, parent_idx: torch.Tensor, cand_pos: torch.Tensor,
               selected_tok: torch.Tensor) -> CTCPrefixState:
        """The state of each selected (parent beam, candidate slot) pair;
        ``parent_idx``, ``cand_pos``, ``selected_tok``: (B, K)."""
        B, K = parent_idx.shape
        rows = (torch.arange(B, device=parent_idx.device)[:, None] * K + parent_idx).reshape(-1)
        slots = cand_pos.reshape(-1)
        return CTCPrefixState(r=new_r[rows, slots], psi=psi_new[rows, slots],
                              last=selected_tok.reshape(-1).long())

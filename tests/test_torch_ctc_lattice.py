"""K4's lattice mapping on the CPU: a numpy emulation of ``ctc_beta_grad_warps_kernel``.

The kernel (``s2t_tpu_torch/csrc/ctc_lattice.cu``) runs only on the card.  This
emulation follows its mapping step by step, so that a fault in the mapping shows
here against ``ctc_beta_grad_plain``:

* one CTA a batch row of W = ceil(S / 32) warps, thread s holding state s (one
  state a lane), beta in a register, NEG_INF on the lanes past the lattice;
* ``__shfl_down_sync`` for the shift-by-1 and shift-by-2 inputs, which past the
  warp returns the lane's own value: lanes 30-31 replace it from the boundary slot
  that the warp above filled this step, or with NEG_INF in the last warp;
* the boundary slot double-buffered by the step's parity: after the step's
  barrier the emulation scribbles NaN into the other parity's slots, as a warp
  that runs ahead into the next step may write them before a slow warp reads;
* the cp.async ring of ``PREFETCH`` (emit, alpha) slots filled NaN, a fetch's
  copies landing only at the ``cp.async.wait_group`` that covers them, for the
  row's frames in descending order, one commit group a step, zero fill past the
  row and past the lattice; each step reads the next step's slot at its end;
* zero gradients at and past each row's length, beta ``final`` there.

The mapping is numpy; the arithmetic per state is the plain version's own torch
exp and logaddexp (the kernel's expf and log1pf formula), so the two agree to
float32 rounding, and the tolerance 1e-6 would not hold a wrong neighbour, slot
or frame.
"""

from __future__ import annotations

import re
from collections import deque
from pathlib import Path

import numpy as np
import pytest
import torch

from s2t_tpu_torch.ops import ctc_cuda
from s2t_tpu_torch.ops.ctc import _extend_labels, _lattice_logp, _transition_mask
from s2t_tpu_torch.ops.ctc_cuda import NEG_INF, ctc_alpha_plain, ctc_beta_grad_plain
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

PREFETCH = 16  # ctc_lattice.cu's ring depth
ATOL = 1e-6


def _exp(x):
    return torch.exp(torch.from_numpy(x)).numpy()


def _logaddexp(a, b):
    """The kernel's logaddexp, max(a, b) + log1p(exp(-|a - b|)), as torch computes it
    for the plain version (numpy's exp and log1p round differently in the last bit)."""
    return torch.logaddexp(torch.from_numpy(a), torch.from_numpy(b)).numpy()


def _shfl_down(x, d):
    """__shfl_down_sync over the lanes of every warp (last axis): a lane whose
    source lies past the warp keeps its own value."""
    out = x.copy()
    out[..., :32 - d] = x[..., d:]
    return out


def emulate_beta_grad_warps(emit, alphas, skip, final, lengths, logz):
    """ctc_beta_grad_warps_kernel over numpy float32 arrays: emit, alphas (T, B, S);
    skip, final (B, S); lengths (B,); logz (B,).  Returns demit (T, B, S)."""
    T, B, S = emit.shape
    W = -(-S // 32)
    N = 32 * W
    f32 = np.float32
    s = np.arange(N)
    valid = s < S
    steps = np.clip(lengths.astype(np.int64), 0, T)
    demit = np.full((T, B, S), np.nan, f32)
    pad = np.full((B, N - S), NEG_INF, f32)
    sk = np.concatenate([skip[:, 2:], np.full((B, min(2, S)), NEG_INF, f32), pad], 1)[:, :N]
    bt = np.concatenate([final, pad], 1).reshape(B, W, 32)
    sk = sk.reshape(B, W, 32)
    lz = logz.astype(f32)[:, None, None]
    for b in range(B):  # frames at or past the length, before the walk
        demit[steps[b]:, b] = 0.0
    # boundary slots [parity][warp w][0-1]: lanes 0-1's z of warp w + 1; the last warp's stay NEG_INF
    edge = np.full((2, B, W, 2), NEG_INF, f32)
    ring = np.full((PREFETCH, B, N, 2), np.nan, f32)  # uninitialised shared memory
    groups = deque()  # committed, not yet landed: (slot, rows, values)

    def fetch(k):  # step k's (emit, alpha) of frame steps - 1 - k, into slot k % PREFETCH
        vals = np.zeros((B, N, 2), f32)  # zero fill past the lattice and past a row's steps
        rows = np.nonzero(k < steps)[0]
        t = steps[rows] - 1 - k
        vals[rows, :S, 0] = emit[t, rows]
        vals[rows, :S, 1] = alphas[t, rows]
        groups.append((k % PREFETCH, vals))

    def wait(pending):  # cp.async.wait_group: land all but the `pending` newest groups
        while len(groups) > pending:
            slot, vals = groups.popleft()
            ring[slot] = vals

    for k in range(PREFETCH - 1):
        fetch(k)
    wait(PREFETCH - 2)
    ea = ring[0].copy()
    for k in range(int(steps.max(initial=0))):
        active = k < steps  # a row whose walk has ended takes no more steps
        e, al = ea[..., 0].reshape(B, W, 32), ea[..., 1].reshape(B, W, 32)
        with np.errstate(over="ignore", invalid="ignore"):
            g = -_exp(al + bt - lz)
            z = bt + e
            n1, n2 = _shfl_down(z, 1), _shfl_down(z, 2)
            if W == 1:
                n1[..., 31] = NEG_INF
                n2[..., 30:] = NEG_INF
            else:
                cur, other = edge[k & 1], edge[(k + 1) & 1]
                cur[:, :W - 1] = z[:, 1:, :2]  # warp w > 0's lanes 0-1 into warp w - 1's slot
                # __syncthreads; a warp may run ahead into step k + 1's writes
                other[:, :W - 1] = np.nan
                n1[..., 31] = cur[..., 0]
                n2[..., 31] = cur[..., 1]
                n2[..., 30] = cur[..., 0]
            nw = _logaddexp(_logaddexp(z, n1), n2 + sk)
        new = np.where(valid.reshape(W, 32), nw, f32(NEG_INF)).astype(f32)
        bt = np.where(active[:, None, None], new, bt)
        for b in np.nonzero(active)[0]:
            demit[steps[b] - 1 - k, b] = g[b].reshape(N)[:S]
        # the next step's values, read at the end of this one
        fetch(k + PREFETCH - 1)  # into the slot step k - 1 read
        wait(PREFETCH - 2)
        ea = ring[(k + 1) % PREFETCH].copy()
    return demit


def lattice_case(B, T, U, V, seed, any_skip=False):
    """Seeded ragged rows as chip_smoke.ctc_case makes them, on the CPU: row 0 the
    longest with repeated labels, row 1 infeasible (U repeats of one label in U + 1
    frames, when U > 2), the last row of length 0.  ``any_skip`` allows the skip
    s - 2 -> s at random states (the kernels take any skip table; CTC's allows it
    only into labels, so a blank state's shift-by-2 input never counts there).
    Returns the plain version's inputs as float32 / int32 tensors."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(3, V, size=(B, U))
    labels[0, 1::2] = labels[0, 0::2][: U // 2]
    labels[1] = 5
    label_lengths = rng.integers(U // 2, U + 1, size=B)
    input_lengths = rng.integers(min(max(T // 2, U + 2), T), T + 1, size=B)
    label_lengths[:2] = U
    input_lengths[0], input_lengths[1], input_lengths[-1] = T, min(U + 1, T), 0
    logits = torch.as_tensor(rng.normal(size=(B, T, V)), dtype=torch.float32)
    ext = _extend_labels(torch.as_tensor(labels), 0)
    S = ext.shape[1]
    emit = _lattice_logp(logits, ext, normalized=False).transpose(0, 1).contiguous()
    skip_ok = torch.as_tensor(rng.random((B, S)) < 0.5) if any_skip else _transition_mask(ext, 0)
    skip = torch.where(skip_ok, 0.0, NEG_INF).float()
    lengths = torch.as_tensor(input_lengths, dtype=torch.int32)
    ll = torch.as_tensor(label_lengths)
    state = torch.arange(S)[None, :]
    final = torch.where((state == 2 * ll[:, None] - 1) | (state == 2 * ll[:, None]),
                        0.0, NEG_INF).float()
    alphas = ctc_alpha_plain(emit, skip, lengths)
    last = alphas[-1]
    a_label = torch.where(ll > 0, last.gather(1, (2 * ll - 1).clamp(min=0)[:, None])[:, 0],
                          NEG_INF)
    logz = torch.logaddexp(a_label, last.gather(1, (2 * ll)[:, None])[:, 0])
    return emit, alphas, skip, final, lengths, logz


# label counts U of S = 2U + 1 = 1, 3, 31, 33, 63, 65, 127, 129, 1023: one warp, then the
# steps to 2, 3, 4 and 5 warps, and 32 warps, the widest lattice the kernel takes
@pytest.mark.parametrize("U, any_skip", [(0, False), (1, False), (15, False), (16, False),
                                         (31, False), (32, False), (63, False), (64, False),
                                         (511, False), (16, True), (64, True)])
def test_k4_warps_mapping_matches_plain(U, any_skip):
    T = 2 * U + 2 if U > 64 else max(12, 2 * U + 4)
    emit, alphas, skip, final, lengths, logz = lattice_case(4, T, U, 12, seed=100 + U,
                                                            any_skip=any_skip)
    S = emit.shape[2]
    assert S == 2 * U + 1 and ctc_cuda.beta_grad_kernel(S) == "ctc_beta_grad_warps_kernel"
    want = ctc_beta_grad_plain(emit, alphas, skip, final, lengths, logz).numpy()
    got = emulate_beta_grad_warps(*(x.numpy() for x in (emit, alphas, skip, final, lengths, logz)))
    assert not np.isnan(got).any()  # every frame of every row written, no slot read unfilled
    assert np.abs(got - want).max() <= ATOL
    assert (got[:, -1] == 0).all()  # the 0-length row
    if U > 2 and not any_skip:  # row 1 cannot emit its U repeats in U + 1 frames
        assert logz[1] < -5e29


@pytest.mark.parametrize("S, kernel", [(1, "ctc_beta_grad_warps_kernel"),
                                       (33, "ctc_beta_grad_warps_kernel"),
                                       (1023, "ctc_beta_grad_warps_kernel"),
                                       (1024, "ctc_beta_grad_warps_kernel"),
                                       (1025, "ctc_beta_grad_kernel"),
                                       (4001, "ctc_beta_grad_kernel")])
def test_k4_dispatch_is_by_lattice_width(S, kernel):
    assert ctc_cuda.BETA_WARPS_MAX_S == 1024
    assert ctc_cuda.beta_grad_kernel(S) == kernel
    assert ctc_cuda.BETA_ENTRIES[kernel] in ctc_cuda._SIGNATURES


def test_k4_threshold_is_the_kernels():
    """The wrapper's threshold is the one the C entry holds: the entry refuses a wider S."""
    src = (Path(ctc_cuda.__file__).resolve().parent.parent / "csrc" / "ctc_lattice.cu").read_text()
    found = re.findall(r"constexpr int BETA_WARPS_MAX_S = (\d+);", src)
    assert found == [str(ctc_cuda.BETA_WARPS_MAX_S)]

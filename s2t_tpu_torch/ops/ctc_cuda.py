"""CTC lattice: hand-written CUDA kernels (K3, K4) and their plain versions.

Counterpart of ``s2t_tpu/ops/ctc_pallas.py:59-217``: the negative
log-likelihood of a dense emission table as a ``torch.autograd.Function``
whose forward runs the alpha recurrence (``ctc_alpha``, K3) and then logZ,
and whose backward runs the reverse beta recurrence fused with the emission
gradient (``ctc_beta_grad``, K4) and scales it by the upstream gradient per
row.  Kernel source: ``s2t_tpu_torch/csrc/ctc_lattice.cu`` (design and bound
in its header note).

Each wrapper runs its plain version (``ctc_alpha_plain``,
``ctc_beta_grad_plain``: the same contracts in torch ops) for a CPU tensor
and launches its kernel for a CUDA tensor, or raises.  f32 log-space with
NEG_INF = -1e30, the JAX package's arithmetic.

K3 dispatches on the lattice width: S <= ``WARP_MAX_S`` (256) runs one warp
per batch row with the states in registers and no barrier
(``ctc_alpha_warp_kernel``); a wider lattice runs one CTA per row with the
states across its threads (``ctc_alpha_kernel``).  Both count as K3
launches.

K4 dispatches on the lattice width too (``beta_grad_kernel``): S <=
``BETA_WARPS_MAX_S`` (1024) runs one CTA per batch row of ceil(S / 32) warps,
one state a lane with beta in a register, shuffles inside a warp and one
barrier a step for the two values that cross into the warp below (none at S
<= 32), the emissions and alphas arriving through a cp.async ring
(``ctc_beta_grad_warps_kernel``); a wider lattice runs the CTA-wide
``ctc_beta_grad_kernel``.  Both count as K4 launches.
"""

from __future__ import annotations

import ctypes

import torch

from s2t_tpu_torch.ops import _build

NEG_INF = -1e30
WARP_MAX_S = 256  # the widest lattice one warp walks (8 states a lane)
BETA_WARPS_MAX_S = 1024  # the widest lattice K4 walks one state a lane (32 warps)
# K4's kernels and their C entry points
BETA_ENTRIES = {"ctc_beta_grad_warps_kernel": "s2t_ctc_beta_grad_warps",
                "ctc_beta_grad_kernel": "s2t_ctc_beta_grad"}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "s2t_ctc_alpha": (_I, [_P, _P, _P, _P, _I, _I, _I, _P]),
    "s2t_ctc_beta_grad_warps": (_I, [_P] * 7 + [_I, _I, _I, _P]),
    "s2t_ctc_beta_grad": (_I, [_P] * 7 + [_I, _I, _I, _P]),
    "s2t_ctc_chain_floor": (_I, [_P, _I, _I, _I, _P]),
    "s2t_cuda_error_string": (ctypes.c_char_p, [_I]),
}


def _shift_right(x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, S) -> x[:, s - n], NEG_INF for s < n."""
    return torch.cat([x.new_full((x.shape[0], n), NEG_INF), x[:, :-n]], dim=1)[:, : x.shape[1]]


def _shift_left(x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, S) -> x[:, s + n], NEG_INF for s + n >= S."""
    return torch.cat([x[:, n:], x.new_full((x.shape[0], n), NEG_INF)], dim=1)[:, : x.shape[1]]


def ctc_alpha_plain(emit: torch.Tensor, skip: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """emit (T, B, S) f32; skip (B, S) f32 additive {0, NEG_INF}; lengths (B,)
    int.  Returns every alpha row, (T, B, S) f32 (``_alpha_kernel``)."""
    T, B, S = emit.shape
    state = torch.arange(S, device=emit.device)
    alpha = torch.where(state[None, :] < 2, emit[0], NEG_INF)
    rows = [alpha]
    for t in range(1, T):
        new = torch.logaddexp(torch.logaddexp(alpha, _shift_right(alpha, 1)),
                              _shift_right(alpha, 2) + skip) + emit[t]
        alpha = torch.where((t < lengths)[:, None], new, alpha)
        rows.append(alpha)
    return torch.stack(rows)


def ctc_beta_grad_plain(emit, alphas, skip, final, lengths, logz) -> torch.Tensor:
    """emit, alphas (T, B, S) f32; skip, final (B, S) f32; lengths (B,) int;
    logz (B,) f32.  Returns d(-logZ)/d emit, (T, B, S) f32
    (``_beta_grad_kernel``)."""
    T = emit.shape[0]
    skip_from = _shift_left(skip, 2)
    beta = final
    demit = torch.empty_like(emit)
    for t in range(T - 1, -1, -1):
        g = -torch.exp(alphas[t] + beta - logz[:, None])
        demit[t] = torch.where((t < lengths)[:, None], g, 0.0)
        z = beta + emit[t]
        comb = torch.logaddexp(torch.logaddexp(z, _shift_left(z, 1)), _shift_left(z, 2) + skip_from)
        beta = torch.where((t <= lengths - 1)[:, None], comb, beta)
    return demit


def _check(name, tensors, ints):
    if not all(t.is_cuda for t in tensors + ints):
        raise ValueError(f"{name}: every input must be a CUDA tensor")
    if len({t.device for t in tensors + ints}) != 1:
        raise ValueError(f"{name}: tensors are on different devices")
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: lattice tensors must be contiguous float32")
    if any(t.dtype != torch.int32 or not t.is_contiguous() for t in ints):
        raise ValueError(f"{name}: lengths must be contiguous int32")


def _launch(lib, fn, *args):
    rc = fn(*args)
    if rc != 0:
        msg = lib.s2t_cuda_error_string(rc).decode()
        raise RuntimeError(f"{fn.__name__} launch failed: {msg} (cudaError {rc})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ctc_alpha(emit: torch.Tensor, skip: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """K3.  Same contract as ``ctc_alpha_plain`` (lengths int32 on the card)."""
    if emit.device.type == "cpu":
        return ctc_alpha_plain(emit, skip, lengths)
    lib = _build.load_library("ctc_lattice", _SIGNATURES)
    _check("ctc_alpha", [emit, skip], [lengths])
    T, B, S = emit.shape
    if skip.shape != (B, S) or lengths.shape != (B,):
        raise ValueError(f"ctc_alpha: skip {tuple(skip.shape)} / lengths {tuple(lengths.shape)} "
                         f"do not fit emit {tuple(emit.shape)}")
    alphas = torch.empty_like(emit)
    with torch.cuda.device(emit.device):
        _launch(lib, lib.s2t_ctc_alpha, emit.data_ptr(), skip.data_ptr(), lengths.data_ptr(),
                alphas.data_ptr(), T, B, S, _stream(emit))
    ctc_alpha.launches += 1
    return alphas


def ctc_chain_floor(steps: int, S: int, device, beta: bool = False) -> None:
    """Launch the chain-floor measurement: one warp runs ``steps - 1``
    dependent alpha steps (K3's, ceil(S / 32) states a lane, S <=
    ``WARP_MAX_S``), or with ``beta`` beta steps with their gradient entries
    (K4's, one state a lane, S <= 32), of an S-state row on register values,
    with no loads.  Its device time is the least a chain of that many steps
    can take; it is no kernel of the training path and counts no launch."""
    lib = _build.load_library("ctc_lattice", _SIGNATURES)
    out = torch.empty((S,), dtype=torch.float32, device=device)
    with torch.cuda.device(out.device):
        _launch(lib, lib.s2t_ctc_chain_floor, out.data_ptr(), steps, S, int(beta), _stream(out))


def beta_grad_kernel(S: int) -> str:
    """The K4 kernel that an S-state lattice runs (the dispatch rule)."""
    return "ctc_beta_grad_warps_kernel" if S <= BETA_WARPS_MAX_S else "ctc_beta_grad_kernel"


def ctc_beta_grad(emit, alphas, skip, final, lengths, logz) -> torch.Tensor:
    """K4.  Same contract as ``ctc_beta_grad_plain`` (lengths int32 on the card);
    the kernel is ``beta_grad_kernel(S)``'s."""
    if emit.device.type == "cpu":
        return ctc_beta_grad_plain(emit, alphas, skip, final, lengths, logz)
    lib = _build.load_library("ctc_lattice", _SIGNATURES)
    _check("ctc_beta_grad", [emit, alphas, skip, final, logz], [lengths])
    T, B, S = emit.shape
    if (alphas.shape != emit.shape or skip.shape != (B, S) or final.shape != (B, S)
            or lengths.shape != (B,) or logz.shape != (B,)):
        raise ValueError("ctc_beta_grad: shapes do not fit emit (T, B, S) = "
                         f"{tuple(emit.shape)}")
    demit = torch.empty_like(emit)
    with torch.cuda.device(emit.device):
        entry = getattr(lib, BETA_ENTRIES[beta_grad_kernel(S)])
        _launch(lib, entry, emit.data_ptr(), alphas.data_ptr(), skip.data_ptr(),
                final.data_ptr(), lengths.data_ptr(), logz.data_ptr(), demit.data_ptr(),
                T, B, S, _stream(emit))
    ctc_beta_grad.launches += 1
    return demit


def _logz(alphas, last_label, last_blank):
    """log-likelihood from the last alpha row (``_logz``, ctc_pallas.py:148-153)."""
    final = alphas[-1]
    a_label = final.gather(1, last_label.clamp(min=0)[:, None])[:, 0]
    a_label = torch.where(last_label >= 0, a_label, NEG_INF)
    a_blank = final.gather(1, last_blank[:, None])[:, 0]
    return torch.logaddexp(a_label, a_blank)


class _CTCNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, emit, skip_ok, input_lengths, last_label, last_blank):
        emit_t = emit.float().transpose(0, 1).contiguous()  # (T, B, S)
        skip = torch.where(skip_ok, 0.0, NEG_INF).float().contiguous()
        lengths = input_lengths.to(torch.int32).contiguous()
        alphas = ctc_alpha(emit_t, skip, lengths)
        logz = _logz(alphas, last_label.long(), last_blank.long()).contiguous()
        ctx.save_for_backward(emit_t, alphas, skip, lengths, logz, last_label, last_blank)
        ctx.emit_dtype = emit.dtype
        return -logz

    @staticmethod
    def backward(ctx, g):
        emit_t, alphas, skip, lengths, logz, last_label, last_blank = ctx.saved_tensors
        state = torch.arange(emit_t.shape[2], device=emit_t.device)[None, :]
        final = torch.where((state == last_label[:, None]) | (state == last_blank[:, None]),
                            0.0, NEG_INF).float().contiguous()
        demit = ctc_beta_grad(emit_t, alphas, skip, final, lengths, logz)
        grad = demit.transpose(0, 1) * g.float()[:, None, None]
        return grad.to(ctx.emit_dtype), None, None, None, None


def ctc_nll(emit, skip_ok, input_lengths, last_label, last_blank) -> torch.Tensor:
    """Per-row CTC negative log-likelihood, differentiable in ``emit``.

    emit (B, T, S) emission log-scores; skip_ok (B, S) bool; input_lengths,
    last_label (2L - 1), last_blank (2L): (B,) int.  Returns (B,) f32."""
    return _CTCNLL.apply(emit, skip_ok, input_lengths, last_label, last_blank)


# kernel launches since the last reset; chip_smoke.py reads them to show the
# training path went through the kernels
ctc_alpha.launches = 0
ctc_beta_grad.launches = 0

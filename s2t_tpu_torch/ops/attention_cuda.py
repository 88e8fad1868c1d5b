"""Fused encoder self-attention: hand-written CUDA kernels and their plain version.

Counterpart of ``s2t_tpu/ops/attention_pallas.py``:
``softmax(Q K^T / sqrt(D) + padding_bias) V`` for non-causal self-attention
with a pure padding mask and uint8-threshold attention dropout, never
materialising the (B, H, T, T) probabilities.

* forward  ``csrc/attention_fwd.cu`` (K1f/K2f): the output and, when a
  gradient is needed, the per-row log-sum-exp (B, H, T) f32 and the output
  in f32 (for bf16, O before its rounding);
* backward ``csrc/attention_bwd.cu`` (K1b/K2b): dQ, dK, dV from Q, K, V, the
  f32 O, dO and the log-sum-exp, regenerating the dropout mask.  Its
  Delta = rowsum(dO o O) reads the f32 O: from the bf16 O, a row whose
  probability sits on one key keeps ~2^-9 |dO V| per query in dS where the
  exact value is 0.

bfloat16 runs on the tensor cores (``mma.sync``, ``ldmatrix``, ``cp.async``),
float32 on f32 FMAs; design and bound of each kernel are in its source's
header note.  Both take every head dim 1 <= D <= ``MAX_HEAD_DIM`` (128): they
are compiled for the padded dims ``PADDED_HEAD_DIMS`` and zero-fill the
columns past the real D, and they read q/k/v/dO at any element alignment (16-,
4- or 2-byte copies, as the rows allow).  A head dim above 128 and T >= 65536
raise by name.

Dropout bits come from a counter-based hash keyed by a 64-bit seed (a (1,)
int64 tensor on the device) and counted by (batch, head, query, key):

    stream = mix(mix(seed_lo ^ mix(b * H + h)) ^ seed_hi)
    bits   = mix(stream ^ mix(query << 16 | key))          (T < 65536)
    keep   = bits >> 24 >= k,   k = min(round(rate * 256), 255)

with ``mix`` the 32-bit "lowbias32" integer hash.  ``keep_mask`` computes the
same bits with torch integer ops, so the kernels and the plain version drop
the same entries; neither gives JAX's bits (those come from the TPU's PRNG).

``fused_attention`` is differentiable.  A CPU tensor runs
``fused_attention_plain`` (autograd gives its backward); a CUDA tensor
launches the kernels or raises.  There is no other fallback.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from s2t_tpu_torch.modules.dropout import threshold_u8
from s2t_tpu_torch.ops import _build
from s2t_tpu_torch.utils.masking import mask_to_lengths

NEG = -1e9
MAX_HEAD_DIM = 128
# the instantiations of csrc/attention_{fwd,bwd}.cu: D runs the smallest that holds it
PADDED_HEAD_DIMS = (32, 48, 64, 80, 96, 112, 128)
MAX_T = 1 << 16  # the dropout counter packs (query, key) into 32 bits
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_FWD_SIGNATURES = {
    # q, k, v, o, lse, o32, lengths, seed, B, T, H, D, dtype, rate_u8, strides q/k/v/o,
    # scale, keep_scale, stream
    "s2t_attention_fwd": (
        _I, [_P] * 8 + [_I] * 6 + [_L] * 12 + [_F, _F, _P],
    ),
    "s2t_cuda_error_string": (ctypes.c_char_p, [_I]),
}
_BWD_SIGNATURES = {
    # q, k, v, o, do, lse, delta, dq, dk, dv, lengths, seed, B, T, H, D, dtype, rate_u8,
    # strides q/k/v/o/do/dq/dk/dv, scale, keep_scale, stream
    "s2t_attention_bwd": (
        _I, [_P] * 12 + [_I] * 6 + [_L] * 24 + [_F, _F, _P],
    ),
    "s2t_cuda_error_string": (ctypes.c_char_p, [_I]),
}

_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 tensors holding uint32 values, in 16-bit
    halves so no intermediate leaves the int64 range."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 (32-bit integer hash), the same as ``mix32`` in the kernels."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def keep_mask(seed: torch.Tensor, B: int, H: int, T: int, rate_u8: int) -> torch.Tensor:
    """(B, H, T, T) bool keep-mask of the kernels' dropout for this seed."""
    dev = seed.device
    s = seed.reshape(()).to(torch.int64)
    lo, hi = s & _MASK32, (s >> 32) & _MASK32
    bh = torch.arange(B, device=dev)[:, None] * H + torch.arange(H, device=dev)[None, :]
    stream = _mix32(_mix32(lo ^ _mix32(bh)) ^ hi)  # (B, H)
    t = torch.arange(T, device=dev)
    word = _mix32((t[:, None] << 16) | t[None, :])  # (T, T)
    bits = _mix32(stream[:, :, None, None] ^ word[None, None])
    return (bits >> 24) >= rate_u8


def fused_attention_plain(q, k, v, valid_mask, dropout_rate: float = 0.0,
                          seed: Optional[torch.Tensor] = None):
    """The dense math the kernels replace: ``dot_attention_weights`` with a
    ``padding_bias`` (-1e9, softmax in f32, or f64 for f64 inputs), the
    kernels' dropout mask on the probabilities, then P @ V.

    q/k/v: (B, T, H, D); valid_mask: (B, T) bool.  Returns (B, T, H, D)."""
    B, T, H, D = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D)
    bias = torch.where(valid_mask[:, None, None, :], 0.0, NEG).to(q.dtype)
    p = torch.softmax((scores + bias).to(torch.promote_types(q.dtype, torch.float32)), dim=-1)
    rate_u8 = threshold_u8(dropout_rate)
    if rate_u8 > 0:
        keep = keep_mask(_seed_tensor(seed, q.device), B, H, T, rate_u8)
        p = torch.where(keep, p * (1.0 / (1.0 - rate_u8 / 256.0)), 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), v)


def _seed_tensor(seed, device) -> torch.Tensor:
    if seed is None:
        raise ValueError("fused_attention: dropout needs a seed tensor")
    if not isinstance(seed, torch.Tensor) or seed.numel() != 1 or seed.dtype != torch.int64:
        raise ValueError("fused_attention: seed must be a one-element int64 tensor")
    if seed.device != device:
        raise ValueError(f"fused_attention: seed is on {seed.device}, the inputs on {device}")
    return seed


def _check(*tensors, what="q/k/v"):
    """Layout first, then the device, so that a layout the kernels refuse is
    reported wherever the tensors lie."""
    q = tensors[0]
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in tensors):
        raise ValueError(
            f"fused_attention: {what} must share one dtype of float32 or bfloat16, got "
            + ", ".join(str(t.dtype) for t in tensors)
        )
    if q.dim() != 4 or any(t.shape != q.shape for t in tensors):
        raise ValueError(
            f"fused_attention: {what} must be (B, T, H, D) of one shape, got "
            + ", ".join(str(tuple(t.shape)) for t in tensors)
        )
    B, T, H, D = q.shape
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"fused_attention: head dim {D} is outside 1 ... {MAX_HEAD_DIM}")
    if T >= MAX_T:
        raise ValueError(f"fused_attention: T={T} must be below {MAX_T}")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError(f"fused_attention: the head dim of {what} must have stride 1")
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"fused_attention: {what} and valid_mask must all be CUDA tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("fused_attention: tensors are on different devices")


def _check_mask(valid_mask, B, T, device):
    if valid_mask.shape != (B, T) or valid_mask.dtype != torch.bool:
        raise ValueError(
            f"fused_attention: valid_mask must be ({B}, {T}) bool, got "
            f"{tuple(valid_mask.shape)} {valid_mask.dtype}"
        )
    if valid_mask.device != device:
        raise ValueError("fused_attention: q, k, v and valid_mask must all be CUDA tensors")


def _raise_on(lib, rc, name):
    if rc != 0:
        msg = lib.s2t_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {rc})")


def _strides(*tensors):
    return [s for t in tensors for s in t.stride()[:3]]


def fused_attention_fwd(q, k, v, lengths, rate_u8: int = 0, seed=None, with_lse: bool = False
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Launch K1f on CUDA tensors.  q/k/v: (B, T, H, D), lengths: (B,) int32.
    Returns (out (B, T, H, D) contiguous, lse (B, H, T) f32, out32), lse and
    out32 None unless ``with_lse``: out32 is the output in f32 for the
    backward's Delta, for bf16 a second buffer the kernel writes before the
    bf16 rounding, for f32 ``out`` itself."""
    lib = _build.load_library("attention_fwd", _FWD_SIGNATURES)
    _check(q, k, v)
    B, T, H, D = q.shape
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = out32 = None
    if with_lse:
        lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
        out32 = out if q.dtype == torch.float32 else torch.empty_like(out, dtype=torch.float32)
    if out.numel() == 0:
        return out, lse, out32
    seed_ptr = _seed_tensor(seed, q.device).data_ptr() if rate_u8 > 0 else None
    keep_scale = 1.0 / (1.0 - rate_u8 / 256.0) if rate_u8 > 0 else 1.0
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.s2t_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            None if out32 is None or out32 is out else out32.data_ptr(),
            lengths.data_ptr(), seed_ptr,
            B, T, H, D, _DTYPE_CODES[q.dtype], rate_u8,
            *_strides(q, k, v, out), 1.0 / math.sqrt(D), keep_scale, stream,
        )
    _raise_on(lib, rc, "attention_fwd")
    fused_attention.launches += 1
    return out, lse, out32


def fused_attention_bwd(q, k, v, out32, do, lse, lengths, rate_u8: int = 0, seed=None):
    """Launch K1b on CUDA tensors: (dq, dk, dv), each (B, T, H, D) contiguous
    in q.dtype.  ``out32`` and ``lse`` are the forward's f32 output and
    (B, H, T) f32 log-sum-exp (``fused_attention_fwd(..., with_lse=True)``)."""
    lib = _build.load_library("attention_bwd", _BWD_SIGNATURES)
    _check(q, k, v, do, what="q/k/v/dout")
    B, T, H, D = q.shape
    if out32.dtype != torch.float32 or out32.shape != q.shape or out32.stride(-1) != 1:
        raise ValueError(f"fused_attention_bwd: out32 must be the forward's float32 output "
                         f"{tuple(q.shape)} with a unit head-dim stride, got "
                         f"{tuple(out32.shape)} {out32.dtype} {out32.stride()}")
    if lse.shape != (B, H, T) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"fused_attention_bwd: lse must be contiguous ({B}, {H}, {T}) float32")
    if any(t.device != q.device for t in (out32, lse)):
        raise ValueError(f"fused_attention_bwd: out32 on {out32.device} and lse on {lse.device} "
                         f"must lie on the inputs' device {q.device}")
    dq, dk, dv = (torch.empty((B, T, H, D), dtype=q.dtype, device=q.device) for _ in range(3))
    if dq.numel() == 0:
        return dq, dk, dv
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    seed_ptr = _seed_tensor(seed, q.device).data_ptr() if rate_u8 > 0 else None
    keep_scale = 1.0 / (1.0 - rate_u8 / 256.0) if rate_u8 > 0 else 1.0
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.s2t_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out32.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            lengths.data_ptr(), seed_ptr, B, T, H, D, _DTYPE_CODES[q.dtype], rate_u8,
            *_strides(q, k, v, out32, do, dq, dk, dv), 1.0 / math.sqrt(D), keep_scale, stream,
        )
    _raise_on(lib, rc, "attention_bwd")
    fused_attention_bwd.launches += 1
    return dq, dk, dv


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, lengths, rate_u8, seed):
        grad = any(ctx.needs_input_grad[:3])
        out, lse, out32 = fused_attention_fwd(q, k, v, lengths, rate_u8, seed, with_lse=grad)
        if grad:
            ctx.save_for_backward(q, k, v, out32, lse, lengths, seed)
            ctx.rate_u8 = rate_u8
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out32, lse, lengths, seed = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        dq, dk, dv = fused_attention_bwd(q, k, v, out32, do, lse, lengths, ctx.rate_u8, seed)
        return dq, dk, dv, None, None, None


def fused_attention(q, k, v, valid_mask, dropout_rate: float = 0.0,
                    seed: Optional[torch.Tensor] = None):
    """softmax(QK^T/sqrt(D) + padding_bias) @ V with attention dropout.

    q/k/v: (B, T, H, D) float32 or bfloat16, 1 <= D <= 128, T < 65536, any
    strides with a unit head-dim stride; valid_mask: (B, T) bool, a contiguous
    True prefix per row;
    ``seed``: (1,) int64 tensor on the inputs' device, needed when
    ``dropout_rate`` > 0.  Returns a contiguous (B, T, H, D) tensor in
    q.dtype, differentiable in q, k and v.  A CPU tensor runs
    ``fused_attention_plain``; a CUDA tensor launches the kernels or raises."""
    if q.device.type == "cpu":
        return fused_attention_plain(q, k, v, valid_mask, dropout_rate, seed)
    rate_u8 = threshold_u8(dropout_rate)
    _check_mask(valid_mask, q.shape[0], q.shape[1], q.device)
    # the forward launcher checks q/k/v and the seed
    return _FusedAttention.apply(q, k, v, mask_to_lengths(valid_mask), rate_u8,
                                 seed if rate_u8 > 0 else None)


# kernel launches since the last reset; chip_smoke.py reads them to show the
# serving and training paths went through the kernels
fused_attention.launches = 0
fused_attention_bwd.launches = 0

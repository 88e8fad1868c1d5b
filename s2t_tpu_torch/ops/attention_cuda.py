"""Fused encoder self-attention: a hand-written CUDA kernel and its plain version.

Counterpart of ``s2t_tpu/ops/attention_pallas.py`` (forward, dropout 0):
``softmax(Q K^T / sqrt(D) + padding_bias) V`` for non-causal self-attention
with a pure padding mask, never materialising the (B, H, T, T) probabilities.
The kernel source is ``s2t_tpu_torch/csrc/attention_fwd.cu`` (design and
bound in its header note).

``fused_attention`` runs the kernel for a CUDA tensor and the plain version
``fused_attention_plain`` for a CPU tensor; there is no other fallback.
"""

from __future__ import annotations

import ctypes
import math

import torch

from s2t_tpu_torch.ops import _build
from s2t_tpu_torch.utils.masking import mask_to_lengths

NEG = -1e9
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "s2t_attention_fwd": (
        ctypes.c_int,
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I] + [_L] * 12 + [ctypes.c_float, _P],
    ),
    "s2t_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def fused_attention_plain(q, k, v, valid_mask):
    """The dense math the kernel replaces: ``dot_attention_weights`` with a
    ``padding_bias`` (-1e9, softmax in f32) followed by P @ V.

    q/k/v: (B, T, H, D); valid_mask: (B, T) bool.  Returns (B, T, H, D)."""
    D = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D)
    bias = torch.where(valid_mask[:, None, None, :], 0.0, NEG).to(q.dtype)
    w = torch.softmax((scores + bias).float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def _check(q, k, v, valid_mask):
    if not (q.is_cuda and k.is_cuda and v.is_cuda and valid_mask.is_cuda):
        raise ValueError("fused_attention: q, k, v and valid_mask must all be CUDA tensors")
    if len({t.device for t in (q, k, v, valid_mask)}) != 1:
        raise ValueError("fused_attention: tensors are on different devices")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"fused_attention: q/k/v must share one dtype of float32 or bfloat16, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"fused_attention: q/k/v must be (B, T, H, D) of one shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, T, H, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"fused_attention: head dim {D} not in {HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("fused_attention: the head dim of q/k/v must have stride 1")
    if valid_mask.shape != (B, T) or valid_mask.dtype != torch.bool:
        raise ValueError(
            f"fused_attention: valid_mask must be ({B}, {T}) bool, got "
            f"{tuple(valid_mask.shape)} {valid_mask.dtype}"
        )


def fused_attention(q, k, v, valid_mask):
    """softmax(QK^T/sqrt(D) + padding_bias) @ V.

    q/k/v: (B, T, H, D) float32 or bfloat16, any strides with a unit head-dim
    stride; valid_mask: (B, T) bool, a contiguous True prefix per row.
    Returns a contiguous (B, T, H, D) tensor in q.dtype.  A CPU tensor runs
    ``fused_attention_plain``; a CUDA tensor launches the kernel or raises."""
    if q.device.type == "cpu":
        return fused_attention_plain(q, k, v, valid_mask)
    lib = _build.load_library("attention_fwd", _SIGNATURES)
    _check(q, k, v, valid_mask)
    B, T, H, D = q.shape
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lengths = mask_to_lengths(valid_mask)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.s2t_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lengths.data_ptr(),
            B, T, H, D, _DTYPE_CODES[q.dtype],
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            1.0 / math.sqrt(D), stream,
        )
    if rc != 0:
        msg = lib.s2t_cuda_error_string(rc).decode()
        raise RuntimeError(f"attention_fwd launch failed: {msg} (cudaError {rc})")
    fused_attention.launches += 1
    return out


# kernel launches since the last reset; chip_smoke.py reads it to show the
# serving path went through the kernel
fused_attention.launches = 0

"""Kaldi log-mel filterbank: the hand-written CUDA kernel K5 and its plain version.

Counterpart of ``s2t_tpu/ops/fbank_pallas.py`` (``fbank_pallas`` ->
``_fbank_kernel``): (B, N) float32 int16-scale zero-padded waveforms and (B,)
valid sample counts -> (B, T, num_mel_bins) float32 log-mel features over
every frame of the padded rows, T = 1 + (N - 400) // 160 (0 if N < 400), and
(B,) int32 frame lengths ``where(len >= 400, 1 + (len - 400) // 160, 0)``.
Frames past a row's length are computed from the zero padding, as
``fbank_jax`` and ``fbank_pallas`` compute them.  Kernel source:
``s2t_tpu_torch/csrc/fbank.cu`` (design and bound in its header note).

``fbank`` runs ``fbank_plain`` (``fbank_torch`` of ``data/audio/fbank.py``
at 16 kHz, 25 ms / 10 ms frames) for a CPU tensor and launches K5 for a CUDA
tensor, or raises.  K5 takes each frame's 512-point real DFT as a float64
FFT (a packed 256-point complex transform, 16 x 16 four-step, then the split
into the real spectrum).  The kernel takes the 16 kHz, 400 / 160 / 512
geometry only, up to 65535 rows, and any mel bin count whose weighted FFT
bins fit the 256 power entries it keeps a frame (every count does for the
Kaldi banks from 20 Hz).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from s2t_tpu_torch.data.audio.fbank import fbank_torch, kaldi_mel_banks, povey_window
from s2t_tpu_torch.ops import _build

WS, SH, NFFT = 400, 160, 512
MAX_BINS = 256  # power entries the kernel keeps a frame

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # wave, window, twiddles, mel_w, mel_lo, mel_hi, out, B, N, T, n_mels, k0, nk, stream
    "s2t_fbank": (_I, [_P] * 7 + [_I] * 6 + [_P]),
    "s2t_cuda_error_string": (ctypes.c_char_p, [_I]),
}


# the plain version of K5: the same contract in torch ops
fbank_plain = fbank_torch


def mel_bin_ranges(num_mel_bins: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(mel (257, n) f32, lo (n,) int32, hi (n,) int32): filter m weighs FFT
    bins [lo[m], hi[m]) only (lo == hi for a filter that covers no bin)."""
    mel = kaldi_mel_banks(num_mel_bins, NFFT, 16000.0)
    lo = np.zeros(num_mel_bins, np.int32)
    hi = np.zeros(num_mel_bins, np.int32)
    for m in range(num_mel_bins):
        nz = np.flatnonzero(mel[:, m])
        if nz.size:
            lo[m], hi[m] = nz[0], nz[-1] + 1
    return mel, lo, hi


def fft_twiddles() -> np.ndarray:
    """(513, 2) float64 (cos, sin) pairs the kernel reads: 2 pi k / 512 for
    k = 0..256 (the split into the real spectrum), then 2 pi n1 k2 / 256 at
    row 257 + 16 k2 + n1 (the 16 x 16 four-step's twiddles, in the order the
    threads n1 of a frame read them)."""
    k = np.arange(NFFT // 2 + 1)
    k2, n1 = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    angle = np.concatenate([np.pi * k / 256, np.pi * (n1 * k2).ravel() / 128])
    return np.stack([np.cos(angle), np.sin(angle)], axis=1)


def mel_weights(mel: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """(W, n) float32, W = max(hi - lo): row j holds the weight filter m gives
    FFT bin lo[m] + j (0 past hi[m]), so the kernel's thread m reads its
    filter's nonzero weights alone and a warp's reads are contiguous."""
    width = hi - lo
    out = np.zeros((max(int(width.max()), 1), mel.shape[1]), np.float32)
    for m in range(mel.shape[1]):
        out[: width[m], m] = mel[lo[m]:hi[m], m]
    return out


@lru_cache(maxsize=8)
def _constants(num_mel_bins: int, device: str):
    """Window (float64 of the float32 povey window), twiddles, compact mel
    weights and filter ranges on the device, with the bin range [k0, k0 + nk)
    the kernel computes."""
    mel, lo, hi = mel_bin_ranges(num_mel_bins)
    used = hi > lo
    k0 = int(lo[used].min()) if used.any() else 1
    nk = int(hi[used].max()) - k0 if used.any() else 1
    lo = np.where(used, lo, k0).astype(np.int32)
    hi = np.where(used, hi, k0).astype(np.int32)
    if nk > MAX_BINS:
        raise ValueError(f"fbank: num_mel_bins={num_mel_bins} weighs {nk} FFT bins; the kernel "
                         f"covers at most {MAX_BINS}")
    window = povey_window(WS).astype(np.float64)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (window, fft_twiddles(), mel_weights(mel, lo, hi), lo, hi)) + (k0, nk)


def _check(waveforms, lengths, num_mel_bins):
    if num_mel_bins < 1:
        raise ValueError(f"fbank: num_mel_bins={num_mel_bins} must be at least 1")
    if not (waveforms.is_cuda and lengths.is_cuda):
        raise ValueError("fbank: waveforms and lengths must be CUDA tensors")
    if waveforms.dtype != torch.float32 or waveforms.dim() != 2:
        raise ValueError(f"fbank: waveforms must be (B, N) float32, got "
                         f"{tuple(waveforms.shape)} {waveforms.dtype}")
    if lengths.shape != (waveforms.shape[0],):
        raise ValueError(f"fbank: lengths {tuple(lengths.shape)} do not fit waveforms "
                         f"{tuple(waveforms.shape)}")
    if waveforms.shape[0] > 65535:
        raise ValueError(f"fbank: {waveforms.shape[0]} rows; the kernel takes at most 65535")


def fbank(waveforms: torch.Tensor, lengths: torch.Tensor,
          num_mel_bins: int = 80) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5.  Same contract as ``fbank_plain``."""
    if waveforms.device.type == "cpu":
        return fbank_plain(waveforms, lengths, num_mel_bins=num_mel_bins)
    lib = _build.load_library("fbank", _SIGNATURES)
    _check(waveforms, lengths, num_mel_bins)
    B, N = waveforms.shape
    T = 1 + (N - WS) // SH if N >= WS else 0
    frame_lengths = torch.where(lengths >= WS, 1 + (lengths - WS) // SH, 0).to(torch.int32)
    out = torch.empty((B, T, num_mel_bins), dtype=torch.float32, device=waveforms.device)
    if B == 0 or T == 0:
        return out, frame_lengths
    wave = waveforms.contiguous()
    window, twiddles, mel_w, lo, hi, k0, nk = _constants(num_mel_bins, str(waveforms.device))
    with torch.cuda.device(waveforms.device):
        rc = lib.s2t_fbank(wave.data_ptr(), window.data_ptr(), twiddles.data_ptr(),
                           mel_w.data_ptr(), lo.data_ptr(), hi.data_ptr(), out.data_ptr(), B, N,
                           T, num_mel_bins, k0, nk,
                           torch.cuda.current_stream(waveforms.device).cuda_stream)
    if rc != 0:
        msg = lib.s2t_cuda_error_string(rc).decode()
        raise RuntimeError(f"s2t_fbank launch failed: {msg} (cudaError {rc})")
    fbank.launches += 1
    return out, frame_lengths


# kernel launches since the last reset; chip_smoke.py reads it to show the
# raw-audio training path went through the kernel
fbank.launches = 0

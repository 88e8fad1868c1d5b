"""Kaldi-compatible 80-dim log-mel filterbank features.

The port's own copy of s2t_tpu/data/audio/fbank.py
(``torchaudio.compliance.kaldi.fbank`` default semantics: dither 0, 25 ms /
10 ms frames, povey window, preemphasis 0.97, DC removal, power spectrum,
Kaldi mel banks with low_freq 20 Hz, snip_edges).  Input is int16-scale.

* ``fbank_numpy``: one waveform on the host (float64 inside), what the
  serving entry computes before the model;
* ``fbank_torch``: a padded (B, N) batch in torch ops (frames and DFT in
  float64, power, mel product and log in float32), the counterpart of
  ``fbank_jax`` (:142-184); the kernel K5 (``ops/fbank_cuda.py``) computes
  the same function on the card;
* ``speed_perturb_numpy``: sox-style speed perturbation (:187-203).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

MILLISECONDS_TO_SECONDS = 0.001
EPSILON = 1.1920928955078125e-07  # torch.finfo(torch.float32).eps


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


@lru_cache(maxsize=8)
def kaldi_mel_banks(num_bins: int, padded_window_size: int, sample_freq: float,
                    low_freq: float = 20.0, high_freq: float = 0.0) -> np.ndarray:
    """Kaldi triangular mel filterbank, shape (num_fft_bins+1, num_bins), so
    the feature step is ``power @ banks`` (the nyquist row is zero)."""
    num_fft_bins = padded_window_size // 2
    nyquist = 0.5 * sample_freq
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq
    fft_bin_width = sample_freq / padded_window_size
    mel_low = mel_scale(low_freq)
    mel_high = mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    bin_idx = np.arange(num_bins, dtype=np.float64)[:, None]
    left_mel = mel_low + bin_idx * mel_delta
    center_mel = mel_low + (bin_idx + 1.0) * mel_delta
    right_mel = mel_low + (bin_idx + 2.0) * mel_delta

    mel = mel_scale(fft_bin_width * np.arange(num_fft_bins, dtype=np.float64))[None, :]
    up_slope = (mel - left_mel) / (center_mel - left_mel)
    down_slope = (right_mel - mel) / (right_mel - center_mel)
    banks = np.maximum(0.0, np.minimum(up_slope, down_slope))
    banks = np.concatenate([banks, np.zeros((num_bins, 1))], axis=1)
    return banks.T.astype(np.float32)


@lru_cache(maxsize=8)
def povey_window(window_size: int) -> np.ndarray:
    """Kaldi 'povey' window: hann(periodic=False) ** 0.85."""
    n = np.arange(window_size, dtype=np.float64)
    hann = 0.5 - 0.5 * np.cos(2.0 * math.pi * n / (window_size - 1))
    return (hann ** 0.85).astype(np.float32)


def num_frames(n_samples: int, sample_rate: int = 16000,
               frame_length_ms: float = 25.0, frame_shift_ms: float = 10.0) -> int:
    ws = int(sample_rate * frame_length_ms * MILLISECONDS_TO_SECONDS)
    sh = int(sample_rate * frame_shift_ms * MILLISECONDS_TO_SECONDS)
    if n_samples < ws:
        return 0
    return 1 + (n_samples - ws) // sh


def fbank_numpy(
    waveform: np.ndarray,
    sample_rate: int = 16000,
    num_mel_bins: int = 80,
    frame_length_ms: float = 25.0,
    frame_shift_ms: float = 10.0,
    preemphasis: float = 0.97,
    remove_dc_offset: bool = True,
    low_freq: float = 20.0,
    high_freq: float = 0.0,
) -> np.ndarray:
    """(N,) int16-scale waveform -> (T, num_mel_bins) float32 log-mel features."""
    waveform = np.asarray(waveform, dtype=np.float32)
    ws = int(sample_rate * frame_length_ms * MILLISECONDS_TO_SECONDS)
    sh = int(sample_rate * frame_shift_ms * MILLISECONDS_TO_SECONDS)
    T = num_frames(len(waveform), sample_rate, frame_length_ms, frame_shift_ms)
    if T == 0:
        return np.zeros((0, num_mel_bins), dtype=np.float32)
    idx = np.arange(T)[:, None] * sh + np.arange(ws)[None, :]
    frames = waveform[idx].astype(np.float64)
    if remove_dc_offset:
        frames = frames - frames.mean(axis=1, keepdims=True)
    if preemphasis != 0.0:
        prev = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
        frames = frames - preemphasis * prev
    frames = frames * povey_window(ws).astype(np.float64)
    padded = _next_pow2(ws)
    spec = np.fft.rfft(frames, n=padded, axis=1)
    power = (spec.real ** 2 + spec.imag ** 2).astype(np.float32)
    banks = kaldi_mel_banks(num_mel_bins, padded, float(sample_rate), low_freq, high_freq)
    mel = power @ banks
    return np.log(np.maximum(mel, EPSILON)).astype(np.float32)


def fbank_torch(
    waveforms: torch.Tensor,
    lengths: torch.Tensor,
    sample_rate: int = 16000,
    num_mel_bins: int = 80,
    frame_length_ms: float = 25.0,
    frame_shift_ms: float = 10.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched fbank in torch ops (``fbank_jax``): (B, N) float32 int16-scale
    zero-padded waveforms and (B,) valid sample counts -> (B, T, num_mel_bins)
    float32 features over every frame of the padded rows, T = num_frames(N),
    and (B,) int32 frame lengths.

    Like ``fbank_numpy``, the framing, DC removal, preemphasis, window and
    DFT run in float64 and the power is rounded to float32 once, before the
    float32 mel product.  In float32 the preemphasis of a loud low-frequency
    frame cancels to a few digits, and cuFFT's float32 transform then misses
    ``fbank_numpy`` by 2.5x the parity tolerance (atol 5e-4 + rtol 1e-4) on
    the quiet mel bins of the fixture wavs."""
    B, N = waveforms.shape
    ws = int(sample_rate * frame_length_ms * MILLISECONDS_TO_SECONDS)
    sh = int(sample_rate * frame_shift_ms * MILLISECONDS_TO_SECONDS)
    T = num_frames(N, sample_rate, frame_length_ms, frame_shift_ms)
    dev = waveforms.device
    frame_lengths = torch.where(lengths >= ws, 1 + (lengths - ws) // sh, 0).to(torch.int32)
    if T == 0:
        return waveforms.new_zeros((B, 0, num_mel_bins), dtype=torch.float32), frame_lengths
    idx = (torch.arange(T, device=dev)[:, None] * sh + torch.arange(ws, device=dev)[None, :])
    frames = waveforms.to(torch.float64)[:, idx]  # (B, T, ws)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = frames - 0.97 * prev
    frames = frames * torch.from_numpy(povey_window(ws)).to(dev, torch.float64)
    padded = _next_pow2(ws)
    spec = torch.fft.rfft(frames, n=padded, dim=-1)
    power = (spec.real ** 2 + spec.imag ** 2).float()
    banks = torch.from_numpy(kaldi_mel_banks(num_mel_bins, padded, float(sample_rate))).to(dev)
    mel = power @ banks
    return torch.log(torch.clamp(mel, min=EPSILON)), frame_lengths


def speed_perturb_numpy(waveform: np.ndarray, speed: float) -> np.ndarray:
    """sox-style speed perturbation by polyphase resampling (host side): speed
    S plays S times faster, i.e. the waveform is resampled by a factor 1/S."""
    if speed == 1.0:
        return waveform
    from fractions import Fraction

    from scipy.signal import resample_poly

    frac = Fraction(1.0 / speed).limit_denominator(100)
    return resample_poly(waveform.astype(np.float32), frac.numerator, frac.denominator).astype(
        np.float32
    )

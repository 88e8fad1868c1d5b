"""Kaldi-compatible 80-dim log-mel filterbank features on the host (numpy).

The port's own copy of the host path of s2t_tpu/data/audio/fbank.py:31-134
(``torchaudio.compliance.kaldi.fbank`` default semantics: dither 0, 25 ms /
10 ms frames, povey window, preemphasis 0.97, DC removal, power spectrum,
Kaldi mel banks with low_freq 20 Hz, snip_edges), which is what the serving
entry computes before the model.  Input is int16-scale.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

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

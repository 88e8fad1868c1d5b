"""Host-side audio loading (counterpart of ``load_waveform`` and ``load_features``
in s2t_tpu/data/dataset.py:80-99, for plain file paths)."""

from __future__ import annotations

import wave

import numpy as np


def load_features(path: str) -> np.ndarray:
    """A (T, C) feature matrix saved with ``np.save``."""
    return np.load(path, allow_pickle=False)


def load_waveform(path: str) -> np.ndarray:
    """16-bit PCM WAV as float32 in int16 scale; multi-channel audio is
    averaged to mono."""
    with wave.open(path) as w:
        raw = w.readframes(w.getnframes())
        arr = np.frombuffer(raw, dtype=np.int16).astype(np.float32)
        if w.getnchannels() > 1:
            arr = arr.reshape(-1, w.getnchannels()).mean(axis=1)
    return arr

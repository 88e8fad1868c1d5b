"""Raw-waveform dataset for wav2vec-style pretraining (counterpart of
s2t_tpu/data/raw_audio_dataset.py).

A manifest whose first line is the audio root and whose other lines are
"relpath<TAB>n_samples"; ``.npy`` waveforms or 16/32-bit PCM ``.wav``.  An
utterance longer than ``max_sample_size`` is cropped at a start fixed by its
index ((index * 7919) mod (len - max + 1), as in JAX); ``normalize`` scales it
to zero mean and unit variance.  Batches pad to the task's bucket lattice with
the lengths carried; ``frame_cap`` tells the batch iterator that ``n_frames``
counts samples.
"""

from __future__ import annotations

import wave
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from s2t_tpu_torch.data.batching import bucketize


def read_waveform(path: str) -> np.ndarray:
    """Mono float32 waveform from .npy (int16 scaled by 1/32768) or PCM .wav."""
    if path.endswith(".npy"):
        wav = np.load(path)
        if wav.dtype == np.int16:
            wav = wav.astype(np.float32) / 32768.0
        return np.asarray(wav, np.float32).reshape(-1)
    if path.endswith(".wav"):
        with wave.open(path, "rb") as f:
            width = f.getsampwidth()
            raw = f.readframes(f.getnframes())
        if width == 2:
            return np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
        if width == 4:
            return np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
        raise ValueError(f"unsupported sample width {width} in {path}")
    raise ValueError(f"unsupported audio format: {path}")


class RawAudioDataset:
    """Manifest TSV -> raw waveforms (fairseq's FileAudioDataset)."""

    def __init__(self, manifest: str | Path, max_sample_size: Optional[int] = None,
                 min_sample_size: int = 0, normalize: bool = False):
        lines = Path(manifest).read_text().strip().split("\n")
        self.root = lines[0].strip()
        self.paths: List[str] = []
        sizes: List[int] = []
        for ln in lines[1:]:
            p, n = ln.split("\t")
            if int(n) < min_sample_size:
                continue
            self.paths.append(p)
            sizes.append(int(n))
        self.sizes = np.asarray(sizes, np.int64)
        self.max_sample_size = max_sample_size
        self.frame_cap = int(max_sample_size) if max_sample_size else int(
            self.sizes.max() if len(self.sizes) else 1)
        self.normalize = normalize

    @property
    def n_frames(self) -> np.ndarray:
        if self.max_sample_size:
            return np.minimum(self.sizes, self.max_sample_size)
        return self.sizes

    def __len__(self):
        return len(self.paths)

    def ordered_indices(self, shuffle: bool = True, seed: int = 1, epoch: int = 1) -> np.ndarray:
        order = (np.random.default_rng(seed + epoch).permutation(len(self)) if shuffle
                 else np.arange(len(self)))
        return order[np.argsort(self.n_frames[order], kind="stable")]

    def __getitem__(self, index: int) -> Dict[str, Any]:
        wav = read_waveform(str(Path(self.root) / self.paths[index]))
        if self.max_sample_size and len(wav) > self.max_sample_size:
            start = (index * 7919) % (len(wav) - self.max_sample_size + 1)
            wav = wav[start:start + self.max_sample_size]
        if self.normalize:
            wav = (wav - wav.mean()) / np.sqrt(wav.var() + 1e-5)
        return {"id": index, "source": wav.astype(np.float32)}

    def collater(self, samples: List[Dict[str, Any]], frame_buckets: Optional[np.ndarray] = None,
                 token_buckets: Optional[np.ndarray] = None, batch_multiple: int = 1
                 ) -> Dict[str, Any]:
        B = len(samples)
        pad_b = (-B) % batch_multiple
        lengths = np.asarray([len(s["source"]) for s in samples], np.int32)
        T = int(lengths.max())
        if frame_buckets is not None:
            T = int(bucketize(np.asarray([T]), frame_buckets)[0])
        src = np.zeros((B + pad_b, T), np.float32)
        for i, s in enumerate(samples):
            n = min(int(lengths[i]), T)
            src[i, :n] = s["source"][:n]
        lengths = np.concatenate([np.minimum(lengths, T), np.zeros(pad_b, np.int32)])
        return {"ids": np.asarray([s["id"] for s in samples] + [-1] * pad_b),
                "nsentences": B, "source": src, "lengths": lengths,
                "ntokens": float(lengths.sum())}

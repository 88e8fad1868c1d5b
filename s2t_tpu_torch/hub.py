"""Serving entry: requests in, top-beam token ids out
(counterpart of ``GeneratorHub._speech_batch`` + ``generate`` in s2t_tpu/hub.py:30-82).

Usage:
    from s2t_tpu_torch.hub import GeneratorHub
    from s2t_tpu_torch.models.s2t_transformer import s2t_transformer_s
    hub = GeneratorHub.build(s2t_transformer_s(vocab_size=10000), beam_size=5)
    hub.generate(["utt0.wav", "utt1.wav"])   # -> [np.ndarray of token ids, ...]

A request is a wav path (features are computed on the host with
``fbank_numpy``), a ``.npy`` feature path, a 1-D waveform array or a 2-D
(T, C) feature array.  No task, dictionary or checkpoint yet: the weights come
from a seed, or from a JAX parameter tree through ``interop.from_flax``.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np

from s2t_tpu_torch.data.audio.fbank import fbank_numpy
from s2t_tpu_torch.data.dataset import load_features, load_waveform
from s2t_tpu_torch.inference.generator import SequenceGenerator
from s2t_tpu_torch.models.s2t_transformer import S2TTransformerConfig, S2TTransformerModel

Request = Union[str, np.ndarray]


def request_features(request: Request) -> np.ndarray:
    if isinstance(request, np.ndarray):
        return fbank_numpy(request) if request.ndim == 1 else request.astype(np.float32)
    if request.endswith(".npy"):
        return load_features(request)
    return fbank_numpy(load_waveform(request))


class GeneratorHub:
    def __init__(self, model: S2TTransformerModel, generator: SequenceGenerator):
        self.model = model
        self.generator = generator

    @classmethod
    def build(cls, cfg: S2TTransformerConfig, device="cuda", seed: int = 0,
              **generation) -> "GeneratorHub":
        model = S2TTransformerModel(cfg, device=device, seed=seed)
        return cls(model, SequenceGenerator(model, **generation))

    def _speech_batch(self, requests: Sequence[Request]):
        feats = [request_features(r) for r in requests]
        T = max(f.shape[0] for f in feats)
        arr = np.zeros((len(feats), T, feats[0].shape[1]), np.float32)
        lens = np.zeros((len(feats),), np.int32)
        for i, f in enumerate(feats):
            arr[i, : f.shape[0]] = f
            lens[i] = f.shape[0]
        return {"features": arr, "feat_lengths": lens}

    def generate(self, requests: Sequence[Request]) -> List[np.ndarray]:
        """Top-beam token ids of each request, up to (not including) EOS."""
        tokens, _, _ = self.generator.generate(self._speech_batch(requests))
        top = tokens[:, 0].cpu().numpy()
        eos = self.generator.eos_id
        out = []
        for row in top:
            stop = np.flatnonzero(row == eos)
            out.append(row[: stop[0] if stop.size else len(row)])
        return out

"""Serving entry (counterpart of s2t_tpu/hub.py).

Usage:
    from s2t_tpu_torch.hub import from_pretrained
    m = from_pretrained("ckpt/checkpoint_best.pt", data_dir="data/mustc",
                        config={"arch": "s2t_ctc", "model": {...}})
    m.transcribe("audio.wav")                  # -> detokenised text
    m.generate(["utt0.wav", "utt1.npy"])       # -> [text, ...]
    m.translate("ein satz .")                  # a translation task: raw text

``from_pretrained`` loads one of the port's checkpoints (``utils/checkpoint.py``)
and builds the task, its model (on the card unless ``device="cpu"``) and its
generator; ``generate``, ``translate`` and ``transcribe`` return strings.
``GeneratorHub.build`` serves an ``s2t_transformer``, ``pdss2t_transformer``
or ``s2t_sate`` config from seeded weights with no task and returns token ids.

A request is a wav path (features are computed on the host with
``fbank_numpy``), a ``.npy`` feature path, a 1-D waveform array or a 2-D
(T, C) feature array; under a ``use_audio_input`` data config a wav path or
a 1-D array is served as its waveform, with no fbank (a wav2vec 2.0 front
end).  Under a translation task a request is a line of raw text
(``_text_batch``), answered with the detokenised top hypothesis.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence, Union

import numpy as np

from s2t_tpu_torch.data.audio.fbank import fbank_numpy
from s2t_tpu_torch.data.dataset import load_features, load_waveform
from s2t_tpu_torch.inference.generator import SequenceGenerator
from s2t_tpu_torch.models.pds import PDSConfig, PDSS2TTransformerModel
from s2t_tpu_torch.models.s2t_transformer import S2TTransformerConfig, S2TTransformerModel
from s2t_tpu_torch.models.sate import S2TSATEModel, SATEConfig

Request = Union[str, np.ndarray]


def request_features(request: Request) -> np.ndarray:
    if isinstance(request, np.ndarray):
        return fbank_numpy(request) if request.ndim == 1 else request.astype(np.float32)
    if request.endswith(".npy"):
        return load_features(request)
    return fbank_numpy(load_waveform(request))


class GeneratorHub:
    def __init__(self, model, generator, task=None):
        self.model = model
        self.generator = generator
        self.task = task

    @classmethod
    def build(cls, cfg: Union[S2TTransformerConfig, PDSConfig, SATEConfig], device="cuda",
              seed: int = 0, **generation) -> "GeneratorHub":
        model_cls = (PDSS2TTransformerModel if isinstance(cfg, PDSConfig)
                     else S2TSATEModel if isinstance(cfg, SATEConfig) else S2TTransformerModel)
        model = model_cls(cfg, device=device, seed=seed)
        return cls(model, SequenceGenerator(model, **generation))

    def _speech_batch(self, requests: Sequence[Request]):
        """(B, T, C) features, or with a ``use_audio_input`` task the (B, N)
        waveforms, which the generator hands to ``encode`` as they are
        (s2t_tpu/hub.py:31-51)."""
        if getattr(getattr(self.task, "data_cfg", None), "use_audio_input", False):
            feats = [np.asarray(r, np.float32) if isinstance(r, np.ndarray)
                     else load_waveform(r) for r in requests]
        else:
            feats = [request_features(r) for r in requests]
        T = max(f.shape[0] for f in feats)
        arr = np.zeros((len(feats), T, *feats[0].shape[1:]), np.float32)
        lens = np.zeros((len(feats),), np.int32)
        for i, f in enumerate(feats):
            arr[i, : f.shape[0]] = f
            lens[i] = f.shape[0]
        return {"features": arr, "feat_lengths": lens}

    def _text_batch(self, lines: List[str]):
        """Source tokens (B, S) of raw text requests, tokenised and EOS-terminated as
        the task's dataset does (s2t_tpu/hub.py:55-71)."""
        src_dict = getattr(self.task, "src_dict", self.task.tgt_dict)
        bpe = getattr(self.task, "src_bpe", None) or getattr(self.task, "bpe", None)
        enc = [src_dict.encode_line(bpe.encode_line(line) if bpe is not None else line,
                                    append_eos=True) for line in lines]
        arr = np.full((len(enc), max(len(e) for e in enc)), src_dict.pad(), np.int32)
        lens = np.zeros((len(enc),), np.int32)
        for i, e in enumerate(enc):
            arr[i, :len(e)] = e
            lens[i] = len(e)
        return {"src_tokens": arr, "src_lengths": lens}

    def generate(self, requests: Sequence[Request]) -> List:
        """With a task, the detokenised top hypothesis of each request; without
        one, its token ids up to (not including) EOS."""
        from s2t_tpu_torch.tasks.speech_to_text import SpeechToTextTask

        if self.task is not None and not isinstance(self.task, SpeechToTextTask):
            batch = self._text_batch(list(requests))
        else:
            batch = self._speech_batch(requests)
        tokens, _, _ = self.generator.generate(batch)
        top = tokens[:, 0].cpu().numpy()
        if self.task is not None:
            return [self.task.decode_tokens(row) for row in top]
        eos = self.generator.eos_id
        out = []
        for row in top:
            stop = np.flatnonzero(row == eos)
            out.append(row[: stop[0] if stop.size else len(row)])
        return out

    def translate(self, request: Request):
        return self.generate([request])[0]

    transcribe = translate


def from_pretrained(checkpoint: Union[str, Path], data_dir: Optional[str] = None,
                    config: Optional[dict] = None, device="cuda", task=None,
                    **overrides) -> GeneratorHub:
    """Load a checkpoint of the port and build the task, model and generator
    (s2t_tpu/hub.py:90-116).  ``config``: the TrainConfig as a dict (arch,
    model section, generation, ...); a ``model`` section in the checkpoint's
    metadata is used when ``config`` has none; ``overrides`` set
    ``generation`` fields; ``task``: a prebuilt task (a data config made in
    Python), as ``cli.train.main`` takes one; default ``setup_task``."""
    from s2t_tpu_torch.config import TrainConfig, from_dict
    from s2t_tpu_torch.tasks import setup_task
    from s2t_tpu_torch.utils.checkpoint import load_checkpoint

    tree, meta = load_checkpoint(checkpoint)
    d = dict(config or {})
    if "model" in meta and "model" not in d:
        d["model"] = meta["model"]
    cfg = from_dict(TrainConfig, d)
    if data_dir:
        cfg.dataset.data = str(data_dir)
    for k, v in overrides.items():
        setattr(cfg.generation, k, v)
    task = task or setup_task(cfg)
    model = task.build_model(device=device)
    model.load_state_dict(tree["params"] if "params" in tree else tree, strict=True)
    return GeneratorHub(model, task.build_generator(model), task)

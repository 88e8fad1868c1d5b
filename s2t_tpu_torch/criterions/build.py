"""Criterion by registry name (counterpart of s2t_tpu/criterions/build.py).

The names of the ported criteria map to their classes; any other name raises.
``cfg_dict`` fills the criterion's Config, nested dataclasses from nested
dicts (``{"ctc": {"ctc_weight": 0.3}}``), a YAML list into a tuple field as a
tuple and an int into a float field as a float, as the JAX builder coerces
them; an unknown key raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from s2t_tpu_torch.criterions.adaptive_loss import AdaptiveLoss
from s2t_tpu_torch.criterions.composite import CompositeLoss, ModelCriterion
from s2t_tpu_torch.criterions.ctc import (
    CTCCriterion, JoinSpeechAndTextLoss, LabelSmoothedCEWithCTC)
from s2t_tpu_torch.criterions.label_smoothed_ce import (
    LabelSmoothedCE, LabelSmoothedCEWithAlignment)
from s2t_tpu_torch.criterions.latency import LatencyAugmentedLabelSmoothedCE
from s2t_tpu_torch.criterions.masked_lm import LegacyMaskedLMCriterion, MaskedLMCriterion
from s2t_tpu_torch.criterions.nat_loss import NATLoss
from s2t_tpu_torch.criterions.wav2vec import Wav2VecCriterion
from s2t_tpu_torch.tasks.sentence_prediction import (
    SentencePredictionCriterion, SentenceRankingCriterion)

CRITERIONS = {
    "label_smoothed_cross_entropy_with_ctc": LabelSmoothedCEWithCTC,
    "ctc": CTCCriterion,
    "label_smoothed_cross_entropy": LabelSmoothedCE,
    # JAX registers the plain name on the same class, smoothing 0.1 by default
    "cross_entropy": LabelSmoothedCE,
    "join_speech_and_text_loss": JoinSpeechAndTextLoss,
    "wav2vec": Wav2VecCriterion,
    "adaptive_loss": AdaptiveLoss,
    "label_smoothed_cross_entropy_with_alignment": LabelSmoothedCEWithAlignment,
    "nat_loss": NATLoss,
    "masked_lm": MaskedLMCriterion,
    "legacy_masked_lm": LegacyMaskedLMCriterion,
    "sentence_prediction": SentencePredictionCriterion,
    "sentence_ranking": SentenceRankingCriterion,
    "latency_augmented_label_smoothed_cross_entropy": LatencyAugmentedLabelSmoothedCE,
    "composite_loss": CompositeLoss,
    "model": ModelCriterion,
}


def _from_dict(cls, values: Dict[str, Any]):
    known = {f.name: f for f in dataclasses.fields(cls)}
    unknown = sorted(set(values) - set(known))
    if unknown:
        raise KeyError(f"{cls.__qualname__} has no fields {unknown}")
    kw = {}
    for name, val in values.items():
        default = known[name].default_factory() if known[name].default_factory \
            is not dataclasses.MISSING else known[name].default
        if dataclasses.is_dataclass(default) and isinstance(val, dict):
            val = _from_dict(type(default), val)
        elif isinstance(default, tuple) and isinstance(val, list):
            val = tuple(val)
        elif isinstance(default, float) and type(val) is int:
            val = float(val)
        kw[name] = val
    return cls(**kw)


def build_criterion(name: str, cfg_dict: Dict[str, Any] | None = None, **ctx):
    if name not in CRITERIONS:
        raise NotImplementedError(
            f"criterion {name!r} is not ported to s2t_tpu_torch (ported: {sorted(CRITERIONS)})")
    cls = CRITERIONS[name]
    return cls(_from_dict(cls.Config, {**(cfg_dict or {}), **ctx}))

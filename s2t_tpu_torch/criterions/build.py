"""Criterion by registry name (counterpart of s2t_tpu/criterions/build.py).

The names of the ported criteria map to their classes; any other name raises.
``cfg_dict`` fills the criterion's Config, nested dataclasses from nested
dicts (``{"ctc": {"ctc_weight": 0.3}}``); an unknown key raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from s2t_tpu_torch.criterions.ctc import CTCCriterion, LabelSmoothedCEWithCTC
from s2t_tpu_torch.criterions.label_smoothed_ce import LabelSmoothedCE

CRITERIONS = {
    "label_smoothed_cross_entropy_with_ctc": LabelSmoothedCEWithCTC,
    "ctc": CTCCriterion,
    "label_smoothed_cross_entropy": LabelSmoothedCE,
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
        kw[name] = val
    return cls(**kw)


def build_criterion(name: str, cfg_dict: Dict[str, Any] | None = None, **ctx):
    if name not in CRITERIONS:
        raise NotImplementedError(
            f"criterion {name!r} is not ported to s2t_tpu_torch (ported: {sorted(CRITERIONS)})")
    cls = CRITERIONS[name]
    return cls(_from_dict(cls.Config, {**(cfg_dict or {}), **ctx}))

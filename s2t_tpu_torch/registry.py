"""Named registries (counterpart of s2t_tpu/registry.py:17-109).

The registries this port fills: tasks, model architectures, feature
transforms, tokenizers and scorers.  Criteria keep their own table
(``criterions/build.py``).  A name that is registered in the JAX package but
not ported raises ``KeyError`` listing the ported names.
"""

from __future__ import annotations

from typing import Any, Callable, Dict


class Registry:
    """A named string -> object registry with decorator-style registration."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Any] = {}

    def register(self, name: str, obj: Any | None = None):
        if obj is not None:
            self._register(name, obj)
            return obj

        def deco(o):
            self._register(name, o)
            return o

        return deco

    def _register(self, name: str, obj: Any):
        if name in self._entries and self._entries[name] is not obj:
            raise ValueError(f"duplicate {self.kind} registration: {name!r}")
        self._entries[name] = obj

    def get(self, name: str) -> Any:
        if name not in self._entries:
            known = ", ".join(sorted(self._entries))
            raise KeyError(f"unknown {self.kind} {name!r}; known: {known}")
        return self._entries[name]

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def keys(self):
        return sorted(self._entries)


TASKS = Registry("task")
MODELS = Registry("model")
ARCHS = Registry("model architecture")  # name -> (model_name, config factory)
TOKENIZERS = Registry("tokenizer")
FEATURE_TRANSFORMS = Registry("feature transform")
SCORERS = Registry("scorer")


def register_task(name: str):
    return TASKS.register(name)


def register_model(name: str):
    return MODELS.register(name)


def register_model_architecture(model_name: str, arch_name: str):
    """Register an arch preset: a function of config overrides returning the
    model config for this named architecture."""

    def deco(fn: Callable):
        ARCHS.register(arch_name, (model_name, fn))
        return fn

    return deco


def register_tokenizer(name: str):
    return TOKENIZERS.register(name)


def register_feature_transform(name: str):
    return FEATURE_TRANSFORMS.register(name)


def register_scorer(name: str):
    return SCORERS.register(name)

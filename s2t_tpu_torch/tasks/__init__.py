"""Tasks (counterpart of s2t_tpu/tasks/__init__.py).  Importing registers the
ported tasks: ``speech_to_text``, ``audio_pretraining``, the translation tasks,
``translation_lev``, ``language_modeling``, ``denoising`` and
``multilingual_denoising``."""

from s2t_tpu_torch.tasks import (  # noqa: F401
    audio_pretraining, denoising, language_modeling, speech_to_text, translation, translation_lev)
from s2t_tpu_torch.tasks.base import Task, setup_task  # noqa: F401

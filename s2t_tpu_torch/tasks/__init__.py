"""Tasks (counterpart of s2t_tpu/tasks/__init__.py).  Importing registers the
ported tasks: ``speech_to_text``, ``audio_pretraining``, the translation tasks,
``translation_lev``, ``language_modeling``, ``denoising``,
``multilingual_denoising``, ``multilingual_translation`` /
``translation_multi_simple_epoch``, the masked-LM tasks (``masked_lm``,
``cross_lingual_lm``, ``legacy_masked_lm``), ``sentence_prediction`` and
``sentence_ranking``: every task of the JAX package but ``semisupervised_translation``,
which raises."""

from s2t_tpu_torch.tasks import (  # noqa: F401
    audio_pretraining, denoising, language_modeling, masked_lm, multilingual_translation,
    sentence_prediction, speech_to_text, translation, translation_lev)
from s2t_tpu_torch.tasks.base import Task, setup_task  # noqa: F401

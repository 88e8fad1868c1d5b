"""Tasks (counterpart of s2t_tpu/tasks/__init__.py).  Importing registers the
ported tasks: ``speech_to_text``, ``audio_pretraining`` and the translation tasks."""

from s2t_tpu_torch.tasks import audio_pretraining, speech_to_text, translation  # noqa: F401
from s2t_tpu_torch.tasks.base import Task, setup_task  # noqa: F401

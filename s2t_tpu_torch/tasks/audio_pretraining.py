"""wav2vec pretraining task (counterpart of s2t_tpu/tasks/audio_pretraining.py).

``{split}.tsv`` manifests under the data directory (``data/raw_audio_dataset.py``),
cropped to ``task_cfg.max_sample_size`` raw samples (250,000 by default) and
normalised when the model section sets ``normalize``; the model of ``arch``
(``wav2vec2_base`` by default, or wav2vec v1's ``wav2vec``) and the ``wav2vec``
criterion.  The forward adapter hands the waveforms to the model with the Gumbel
temperature annealed by the update count, max(t0 * decay^step, t1) in float32
(wav2vec 2.0's ``latent_temp``, v1's ``vq_temp``); in eval the model masks and samples negatives from a
generator of a fixed seed, where JAX fixes its key (a deliberate deviation of
the bits, not of the semantics).  There is no generator.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import torch

from s2t_tpu_torch.data.raw_audio_dataset import RawAudioDataset
from s2t_tpu_torch.registry import register_task
from s2t_tpu_torch.tasks.base import Task


def gumbel_temperature(latent_temp, step: int) -> torch.Tensor:
    """max(t0 * decay^step, t1), in float32 as JAX evaluates it."""
    t0, t1, decay = (torch.tensor(v, dtype=torch.float32) for v in latent_temp)
    return torch.maximum(t0 * decay ** torch.tensor(float(step)), t1)


@register_task("audio_pretraining")
class AudioPretrainingTask(Task):
    DEFAULT_MAX_SAMPLE_SIZE = 250_000

    def load_dataset(self, split: str, is_train: bool = False):
        model_cfg = self.cfg.model if isinstance(self.cfg.model, dict) else {}
        ds = RawAudioDataset(
            Path(self.cfg.dataset.data) / f"{split}.tsv",
            max_sample_size=int(self.cfg.task_cfg.get("max_sample_size",
                                                      self.DEFAULT_MAX_SAMPLE_SIZE)),
            normalize=bool(model_cfg.get("normalize", False)))
        self.datasets[split] = ds
        return ds

    def build_model(self, device="cuda", seed: Optional[int] = None, for_training: bool = False):
        from s2t_tpu_torch.models.build import build_model

        return build_model(self.cfg.arch or "wav2vec2_base", self.cfg.model, device=device,
                           seed=self.cfg.common.seed if seed is None else seed,
                           for_training=for_training)

    def build_criterion(self):
        from s2t_tpu_torch.criterions.build import build_criterion

        return build_criterion(self.cfg.criterion or "wav2vec", self.cfg.criterion_cfg)

    def forward_fn(self):
        def fwd(model, batch, train: bool = False, generator: Optional[torch.Generator] = None):
            # wav2vec 2.0's latent_temp, wav2vec v1's vq_temp (audio_pretraining.py:45-58)
            schedule = getattr(model.cfg, "latent_temp", None) or model.cfg.vq_temp
            temp = gumbel_temperature(schedule, int(batch.get("_step", 0)))
            return model(batch["source"], batch["lengths"], train=train, generator=generator,
                         temp=temp, draws=batch.get("draws"))

        return fwd

    def build_generator(self, model, gen_cfg=None):
        raise NotImplementedError("audio_pretraining has no generator")

    def decode_tokens(self, tokens) -> str:
        raise NotImplementedError("audio_pretraining has no dictionary")

"""Many-to-many translation (counterpart of s2t_tpu/tasks/multilingual_translation.py:30-154),
registered as ``multilingual_translation`` and ``translation_multi_simple_epoch``.

``task_cfg.lang_pairs`` (``["de-en", "fr-en"]``; default the data config's one pair)
names the pairs; each pair's files are ``<split>.<src>-<tgt>.<src|tgt>``.  The arch
picks the regime:

* a ``multilingual_transformer*`` arch (``per_pair_models``, read from the port's arch
  registry): the pairs zipped by ``RoundRobinZipDataset``, so one update trains every
  pair, under ``MultilingualCriterion``; ``eval_lang_pair`` (``task_cfg``, default the
  first pair) is the pair ``cli.generate`` decodes, from ``load_pair_dataset``,
  through the model's ``pair_view``;
* any other arch, one shared model: the pairs' ``TranslationDataset``s, each target
  tagged with its ``<lang:xx>`` symbol, concatenated by ``MultilingualS2TDataset``
  (temperature ``task_cfg.sampling_alpha``, 1 by default, upsampling in training);
  a dictionary without a pair's tag raises ``ValueError`` (Dictionary.index would map
  it to ``<unk>`` silently).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional

import torch

from s2t_tpu_torch.data.multilingual import MultilingualS2TDataset, RoundRobinZipDataset
from s2t_tpu_torch.data.text_dataset import TranslationDataset
from s2t_tpu_torch.registry import ARCHS, register_task
from s2t_tpu_torch.tasks.translation import TranslationTask


def zip_forward(model, batch: Dict[str, Any], train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
    """The forward adapter of the round-robin regime: every pair of the zip batch."""
    return model(batch["pairs"], train=train, generator=generator)


@register_task("translation_multi_simple_epoch")
@register_task("multilingual_translation")
class MultilingualTranslationTask(TranslationTask):
    @property
    def lang_pairs(self):
        pairs = (self.cfg.task_cfg or {}).get("lang_pairs")
        return list(pairs) if pairs else [f"{self.data_cfg.src_lang}-{self.data_cfg.tgt_lang}"]

    @property
    def per_pair_models(self) -> bool:
        if not self.cfg.arch:
            return False
        from s2t_tpu_torch.models import build  # noqa: F401  (fills the arch registry)

        return self.cfg.arch in ARCHS and ARCHS.get(self.cfg.arch)[0] == "multilingual_transformer"

    def _pair_dataset(self, split: str, pair: str, tagged: bool):
        root = Path(self.cfg.dataset.data)
        sl, tl = pair.split("-")
        src, tgt = root / f"{split}.{sl}-{tl}.{sl}", root / f"{split}.{sl}-{tl}.{tl}"
        if not src.exists():
            return None
        tag = None
        if tagged:
            tag = self.tgt_dict.index(f"<lang:{tl}>")
            if tag == self.tgt_dict.unk():
                raise ValueError(f"dictionary is missing the language tag <lang:{tl}> (add it "
                                 "to dict.txt for multilingual training)")
        return TranslationDataset(src, tgt if tgt.exists() else None, self.src_dict,
                                  self.tgt_dict, self.src_bpe, self.bpe, tgt_lang_tag=tag)

    def load_dataset(self, split: str, is_train: bool = False):
        per_pair = self.per_pair_models
        parts = {}
        for pair in self.lang_pairs:
            ds = self._pair_dataset(split, pair, tagged=not per_pair)
            if ds is not None:
                parts[pair] = ds
        if not parts:
            raise FileNotFoundError(f"no data for split {split!r} and pairs {self.lang_pairs}")
        if per_pair:
            ds = RoundRobinZipDataset(parts)
        else:
            items = [parts[p] for p in self.lang_pairs if p in parts]
            ds = items[0] if len(items) == 1 else MultilingualS2TDataset(
                items, alpha=(self.cfg.task_cfg or {}).get("sampling_alpha", 1.0),
                resample=is_train)
        self.datasets[split] = ds
        return ds

    def build_model(self, device="cuda", seed: Optional[int] = None, for_training: bool = False):
        if not self.per_pair_models:
            return super().build_model(device=device, seed=seed, for_training=for_training)
        from s2t_tpu_torch.models.build import build_model

        return build_model(
            self.cfg.arch, self.cfg.model, device=device,
            seed=self.cfg.common.seed if seed is None else seed, for_training=for_training,
            vocab_size=len(self.tgt_dict), src_vocab_size=len(self.src_dict),
            lang_pairs=tuple(self.lang_pairs),
            max_source_positions=self.cfg.dataset.max_source_positions,
            max_target_positions=self.cfg.dataset.max_target_positions)

    def build_criterion(self):
        base = super().build_criterion()
        if not self.per_pair_models:
            return base
        from s2t_tpu_torch.criterions.multilingual import MultilingualCriterion

        return MultilingualCriterion(base)

    @property
    def eval_lang_pair(self) -> Optional[str]:
        if not self.per_pair_models:
            return None
        return (self.cfg.task_cfg or {}).get("eval_lang_pair", self.lang_pairs[0])

    def load_pair_dataset(self, split: str, pair: str):
        """One pair's dataset, for ``cli.generate`` (training and validation zip them)."""
        ds = self._pair_dataset(split, pair, tagged=False)
        if ds is None:
            raise FileNotFoundError(f"no data for split {split!r} pair {pair!r}")
        return ds

    def build_generator(self, model, gen_cfg=None):
        if self.per_pair_models and hasattr(model, "pair_view"):
            model = model.pair_view(self.eval_lang_pair)
        return super().build_generator(model, gen_cfg)

    def forward_fn(self):
        return zip_forward if self.per_pair_models else super().forward_fn()

"""Language modeling over monolingual text (counterpart of
s2t_tpu/tasks/language_modeling.py).

The data directory holds ``dict.txt`` and ``<split>.txt``; ``task_cfg.bpe_tokenizer``
names an optional tokenizer.  Every split is one ``MonolingualDataset`` of blocks
of ``task_cfg.tokens_per_sample`` tokens, else ``dataset.max_target_positions``,
else 128.  The model is ``cfg.arch`` (``transformer_lm`` by default) with the
dictionary's size; the forward adapter hands it ``prev_tokens``, and the targets
too when it has an adaptive softmax, whose exact path returns
``target_logprob`` for ``adaptive_loss``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional

import torch

from s2t_tpu_torch.config import TrainConfig
from s2t_tpu_torch.data.dictionary import Dictionary
from s2t_tpu_torch.data.text_dataset import MonolingualDataset
from s2t_tpu_torch.data.tokenizer import build_tokenizer
from s2t_tpu_torch.registry import register_task
from s2t_tpu_torch.tasks.base import Task


def lm_forward(model, batch: Dict[str, Any], train: bool = False,
               generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
    """The forward adapter of ``language_modeling`` (language_modeling.py:58-76)."""
    kw = {}
    if getattr(model.cfg, "adaptive_softmax_cutoff", ()) and "target" in batch:
        kw["targets"] = batch["target"]  # the adaptive softmax's exact path
    return model(batch["prev_tokens"], generator=generator if train else None, **kw)


@register_task("language_modeling")
class LanguageModelingTask(Task):
    def __init__(self, cfg: TrainConfig, dictionary: Dictionary, bpe=None,
                 block_size: int = 128):
        super().__init__(cfg)
        self.dictionary = self.tgt_dict = dictionary
        self.bpe = bpe
        self.block_size = block_size

    @classmethod
    def setup(cls, cfg: TrainConfig) -> "LanguageModelingTask":
        task_cfg = cfg.task_cfg or {}
        dictionary = Dictionary.load(Path(cfg.dataset.data) / "dict.txt")
        bpe = build_tokenizer(task_cfg["bpe_tokenizer"]) if task_cfg.get("bpe_tokenizer") \
            else None
        # the block defaults to the model's position budget, so the two cannot drift apart
        block = task_cfg.get("tokens_per_sample") or cfg.dataset.max_target_positions or 128
        return cls(cfg, dictionary, bpe, block)

    def load_dataset(self, split: str, is_train: bool = False):
        ds = MonolingualDataset(Path(self.cfg.dataset.data) / f"{split}.txt", self.dictionary,
                                self.bpe, self.block_size)
        self.datasets[split] = ds
        return ds

    def build_model(self, device="cuda", seed: Optional[int] = None, for_training: bool = False):
        from s2t_tpu_torch.models.build import build_model

        return build_model(
            self.cfg.arch or "transformer_lm", self.cfg.model, device=device,
            seed=self.cfg.common.seed if seed is None else seed, for_training=for_training,
            vocab_size=len(self.dictionary),
            max_target_positions=self.cfg.dataset.max_target_positions)

    def forward_fn(self):
        return lm_forward

    def decode_tokens(self, tokens) -> str:
        return self.dictionary.string(tokens)

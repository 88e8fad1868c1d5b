"""BART's denoising pretraining tasks (counterpart of s2t_tpu/tasks/denoising.py).

``denoising``: ``<data>/<split>.txt`` lines through ``DenoisingDataset`` over
``<data>/dict.txt`` with ``<mask>`` added; the noise knobs come from ``task_cfg``
(``mask_ratio``, ``poisson_lambda``, ``random_ratio``, ``insert_ratio``,
``delete_ratio``, ``permute_sentence_ratio``) and the seed from ``common.seed``.
The model is ``cfg.arch`` (``bart_base`` by default) over the dictionary, fed
``src_tokens`` / ``src_lengths`` / ``prev_tokens``, and decoded by
``SequenceGenerator``.

``multilingual_denoising``: one corpus a language at ``<data>/<lang>/<split>.txt``
(``task_cfg.langs``, comma-separated, or every subdirectory with a ``train.txt``),
``<lang:xx>`` added to the dictionary after ``<mask>``, each language's items
tagged, and the languages joined by ``MultilingualS2TDataset`` with temperature
``sampling_alpha`` (0.7 by default) upsampling in training.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from s2t_tpu_torch.config import TrainConfig
from s2t_tpu_torch.data.denoising_dataset import DenoisingDataset
from s2t_tpu_torch.data.dictionary import Dictionary
from s2t_tpu_torch.data.multilingual import MultilingualS2TDataset
from s2t_tpu_torch.inference.generator import SequenceGenerator
from s2t_tpu_torch.registry import register_task
from s2t_tpu_torch.tasks.base import Task

NOISE_DEFAULTS = {"mask_ratio": 0.3, "poisson_lambda": 3.5, "random_ratio": 0.1,
                  "insert_ratio": 0.0, "delete_ratio": 0.0, "permute_sentence_ratio": 1.0}


@register_task("denoising")
class DenoisingTask(Task):
    def __init__(self, cfg: TrainConfig, dictionary: Dictionary):
        super().__init__(cfg)
        self.dictionary = self.tgt_dict = self.src_dict = dictionary
        self.mask_id = dictionary.add_symbol("<mask>")

    @classmethod
    def setup(cls, cfg: TrainConfig) -> "DenoisingTask":
        return cls(cfg, Dictionary.load(Path(cfg.dataset.data) / "dict.txt"))

    def _noise_kwargs(self) -> dict:
        t = self.cfg.task_cfg or {}
        return {**{k: t.get(k, v) for k, v in NOISE_DEFAULTS.items()},
                "seed": self.cfg.common.seed}

    def load_dataset(self, split: str, is_train: bool = False):
        ds = DenoisingDataset(Path(self.cfg.dataset.data) / f"{split}.txt", self.dictionary,
                              **self._noise_kwargs())
        self.datasets[split] = ds
        return ds

    def build_model(self, device="cuda", seed: Optional[int] = None, for_training: bool = False):
        from s2t_tpu_torch.models.build import build_model

        return build_model(
            self.cfg.arch or "bart_base", self.cfg.model, device=device,
            seed=self.cfg.common.seed if seed is None else seed, for_training=for_training,
            vocab_size=len(self.dictionary),
            max_source_positions=self.cfg.dataset.max_source_positions,
            max_target_positions=self.cfg.dataset.max_target_positions)

    def forward_fn(self):
        from s2t_tpu_torch.models.transformer import text_forward

        return text_forward

    def build_generator(self, model, gen_cfg=None):
        g = gen_cfg or self.cfg.generation
        return SequenceGenerator(
            model, beam_size=g.beam, max_len_a=g.max_len_a, max_len_b=g.max_len_b,
            min_len=g.min_len, lenpen=g.lenpen, temperature=g.temperature,
            no_repeat_ngram_size=g.no_repeat_ngram_size, eos_id=self.tgt_dict.eos(),
            pad_id=self.tgt_dict.pad(), max_target_positions=self.cfg.dataset.max_target_positions,
            input_keys=("src_tokens", "src_lengths"))

    def decode_tokens(self, tokens) -> str:
        return self.dictionary.string(tokens, bpe_symbol=self.cfg.generation.post_process)


@register_task("multilingual_denoising")
class MultilingualDenoisingTask(DenoisingTask):
    def __init__(self, cfg: TrainConfig, dictionary: Dictionary, langs):
        super().__init__(cfg, dictionary)
        self.langs = langs
        self.lang_tags = {lang: dictionary.add_symbol(f"<lang:{lang}>") for lang in langs}

    @classmethod
    def setup(cls, cfg: TrainConfig) -> "MultilingualDenoisingTask":
        root = Path(cfg.dataset.data)
        langs = (cfg.task_cfg or {}).get("langs")
        if langs:
            langs = [lang for lang in str(langs).split(",") if lang]
        else:
            langs = sorted(p.name for p in root.iterdir()
                           if p.is_dir() and (p / "train.txt").exists())
        return cls(cfg, Dictionary.load(root / "dict.txt"), langs)

    def load_dataset(self, split: str, is_train: bool = False):
        root = Path(self.cfg.dataset.data)
        per_lang = [DenoisingDataset(root / lang / f"{split}.txt", self.dictionary,
                                     lang_tag=self.lang_tags[lang], **self._noise_kwargs())
                    for lang in self.langs]
        ds = MultilingualS2TDataset(per_lang, alpha=(self.cfg.task_cfg or {}).get(
            "sampling_alpha", 0.7), resample=is_train)
        self.datasets[split] = ds
        return ds

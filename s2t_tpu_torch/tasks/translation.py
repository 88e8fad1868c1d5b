"""Translation tasks: MT over raw text with on-the-fly subword tokenisation, or
over fairseq-binarised pairs (counterpart of s2t_tpu/tasks/translation.py:45-167).

Registered as ``translation``, ``translation_with_tokenizer`` and
``translation_from_pretrained_xlm`` (the last is this task with a pretrained
encoder transplanted by ``checkpoint.load_pretrained_encoder_from``).  The data
directory holds the dictionaries and an optional ``config.yaml``
(``TransDataConfig``); ``load_dataset`` prefers a binarised
``<split>.<src>-<tgt>.<src>.bin`` pair and reads ``<split>.<src>`` /
``<split>.<tgt>`` text otherwise.  The model is ``cfg.arch`` (``transformer``
by default) with the dictionaries' sizes; the forward adapter hands
``src_tokens``, ``src_lengths`` and ``prev_tokens`` to it; the generator is
``SequenceGenerator`` over ``src_tokens`` / ``src_lengths`` with every
generation option of the JAX task.

With ``task_cfg.load_alignments`` a raw-text split reads ``<split>.align`` too
(Pharaoh word alignments, for ``transformer_align``); the binarised path does not,
as in JAX.

``translation_from_pretrained_bart`` fine-tunes mBART (s2t_tpu/tasks/translation.py:241-285):
``<mask>`` and then ``<lang:xx>`` for each of ``task_cfg.langs`` join each dictionary
once (a shared dictionary once in all), every source gets its language's tag
appended after EOS and every target its language's tag prepended; the pretrained
weights come in through ``checkpoint.finetune_from_model``.

Under ``latency_augmented_label_smoothed_cross_entropy`` the forward adapter captures
every decoder layer's cross-attention probabilities as ``cross_attn`` (B, H·L, U, S)
(``criterions/latency.capture_cross_attn``), as the JAX task stacks the sown ones.

``semisupervised_translation`` (s2t_tpu/tasks/translation.py:170-240) trains on the
bitext plus online backtranslation of ``mono.<tgt>``: a reverse (tgt -> src) model
from the port's checkpoint ``task_cfg.bt_checkpoint`` (arch ``bt_arch``, config
``bt_model`` or the checkpoint's ``model`` metadata, beam ``bt_beam``) generates each
synthetic batch's sources on ``task.device``; with ``lambda_denoising`` > 0 a third
stream of noised monolingual text -> clean text (``word_shuffle``,
``word_dropout_prob``, ``word_blanking_prob``) joins it.  Batches stay single-origin
(``ConcatHomogeneous``); each carries its ``origin`` (0 bitext, 1 backtranslation,
2 denoising).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from s2t_tpu_torch.config import TrainConfig
from s2t_tpu_torch.data.dictionary import Dictionary
from s2t_tpu_torch.data.indexed_dataset import BinarizedTranslationDataset
from s2t_tpu_torch.data.text_dataset import TranslationDataset
from s2t_tpu_torch.data.tokenizer import build_tokenizer
from s2t_tpu_torch.inference.generator import SequenceGenerator
from s2t_tpu_torch.registry import register_task
from s2t_tpu_torch.tasks.base import Task


@dataclass
class TransDataConfig:
    """The data directory's config.yaml for MT (s2t_tpu/tasks/translation.py:26-42)."""

    vocab_filename: str = "dict.txt"
    src_vocab_filename: Optional[str] = None
    bpe_tokenizer: Optional[dict] = None
    src_bpe_tokenizer: Optional[dict] = None
    src_lang: str = "en"
    tgt_lang: str = "de"

    @classmethod
    def from_yaml(cls, path) -> "TransDataConfig":
        import yaml  # only where a data directory has a config.yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        return cls(**{k: v for k, v in raw.items() if k in cls.__dataclass_fields__})


@register_task("translation")
@register_task("translation_with_tokenizer")
@register_task("translation_from_pretrained_xlm")
class TranslationTask(Task):
    def __init__(self, cfg: TrainConfig, data_cfg: TransDataConfig, tgt_dict: Dictionary,
                 src_dict: Optional[Dictionary] = None):
        super().__init__(cfg)
        self.data_cfg = data_cfg
        self.tgt_dict = tgt_dict
        self.src_dict = src_dict or tgt_dict
        self.bpe = build_tokenizer(data_cfg.bpe_tokenizer)
        self.src_bpe = build_tokenizer(data_cfg.src_bpe_tokenizer) or self.bpe

    @classmethod
    def setup(cls, cfg: TrainConfig) -> "TranslationTask":
        root = Path(cfg.dataset.data)
        dc_path = root / "config.yaml"
        data_cfg = TransDataConfig.from_yaml(dc_path) if dc_path.exists() else TransDataConfig()
        tgt_dict = Dictionary.load(root / data_cfg.vocab_filename)
        src_dict = (Dictionary.load(root / data_cfg.src_vocab_filename)
                    if data_cfg.src_vocab_filename else None)
        return cls(cfg, data_cfg, tgt_dict, src_dict)

    def load_dataset(self, split: str, is_train: bool = False):
        root = Path(self.cfg.dataset.data)
        sl, tl = self.data_cfg.src_lang, self.data_cfg.tgt_lang
        bin_src = root / f"{split}.{sl}-{tl}.{sl}"
        if Path(f"{bin_src}.bin").exists():
            bin_tgt = root / f"{split}.{sl}-{tl}.{tl}"
            ds = BinarizedTranslationDataset(
                bin_src, bin_tgt if Path(f"{bin_tgt}.bin").exists() else None)
        else:
            align = root / f"{split}.align"
            tgt = root / f"{split}.{tl}"
            ds = TranslationDataset(
                root / f"{split}.{sl}", tgt if tgt.exists() else None, self.src_dict,
                self.tgt_dict, self.src_bpe, self.bpe,
                align_path=align if ((self.cfg.task_cfg or {}).get("load_alignments")
                                     and align.exists()) else None)
        self.datasets[split] = ds
        return ds

    default_arch = "transformer"

    def build_model(self, device="cuda", seed: Optional[int] = None, for_training: bool = False):
        from s2t_tpu_torch.models.build import build_model

        return build_model(
            self.cfg.arch or self.default_arch, self.cfg.model, device=device,
            seed=self.cfg.common.seed if seed is None else seed, for_training=for_training,
            vocab_size=len(self.tgt_dict), src_vocab_size=len(self.src_dict),
            max_source_positions=self.cfg.dataset.max_source_positions,
            max_target_positions=self.cfg.dataset.max_target_positions)

    def forward_fn(self):
        from s2t_tpu_torch.criterions.latency import with_cross_attn
        from s2t_tpu_torch.models.transformer import text_forward

        if self.cfg.criterion.startswith("latency_augmented"):
            return with_cross_attn(text_forward)
        return text_forward

    def build_generator(self, model, gen_cfg=None):
        g = gen_cfg or self.cfg.generation
        return SequenceGenerator(
            model, beam_size=g.beam, max_len_a=g.max_len_a, max_len_b=g.max_len_b,
            min_len=g.min_len, lenpen=g.lenpen, temperature=g.temperature,
            no_repeat_ngram_size=g.no_repeat_ngram_size, eos_id=self.tgt_dict.eos(),
            pad_id=self.tgt_dict.pad(), max_target_positions=self.cfg.dataset.max_target_positions,
            input_keys=("src_tokens", "src_lengths"), prefix_size=g.prefix_size,
            diverse_beam_groups=g.diverse_beam_groups,
            diverse_beam_strength=g.diverse_beam_strength, diversity_rate=g.diversity_rate,
            constraints_mode=g.constraints)

    def decode_tokens(self, tokens) -> str:
        return self.tgt_dict.string(tokens, bpe_symbol=self.cfg.generation.post_process)


@register_task("semisupervised_translation")
class SemisupervisedTranslationTask(TranslationTask):
    """Bitext + online backtranslation (+ denoising); see the module docstring."""

    def load_dataset(self, split: str, is_train: bool = False):
        bitext = super().load_dataset(split, is_train)
        t = self.cfg.task_cfg or {}
        mono = Path(self.cfg.dataset.data) / f"mono.{self.data_cfg.tgt_lang}"
        ckpt = t.get("bt_checkpoint")
        if not is_train or not ckpt or not mono.exists():
            return bitext
        from s2t_tpu_torch.data.backtranslation_dataset import (
            BacktranslationDataset, ConcatHomogeneous, make_backtranslator)
        from s2t_tpu_torch.models.build import build_model
        from s2t_tpu_torch.utils.checkpoint import load_checkpoint

        tree, meta = load_checkpoint(ckpt)
        rev = build_model(
            t.get("bt_arch", self.cfg.arch or self.default_arch),
            t.get("bt_model", meta.get("model", {})), device=self.device,
            seed=self.cfg.common.seed, vocab_size=len(self.src_dict),
            src_vocab_size=len(self.tgt_dict),
            max_source_positions=self.cfg.dataset.max_source_positions,
            max_target_positions=self.cfg.dataset.max_target_positions)
        rev.load_state_dict(tree.get("params", tree))
        gen = SequenceGenerator(
            rev, beam_size=int(t.get("bt_beam", 1)),
            max_len_b=self.cfg.dataset.max_source_positions, eos_id=self.src_dict.eos(),
            pad_id=self.src_dict.pad(), max_target_positions=self.cfg.dataset.max_source_positions,
            input_keys=("src_tokens", "src_lengths"))
        parts = [bitext, BacktranslationDataset(mono, self.tgt_dict,
                                                make_backtranslator(rev, gen), tgt_bpe=self.bpe)]
        if float(t.get("lambda_denoising", 0.0)) > 0:
            from s2t_tpu_torch.data.wrappers import NoisingDataset

            parts.append(NoisingDataset(
                TranslationDataset(mono, mono, self.tgt_dict, self.tgt_dict, self.bpe, self.bpe),
                self.tgt_dict, seed=self.cfg.common.seed,
                max_word_shuffle_distance=float(t.get("word_shuffle", 3)),
                word_dropout_prob=float(t.get("word_dropout_prob", 0.1)),
                word_blanking_prob=float(t.get("word_blanking_prob", 0.1))))
        ds = ConcatHomogeneous(parts)
        self.datasets[split] = ds
        return ds


@register_task("translation_from_pretrained_bart")
class TranslationFromPretrainedBARTTask(TranslationTask):
    default_arch = "mbart_large"

    def __init__(self, cfg: TrainConfig, data_cfg: TransDataConfig, tgt_dict: Dictionary,
                 src_dict: Optional[Dictionary] = None):
        super().__init__(cfg, data_cfg, tgt_dict, src_dict)
        self.langs = [lang for lang in str((cfg.task_cfg or {}).get("langs", "")).split(",")
                      if lang]
        for d in {id(self.src_dict): self.src_dict, id(self.tgt_dict): self.tgt_dict}.values():
            d.add_symbol("<mask>")
            for lang in self.langs:
                d.add_symbol(f"<lang:{lang}>")

    def load_dataset(self, split: str, is_train: bool = False):
        root = Path(self.cfg.dataset.data)
        sl, tl = self.data_cfg.src_lang, self.data_cfg.tgt_lang
        tgt = root / f"{split}.{tl}"
        ds = TranslationDataset(
            root / f"{split}.{sl}", tgt if tgt.exists() else None, self.src_dict, self.tgt_dict,
            self.src_bpe, self.bpe, tgt_lang_tag=self.tgt_dict.index(f"<lang:{tl}>"),
            src_lang_tag=self.src_dict.index(f"<lang:{sl}>"))
        self.datasets[split] = ds
        return ds


"""Masked-LM pretraining tasks: ``masked_lm``, ``cross_lingual_lm`` and
``legacy_masked_lm`` (counterpart of s2t_tpu/tasks/masked_lm.py:25-316).

``masked_lm``: ``<data>/<split>.txt`` as ``MonolingualDataset`` blocks of
min(``dataset.max_target_positions`` or 128, 512) tokens over ``<data>/dict.txt`` with
``<mask>`` added; ``roberta_base`` by default under the ``masked_lm`` criterion.  The
forward adapter masks each block BERT's way (``apply_bert_masking``) before the model
sees it.  JAX draws the masks inside its compiled step from ``jax.random``
(:91-96); the port draws them from a generator seeded by the step's seed folded with
``MASK_FOLD`` (JAX folds its dropout key with the same 11), seed 0 in evaluation, on
the model's device, or takes them handed over as ``batch["draws"]`` (``mask_uniforms``
and ``kind_uniforms`` (B, L) in [0, 1), ``random_tokens`` (B, L)), which is how the
tests hold the port to JAX's draws (ROADMAP.md section 3).

``cross_lingual_lm`` (XLM): one corpus a language at ``<data>/<lang>/<split>.txt``
(``task_cfg.langs``, comma-separated, or every subdirectory with a ``train.txt``),
blocks one token shorter with the language's ``<lang:xx>`` symbol in front, the
languages joined by ``MultilingualS2TDataset`` (``sampling_alpha`` 0.7 by default).

``legacy_masked_lm`` (BERT): ``SentencePairDataset`` sentence pairs with segment ids
and next-sentence labels, ``bert_base`` by default under ``legacy_masked_lm``; the
``<cls>`` / ``<sep>`` markers (the dictionary's BOS / EOS) are never masked.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from s2t_tpu_torch.config import TrainConfig
from s2t_tpu_torch.data.batching import round_up
from s2t_tpu_torch.data.dictionary import Dictionary
from s2t_tpu_torch.data.multilingual import MultilingualS2TDataset
from s2t_tpu_torch.data.text_dataset import MonolingualDataset
from s2t_tpu_torch.registry import register_task
from s2t_tpu_torch.tasks.base import Task
from s2t_tpu_torch.trainer import fold_in

MASK_FOLD = 11
FIRST_RANDOM_TOKEN = 4  # random replacements never draw the special symbols


def apply_bert_masking(tokens: torch.Tensor, mask_id: int, vocab_size: int, pad_id: int = 1,
                       mask_prob: float = 0.15, leave_unmasked_prob: float = 0.1,
                       random_token_prob: float = 0.1, protect: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None,
                       draws: Optional[Dict[str, torch.Tensor]] = None):
    """(masked tokens, selected (B, L) bool): each non-pad, unprotected token is
    selected with ``mask_prob``; a selected one becomes ``<mask>`` (80 %), a random id
    from FIRST_RANDOM_TOKEN (10 %) or stays (10 %).  ``draws`` replaces the generator's."""
    draws = draws or {}

    def drawn(key, make):
        val = draws.get(key)
        if val is None:
            return make()
        return (val if isinstance(val, torch.Tensor) else torch.from_numpy(np.array(val))).to(
            tokens.device)

    shape, dev = tokens.shape, tokens.device
    maskable = tokens != pad_id
    if protect is not None:
        maskable = maskable & ~protect
    u1 = drawn("mask_uniforms", lambda: torch.rand(shape, generator=generator, device=dev))
    u2 = drawn("kind_uniforms", lambda: torch.rand(shape, generator=generator, device=dev))
    rand_tok = drawn("random_tokens", lambda: torch.randint(
        FIRST_RANDOM_TOKEN, vocab_size, shape, generator=generator, device=dev))
    sel = (u1 < mask_prob) & maskable
    use_mask = sel & (u2 < 1.0 - leave_unmasked_prob - random_token_prob)
    use_rand = sel & (u2 >= 1.0 - random_token_prob)
    out = torch.where(use_mask, mask_id, tokens)
    return torch.where(use_rand, rand_tok.to(tokens.dtype), out), sel


def mask_generator(model, train: bool, generator: Optional[torch.Generator]) -> torch.Generator:
    seed = fold_in(generator.initial_seed(), MASK_FOLD) if train and generator is not None \
        else 0
    return torch.Generator(device=model.device).manual_seed(seed)


@register_task("masked_lm")
class MaskedLMTask(Task):
    default_arch = "roberta_base"
    default_criterion = "masked_lm"

    def __init__(self, cfg: TrainConfig, dictionary: Dictionary, block_size: int = 128):
        super().__init__(cfg)
        self.dictionary = self.tgt_dict = dictionary
        self.block_size = block_size
        self.mask_id = dictionary.add_symbol("<mask>")

    @classmethod
    def setup(cls, cfg: TrainConfig) -> "MaskedLMTask":
        d = Dictionary.load(Path(cfg.dataset.data) / "dict.txt")
        return cls(cfg, d, block_size=min(cfg.dataset.max_target_positions or 128, 512))

    def load_dataset(self, split: str, is_train: bool = False):
        ds = MonolingualDataset(Path(self.cfg.dataset.data) / f"{split}.txt", self.dictionary,
                                block_size=self.block_size)
        self.datasets[split] = ds
        return ds

    def build_model(self, device="cuda", seed: Optional[int] = None, for_training: bool = False):
        from s2t_tpu_torch.models.build import build_model

        return build_model(
            self.cfg.arch or self.default_arch, self.cfg.model, device=device,
            seed=self.cfg.common.seed if seed is None else seed, for_training=for_training,
            vocab_size=len(self.dictionary),
            max_positions=self.cfg.dataset.max_target_positions or 512)

    def build_criterion(self):
        from s2t_tpu_torch.criterions.build import build_criterion

        return build_criterion(self.cfg.criterion or self.default_criterion,
                               self.cfg.criterion_cfg)

    def forward_fn(self):
        mask_id, vocab = self.mask_id, len(self.dictionary)

        def fwd(model, batch: Dict[str, Any], train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
            tokens = batch["target"].long()
            masked, sel = apply_bert_masking(tokens, mask_id, vocab,
                                             generator=mask_generator(model, train, generator),
                                             draws=batch.get("draws"))
            out = model(masked, train=train, generator=generator)
            return {**out, "mlm_targets": tokens, "mlm_mask": sel}

        return fwd

    def build_generator(self, model, gen_cfg=None):
        raise NotImplementedError(f"{type(self).__name__} has no generator")

    def decode_tokens(self, tokens) -> str:
        return self.dictionary.string(tokens)


@register_task("cross_lingual_lm")
class CrossLingualLMTask(MaskedLMTask):
    def __init__(self, cfg: TrainConfig, dictionary: Dictionary, langs, block_size: int = 128):
        super().__init__(cfg, dictionary, block_size)
        self.langs = langs
        self.lang_tags = {lang: dictionary.add_symbol(f"<lang:{lang}>") for lang in langs}

    @classmethod
    def setup(cls, cfg: TrainConfig) -> "CrossLingualLMTask":
        root = Path(cfg.dataset.data)
        langs = (cfg.task_cfg or {}).get("langs")
        if langs:
            langs = [lang for lang in str(langs).split(",") if lang]
        else:
            langs = sorted(p.name for p in root.iterdir()
                           if p.is_dir() and (p / "train.txt").exists())
        return cls(cfg, Dictionary.load(root / "dict.txt"), langs,
                   block_size=min(cfg.dataset.max_target_positions or 128, 512))

    def load_dataset(self, split: str, is_train: bool = False):
        root = Path(self.cfg.dataset.data)
        per_lang = []
        for lang in self.langs:
            # one token of each block left for the language's tag
            ds = MonolingualDataset(root / lang / f"{split}.txt", self.dictionary,
                                    block_size=self.block_size - 1)
            ds.blocks = np.concatenate(
                [np.full((len(ds.blocks), 1), self.lang_tags[lang], np.int32), ds.blocks], axis=1)
            ds.n_frames = np.full(len(ds.blocks), ds.blocks.shape[1], np.int64)
            per_lang.append(ds)
        ds = per_lang[0] if len(per_lang) == 1 else MultilingualS2TDataset(
            per_lang, alpha=(self.cfg.task_cfg or {}).get("sampling_alpha", 0.7),
            resample=is_train)
        self.datasets[split] = ds
        return ds


class SentencePairDataset:
    """BERT's sentence pairs (fairseq's legacy block_pair_dataset): sentence i and,
    with probability 0.5 decided per (seed, epoch, i), the next sentence, else a random
    other one, laid out ``<cls> A <sep> B <sep>`` and padded to ``max_positions``, B's
    span with segment 1.  The draws are numpy's, seeded as in JAX, draw for draw."""

    def __init__(self, path, dictionary: Dictionary, max_positions: int = 128, seed: int = 1):
        self.dictionary = dictionary
        self.max_positions = max_positions
        self.cls, self.sep = dictionary.bos(), dictionary.eos()
        self.seed = seed
        self.epoch = 1
        with open(path, encoding="utf-8") as f:
            self.sents = [dictionary.encode_line(line.strip(), append_eos=False)
                          for line in f if line.strip()]
        if len(self.sents) < 2:
            raise ValueError("sentence-pair dataset needs >= 2 sentences")
        self.n_frames = np.full(len(self.sents), max_positions, np.int64)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self):
        return len(self.sents)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        rng = np.random.default_rng(
            (self.seed * 0x9E3779B1 + self.epoch * 7919 + index) & 0x7FFFFFFF)
        a = self.sents[index]
        next_i = (index + 1) % len(self.sents)
        is_next = bool(rng.random() < 0.5)
        if is_next:
            b = self.sents[next_i]
        else:
            j = int(rng.integers(0, len(self.sents)))
            if j == next_i:  # the negative must not be the next sentence
                j = (j + 1) % len(self.sents)
            b = self.sents[j]
        L = self.max_positions
        budget = L - 3  # <cls> A <sep> B <sep>
        la = min(len(a), budget // 2)
        lb = min(len(b), budget - la)
        tokens = np.full(L, self.dictionary.pad(), np.int32)
        segments = np.zeros(L, np.int32)
        tokens[0] = self.cls
        tokens[1:1 + la] = a[:la]
        tokens[1 + la] = self.sep
        start = 2 + la
        tokens[start:start + lb] = b[:lb]
        tokens[start + lb] = self.sep
        segments[start:start + lb + 1] = 1
        return {"id": index, "tokens": tokens, "segments": segments, "nsp_label": int(is_next)}

    def ordered_indices(self, shuffle: bool = True, seed: int = 1, epoch: int = 1):
        if shuffle:
            return np.random.default_rng(seed + epoch).permutation(len(self))
        return np.arange(len(self))

    def collater(self, samples, frame_buckets=None, token_buckets=None, batch_multiple: int = 1,
                 pad_id: int = 1, eos_id: int = 2) -> Dict[str, Any]:
        B_real = len(samples)
        B = round_up(B_real, batch_multiple)
        L = self.max_positions
        tokens = np.full((B, L), pad_id, np.int32)
        segments = np.zeros((B, L), np.int32)
        labels = np.zeros(B, np.int32)
        for i, s in enumerate(samples):
            tokens[i], segments[i], labels[i] = s["tokens"], s["segments"], s["nsp_label"]
        return {"target": tokens, "segments": segments, "nsp_label": labels,
                "ntokens": float((tokens != pad_id).sum()), "nsentences": B_real,
                "ids": np.asarray([s["id"] for s in samples])}


@register_task("legacy_masked_lm")
class LegacyMaskedLMTask(MaskedLMTask):
    default_arch = "bert_base"
    default_criterion = "legacy_masked_lm"

    def load_dataset(self, split: str, is_train: bool = False):
        ds = SentencePairDataset(Path(self.cfg.dataset.data) / f"{split}.txt", self.dictionary,
                                 max_positions=self.block_size, seed=self.cfg.common.seed)
        self.datasets[split] = ds
        return ds

    def forward_fn(self):
        mask_id, vocab = self.mask_id, len(self.dictionary)
        cls_id, sep_id = self.dictionary.bos(), self.dictionary.eos()

        def fwd(model, batch: Dict[str, Any], train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
            tokens = batch["target"].long()
            masked, sel = apply_bert_masking(
                tokens, mask_id, vocab, protect=(tokens == cls_id) | (tokens == sep_id),
                generator=mask_generator(model, train, generator), draws=batch.get("draws"))
            out = model(masked, train=train, generator=generator, classification=True,
                        segments=batch.get("segments"))
            return {**out, "mlm_targets": tokens, "mlm_mask": sel}

        return fwd

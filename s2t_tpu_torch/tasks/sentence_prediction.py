"""Sentence classification and ranking on a RoBERTa encoder (counterpart of
s2t_tpu/tasks/sentence_prediction.py:27-299).

``sentence_prediction``: ``<data>/<split>.tsv`` rows "text<TAB>label" over
``dict.txt`` and ``labels.txt``, each text EOS-terminated and cut to
``dataset.max_target_positions`` (128 by default); ``roberta_base`` with
``num_classes`` = the labels, its head's ``cls_logits`` scored by the
``sentence_prediction`` criterion (cross-entropy a sentence, the collater's dummy
rows masked by ``row_valid``).

``sentence_ranking`` (RACE / WSC style): rows "cand0<TAB>cand1<TAB>...<TAB>gold";
every candidate runs through the encoder as a row of its own with a 1-way head, and
the ``sentence_ranking`` criterion is the cross-entropy of the gold one over the
candidates' scores.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from s2t_tpu_torch.config import TrainConfig
from s2t_tpu_torch.data.batching import round_up
from s2t_tpu_torch.data.dictionary import Dictionary
from s2t_tpu_torch.registry import register_task
from s2t_tpu_torch.tasks.base import Task


def _ids(samples, B: int) -> np.ndarray:
    return np.asarray([s["id"] for s in samples] + [-1] * (B - len(samples)))


def _seeded_order(n: int, shuffle: bool, seed: int, epoch: int) -> np.ndarray:
    return np.random.default_rng(seed + epoch).permutation(n) if shuffle else np.arange(n)


class SentenceDataset:
    def __init__(self, path, dictionary: Dictionary, labels: List[str], max_len: int = 128):
        self.dictionary = dictionary
        self.label_map = {label: i for i, label in enumerate(labels)}
        self.texts: List[np.ndarray] = []
        self.labels: List[int] = []
        for line in Path(path).read_text(encoding="utf-8").strip().split("\n"):
            text, label = line.rsplit("\t", 1)
            self.texts.append(dictionary.encode_line(text, append_eos=True)[:max_len])
            self.labels.append(self.label_map[label.strip()])
        self.n_frames = np.asarray([len(t) for t in self.texts], np.int64)

    def __len__(self):
        return len(self.texts)

    def __getitem__(self, i: int) -> Dict[str, Any]:
        return {"id": i, "tokens": self.texts[i], "label": self.labels[i]}

    def ordered_indices(self, shuffle: bool = True, seed: int = 1, epoch: int = 1):
        return _seeded_order(len(self), shuffle, seed, epoch)

    def collater(self, samples, frame_buckets=None, token_buckets=None, batch_multiple: int = 1,
                 pad_id: int = 1, **kw) -> Dict[str, Any]:
        B = round_up(len(samples), batch_multiple)
        toks = np.full((B, max(len(s["tokens"]) for s in samples)), pad_id, np.int32)
        labels = np.zeros((B,), np.int32)
        valid = np.zeros((B,), np.float32)
        for i, s in enumerate(samples):
            toks[i, :len(s["tokens"])] = s["tokens"]
            labels[i], valid[i] = s["label"], 1.0
        return {"tokens": toks, "labels": labels, "row_valid": valid, "ids": _ids(samples, B),
                "nsentences": len(samples), "ntokens": float(len(samples))}


class RankingDataset:
    """Rows of N candidates and the gold one's index (the last field)."""

    def __init__(self, path, dictionary: Dictionary, max_len: int = 128):
        self.dictionary = dictionary
        self.rows: List[List[np.ndarray]] = []
        self.gold: List[int] = []
        for line in Path(path).read_text(encoding="utf-8").strip().split("\n"):
            *cands, gold = line.split("\t")
            self.rows.append([dictionary.encode_line(c, append_eos=True)[:max_len]
                              for c in cands])
            self.gold.append(int(gold))
        self.n_cand = len(self.rows[0])
        if any(len(r) != self.n_cand for r in self.rows):
            raise ValueError(f"{path}: every row needs {self.n_cand} candidates")
        self.n_frames = np.asarray([max(len(c) for c in r) for r in self.rows], np.int64)

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i: int) -> Dict[str, Any]:
        return {"id": i, "cands": self.rows[i], "gold": self.gold[i]}

    def ordered_indices(self, shuffle: bool = True, seed: int = 1, epoch: int = 1):
        return _seeded_order(len(self), shuffle, seed, epoch)

    def collater(self, samples, frame_buckets=None, token_buckets=None, batch_multiple: int = 1,
                 pad_id: int = 1, **kw) -> Dict[str, Any]:
        B = round_up(len(samples), batch_multiple)
        L = max(len(c) for s in samples for c in s["cands"])
        toks = np.full((B, self.n_cand, L), pad_id, np.int32)
        gold = np.zeros((B,), np.int32)
        valid = np.zeros((B,), np.float32)
        for i, s in enumerate(samples):
            for n, c in enumerate(s["cands"]):
                toks[i, n, :len(c)] = c
            gold[i], valid[i] = s["gold"], 1.0
        return {"cand_tokens": toks, "labels": gold, "row_valid": valid, "ids": _ids(samples, B),
                "nsentences": len(samples), "ntokens": float(len(samples))}


def _row_ce(scores: torch.Tensor, batch: Dict[str, Any]):
    """Cross-entropy of each row's label over ``scores`` (B, C), summed over the
    valid rows, with the sample size (valid rows, at least 1) and the logs."""
    labels, valid = batch["labels"].long(), batch["row_valid"].float()
    lp = torch.log_softmax(scores.float(), dim=-1)
    loss = (-lp.gather(-1, labels[:, None])[:, 0] * valid).sum()
    size = torch.clamp(valid.sum(), min=1.0)
    correct = ((scores.argmax(dim=-1) == labels).float() * valid).sum()
    return loss, size, {"loss": loss, "nll_loss": loss, "ntokens": size, "nsentences": size,
                        "n_correct": correct, "total": size}


class SentencePredictionCriterion:
    @dataclass
    class Config:
        pad_id: int = 1

    def __init__(self, cfg: "SentencePredictionCriterion.Config"):
        self.cfg = cfg

    def __call__(self, model_out: Dict[str, Any], batch: Dict[str, Any]):
        return _row_ce(model_out["cls_logits"], batch)


class SentenceRankingCriterion:
    """The gold candidate's cross-entropy over the (B, N) ``rank_scores``."""

    @dataclass
    class Config:
        pad_id: int = 1

    def __init__(self, cfg: "SentenceRankingCriterion.Config"):
        self.cfg = cfg

    def __call__(self, model_out: Dict[str, Any], batch: Dict[str, Any]):
        return _row_ce(model_out["rank_scores"], batch)


class _RobertaHeadTask(Task):
    default_criterion = ""

    def __init__(self, cfg: TrainConfig, dictionary: Dictionary):
        super().__init__(cfg)
        self.dictionary = self.tgt_dict = dictionary

    def num_classes(self) -> int:
        raise NotImplementedError

    def build_model(self, device="cuda", seed: Optional[int] = None, for_training: bool = False):
        from s2t_tpu_torch.models.build import build_model

        return build_model(
            self.cfg.arch or "roberta_base", self.cfg.model, device=device,
            seed=self.cfg.common.seed if seed is None else seed, for_training=for_training,
            vocab_size=len(self.dictionary), num_classes=self.num_classes(),
            max_positions=self.cfg.dataset.max_target_positions or 512)

    def build_criterion(self):
        from s2t_tpu_torch.criterions.build import build_criterion

        return build_criterion(self.cfg.criterion or self.default_criterion,
                               self.cfg.criterion_cfg)

    def build_generator(self, model, gen_cfg=None):
        raise NotImplementedError(f"{type(self).__name__} has no generator")

    def decode_tokens(self, tokens) -> str:
        return self.dictionary.string(tokens)


@register_task("sentence_prediction")
class SentencePredictionTask(_RobertaHeadTask):
    default_criterion = "sentence_prediction"

    def __init__(self, cfg: TrainConfig, dictionary: Dictionary, labels: List[str]):
        super().__init__(cfg, dictionary)
        self.labels = labels

    @classmethod
    def setup(cls, cfg: TrainConfig) -> "SentencePredictionTask":
        root = Path(cfg.dataset.data)
        labels = (root / "labels.txt").read_text().split()
        return cls(cfg, Dictionary.load(root / "dict.txt"), labels)

    def num_classes(self) -> int:
        return len(self.labels)

    def load_dataset(self, split: str, is_train: bool = False):
        ds = SentenceDataset(Path(self.cfg.dataset.data) / f"{split}.tsv", self.dictionary,
                             self.labels, max_len=self.cfg.dataset.max_target_positions or 128)
        self.datasets[split] = ds
        return ds

    def forward_fn(self):
        def fwd(model, batch: Dict[str, Any], train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
            return model(batch["tokens"].long(), train=train, generator=generator,
                         classification=True)

        return fwd


@register_task("sentence_ranking")
class SentenceRankingTask(_RobertaHeadTask):
    default_criterion = "sentence_ranking"

    @classmethod
    def setup(cls, cfg: TrainConfig) -> "SentenceRankingTask":
        return cls(cfg, Dictionary.load(Path(cfg.dataset.data) / "dict.txt"))

    def num_classes(self) -> int:
        return 1

    def load_dataset(self, split: str, is_train: bool = False):
        ds = RankingDataset(Path(self.cfg.dataset.data) / f"{split}.tsv", self.dictionary,
                            max_len=self.cfg.dataset.max_target_positions or 128)
        self.datasets[split] = ds
        return ds

    def forward_fn(self):
        def fwd(model, batch: Dict[str, Any], train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
            toks = batch["cand_tokens"].long()
            B, N, L = toks.shape
            out = model(toks.reshape(B * N, L), train=train, generator=generator,
                        classification=True)
            return {**out, "rank_scores": out["cls_logits"].reshape(B, N)}

        return fwd

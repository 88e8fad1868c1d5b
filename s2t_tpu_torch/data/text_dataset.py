"""Parallel and monolingual text with on-the-fly subword tokenisation
(counterpart of s2t_tpu/data/text_dataset.py).

``TranslationDataset`` reads ``<split>.<src>`` / ``<split>.<tgt>`` line files,
encodes each line with its tokenizer and dictionary (EOS appended) when an item
is read, and batches as the JAX dataset does: the order sorts a seeded
permutation by whitespace-token count, longest first, and the collater pads the
sources to the bucketed longest and the targets through ``collate_targets``.
Word alignments (``load_alignments``, read by ``transformer_align``) are Pharaoh
``i-j`` lines, one per sentence pair (an empty line is the one pair (-1, -1));
the collater pads them into ``alignments`` (B, P, 2) with -1.  Language tags
(mBART's ``translation_from_pretrained_bart``): ``src_lang_tag`` is appended to each
source after its EOS, ``tgt_lang_tag`` prepended to each target.

``MonolingualDataset`` is the language model's: every line (EOS appended) joins
one token stream, cut into ``block_size`` blocks; the tail is dropped, and the
stream is padded only when it holds less than one block.  Its collater shifts
each block right by one with EOS in front (``prev_tokens``), and its dummy rows
are all pad.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from s2t_tpu_torch.data.batching import bucketize, collate_targets, round_up
from s2t_tpu_torch.data.dictionary import Dictionary


class TranslationDataset:
    def __init__(self, src_path, tgt_path, src_dict: Dictionary, tgt_dict: Dictionary,
                 src_bpe=None, tgt_bpe=None, align_path=None, tgt_lang_tag: Optional[int] = None,
                 src_lang_tag: Optional[int] = None):
        self.src_dict, self.tgt_dict = src_dict, tgt_dict
        self.src_bpe, self.tgt_bpe = src_bpe, tgt_bpe
        self.tgt_lang_tag, self.src_lang_tag = tgt_lang_tag, src_lang_tag
        with open(src_path, encoding="utf-8") as f:
            self.src_lines = [line.rstrip("\n") for line in f]
        self.tgt_lines = None
        if tgt_path is not None and Path(tgt_path).exists():
            with open(tgt_path, encoding="utf-8") as f:
                self.tgt_lines = [line.rstrip("\n") for line in f]
            if len(self.tgt_lines) != len(self.src_lines):
                raise ValueError(f"{tgt_path} has {len(self.tgt_lines)} lines, {src_path} "
                                 f"{len(self.src_lines)}")
        self.alignments = None
        if align_path is not None and Path(align_path).exists():
            # token positions: alignment training assumes whitespace-token inputs
            with open(align_path, encoding="utf-8") as f:
                self.alignments = [
                    np.asarray([tuple(int(x) for x in p.split("-")) for p in line.split()]
                               or [(-1, -1)], dtype=np.int32) for line in f]
            if len(self.alignments) != len(self.src_lines):
                raise ValueError(f"{align_path} has {len(self.alignments)} lines, {src_path} "
                                 f"{len(self.src_lines)}")
        # whitespace tokens + 2 size the batches; subword lengths come per item
        self.n_frames = np.asarray([len(line.split()) + 2 for line in self.src_lines],
                                   dtype=np.int64)

    def __len__(self):
        return len(self.src_lines)

    @staticmethod
    def _encode(line: str, bpe, dic: Dictionary) -> np.ndarray:
        if bpe is not None:
            line = bpe.encode_line(line)
        return dic.encode_line(line, append_eos=True)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        src = self._encode(self.src_lines[index], self.src_bpe, self.src_dict)
        if self.src_lang_tag is not None:
            src = np.concatenate([src, [self.src_lang_tag]]).astype(src.dtype)
        item = {"id": index, "source": src}
        if self.tgt_lines is not None:
            tgt = self._encode(self.tgt_lines[index], self.tgt_bpe, self.tgt_dict)
            if self.tgt_lang_tag is not None:
                tgt = np.concatenate([[self.tgt_lang_tag], tgt]).astype(tgt.dtype)
            item["target"] = tgt
        if self.alignments is not None:
            item["alignment"] = self.alignments[index]
        return item

    def ordered_indices(self, shuffle: bool = True, seed: int = 1, epoch: int = 1):
        perm = (np.random.default_rng(seed + epoch).permutation(len(self)) if shuffle
                else np.arange(len(self)))
        return perm[np.argsort(self.n_frames[perm], kind="stable")[::-1]]

    def collater(self, samples: List[Dict[str, Any]], frame_buckets=None, token_buckets=None,
                 batch_multiple: int = 1, pad_id: int = 1, eos_id: int = 2) -> Dict[str, Any]:
        B_real = len(samples)
        B = round_up(B_real, batch_multiple)
        max_S = max(len(s["source"]) for s in samples)
        if frame_buckets is not None:
            max_S = int(bucketize(np.asarray([max_S]), frame_buckets)[0])
        src = np.full((B, max_S), pad_id, dtype=np.int32)
        src_lengths = np.zeros((B,), dtype=np.int32)
        for i, s in enumerate(samples):
            t = s["source"][:max_S]
            src[i, :len(t)] = t
            src_lengths[i] = len(t)
        batch = {"src_tokens": src, "src_lengths": src_lengths,
                 "ids": np.asarray([s["id"] for s in samples] + [-1] * (B - B_real)),
                 "nsentences": B_real}
        if "target" in samples[0]:
            max_U = max(len(s["target"]) for s in samples)
            if token_buckets is not None:
                max_U = int(bucketize(np.asarray([max_U]), token_buckets)[0])
            target, prev, tgt_lengths = collate_targets([s["target"] for s in samples], B,
                                                        max_U, pad_id, eos_id)
            batch.update(target=target, prev_tokens=prev, target_lengths=tgt_lengths,
                         ntokens=float(tgt_lengths.sum()))
        if "alignment" in samples[0]:
            aligns = np.full((B, max(len(s["alignment"]) for s in samples), 2), -1, np.int32)
            for i, s in enumerate(samples):
                aligns[i, :len(s["alignment"])] = s["alignment"]
            batch["alignments"] = aligns
        return batch


class MonolingualDataset:
    """Token-stream LM dataset: lines -> blocks of ``block_size`` tokens
    (s2t_tpu/data/text_dataset.py:153-215)."""

    def __init__(self, path, dictionary: Dictionary, bpe=None, block_size: int = 128):
        self.dictionary = dictionary
        ids: List[np.ndarray] = []
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if bpe is not None:
                    line = bpe.encode_line(line)
                ids.append(dictionary.encode_line(line, append_eos=True))
        stream = np.concatenate(ids) if ids else np.zeros((0,), np.int32)
        n_blocks = max(len(stream) // block_size, 1)
        stream = stream[:n_blocks * block_size]
        if len(stream) < n_blocks * block_size:
            stream = np.pad(stream, (0, n_blocks * block_size - len(stream)),
                            constant_values=dictionary.pad())
        self.blocks = stream.reshape(n_blocks, block_size).astype(np.int32)
        self.n_frames = np.full(n_blocks, block_size, dtype=np.int64)

    def __len__(self):
        return len(self.blocks)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        return {"id": index, "tokens": self.blocks[index]}

    def ordered_indices(self, shuffle: bool = True, seed: int = 1, epoch: int = 1):
        if shuffle:
            return np.random.default_rng(seed + epoch).permutation(len(self))
        return np.arange(len(self))

    def collater(self, samples: List[Dict[str, Any]], frame_buckets=None, token_buckets=None,
                 batch_multiple: int = 1, pad_id: int = 1, eos_id: int = 2) -> Dict[str, Any]:
        B_real = len(samples)
        B = round_up(B_real, batch_multiple)
        L = samples[0]["tokens"].shape[0]
        tokens = np.full((B, L), pad_id, dtype=np.int32)
        for i, s in enumerate(samples):
            tokens[i] = s["tokens"]
        prev = np.roll(tokens, 1, axis=1)
        prev[:, 0] = eos_id
        prev[B_real:] = pad_id  # dummy rows are all pad
        return {"prev_tokens": prev, "target": tokens,
                "target_lengths": np.asarray([L] * B_real + [0] * (B - B_real), dtype=np.int32),
                "ntokens": float(L * B_real),
                "ids": np.asarray([s["id"] for s in samples] + [-1] * (B - B_real)),
                "nsentences": B_real}

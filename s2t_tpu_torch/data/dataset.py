"""SpeechToTextDataset: TSV manifests, zip/npy features or wavs, bucketed
collation (counterpart of s2t_tpu/data/dataset.py:30-283).

The per-dataset ``S2TDataConfig`` (``from_yaml`` imports PyYAML inside the
call, so a config can also be built in Python), TSV columns
id/audio/n_frames/tgt_text[/src_text/speaker/tgt_lang/aligned_tgt_text/
src_text<k>], zip ``path:offset:length`` reads, tokenised targets with
EOS-shifted prev_tokens and transcripts for CTC.  The collater pads every
batch to bucketed (T, U) shapes and a batch-size multiple; the extra rows are
zero-length dummies.  With ``use_audio_input`` the features are (N,)
int16-scale waveforms and ``n_frames`` counts samples.
"""

from __future__ import annotations

import csv
import io
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from s2t_tpu_torch.data.batching import (
    bucketize, collate_targets, make_buckets, round_up,
)
from s2t_tpu_torch.data.dictionary import Dictionary
from s2t_tpu_torch.data.tokenizer import build_tokenizer


@dataclass
class S2TDataConfig:
    """Per-dataset config.yaml (reference: speech_to_text_dataset.py:30-180)."""

    vocab_filename: str = "dict.txt"
    src_vocab_filename: Optional[str] = None
    bpe_tokenizer: Optional[dict] = None
    src_bpe_tokenizer: Optional[dict] = None
    prepend_tgt_lang_tag: bool = False
    input_feat_per_channel: int = 80
    input_channels: int = 1
    sampling_alpha: float = 1.0
    use_audio_input: bool = False
    audio_root: str = ""
    transforms: Optional[dict] = None  # {"_train": [...], "_eval": [...], ...}
    global_cmvn_stats_npz: Optional[str] = None

    @classmethod
    def from_yaml(cls, path: str | Path) -> "S2TDataConfig":
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        known = {k for k in cls.__dataclass_fields__}
        kwargs = {k: v for k, v in raw.items() if k in known}
        other = {k: v for k, v in raw.items() if k not in known}
        cfg = cls(**kwargs)
        cfg._extra = other  # keep unknown keys accessible
        return cfg

    def get_transforms(self, split: str, is_train: bool) -> dict:
        """Per-split transform config: ``transforms["_train"]`` or
        ``["_eval"]`` (``"*"`` for both), each {"transforms": [names], name:
        {options}}."""
        if not self.transforms:
            return {}
        key = "_train" if is_train else "_eval"
        d = self.transforms.get(key, self.transforms.get("*", None))
        return d or {}


def read_zip_or_file(path_spec: str, root: str = "") -> bytes:
    """Read raw bytes from ``file``, or ``archive.zip:offset:length``
    (reference: speech_to_text_dataset.py:193-264 zip random access)."""
    parts = path_spec.rsplit(":", 2)
    if len(parts) == 3 and parts[1].isdigit() and parts[2].isdigit():
        zip_path, offset, length = parts[0], int(parts[1]), int(parts[2])
        with open(Path(root) / zip_path, "rb") as f:
            f.seek(offset)
            return f.read(length)
    with open(Path(root) / path_spec, "rb") as f:
        return f.read()


def load_features(path_spec: str, root: str = "") -> np.ndarray:
    data = read_zip_or_file(path_spec, root)
    return np.load(io.BytesIO(data), allow_pickle=False)


def load_waveform(path_spec: str, root: str = "") -> np.ndarray:
    """16-bit PCM WAV (or a saved .npy waveform) as float32 in int16 scale;
    multi-channel audio is averaged to mono."""
    data = read_zip_or_file(path_spec, root)
    if path_spec.split(":")[0].endswith(".npy"):
        return np.load(io.BytesIO(data), allow_pickle=False).astype(np.float32)
    import wave

    with wave.open(io.BytesIO(data)) as w:
        n = w.getnframes()
        raw = w.readframes(n)
        arr = np.frombuffer(raw, dtype=np.int16).astype(np.float32)
        if w.getnchannels() > 1:
            arr = arr.reshape(-1, w.getnchannels()).mean(axis=1)
    return arr


class SpeechToTextDataset:
    """TSV-manifest dataset (reference: SpeechToTextDataset :288)."""

    COLUMNS = ("id", "audio", "n_frames", "tgt_text", "src_text", "speaker")

    def __init__(
        self,
        manifest_path: str | Path,
        data_cfg: S2TDataConfig,
        tgt_dict: Dictionary,
        src_dict: Optional[Dictionary] = None,
        is_train: bool = False,
        root: Optional[str] = None,
    ):
        self.cfg = data_cfg
        self.tgt_dict = tgt_dict
        self.src_dict = src_dict or tgt_dict
        self.is_train = is_train
        self.root = root if root is not None else str(Path(manifest_path).parent)
        self.bpe = build_tokenizer(data_cfg.bpe_tokenizer)
        self.src_bpe = build_tokenizer(data_cfg.src_bpe_tokenizer) or self.bpe

        self.ids: List[str] = []
        self.audio_paths: List[str] = []
        self.n_frames: List[int] = []
        self.tgt_texts: List[Optional[str]] = []
        self.src_texts: List[Optional[str]] = []
        # optional extra columns: "aligned_tgt_text" (AXCTC; reference:
        # aligned_speech_to_text_dataset.py) and "src_text0..k" multi-level
        # transcripts (MLO; reference: mlo_speech_to_text_dataset.py)
        self.aligned_tgt_texts: List[Optional[str]] = []
        self.mlo_texts: Dict[int, List[Optional[str]]] = {}
        with open(manifest_path, newline="", encoding="utf-8") as f:
            reader = csv.DictReader(f, delimiter="\t", quoting=csv.QUOTE_NONE)
            mlo_cols = sorted(
                int(c[len("src_text"):]) for c in (reader.fieldnames or [])
                if c.startswith("src_text") and c[len("src_text"):].isdigit()
            )
            self.mlo_texts = {k: [] for k in mlo_cols}
            self.tgt_langs: List[Optional[str]] = []
            for row in reader:
                self.ids.append(row["id"])
                self.audio_paths.append(row["audio"])
                self.n_frames.append(int(row["n_frames"]))
                self.tgt_texts.append(row.get("tgt_text"))
                self.src_texts.append(row.get("src_text"))
                self.aligned_tgt_texts.append(row.get("aligned_tgt_text"))
                self.tgt_langs.append(row.get("tgt_lang"))
                for k in mlo_cols:
                    self.mlo_texts[k].append(row.get(f"src_text{k}"))
        self.n_frames = np.asarray(self.n_frames, dtype=np.int64)
        # per-level dictionaries for MLO (config: src_vocab_filename_<k>);
        # default to the main source dictionary
        self.mlo_dicts: Dict[int, Dictionary] = {}
        extra = getattr(data_cfg, "_extra", {}) or {}
        for k in self.mlo_texts:
            fn = extra.get(f"src_vocab_filename_{k}")
            self.mlo_dicts[k] = (
                Dictionary.load(Path(self.root) / fn) if fn else self.src_dict
            )

    def __len__(self):
        return len(self.ids)

    def _encode_text(self, text: str, bpe, dic: Dictionary) -> np.ndarray:
        if bpe is not None:
            text = bpe.encode_line(text)
        return dic.encode_line(text, append_eos=True)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        if self.cfg.use_audio_input:
            feats = load_waveform(self.audio_paths[index], self.root)
        else:
            feats = load_features(self.audio_paths[index], self.root).astype(np.float32)
        item = {"id": index, "features": feats, "n_frames": feats.shape[0]}
        if self.tgt_texts[index] is not None:
            tgt = self._encode_text(self.tgt_texts[index], self.bpe, self.tgt_dict)
            if self.cfg.prepend_tgt_lang_tag and self.tgt_langs[index]:
                # multilingual: <lang:xx> tag leads the target (reference:
                # speech_to_text_dataset.py LANG_TAG_TEMPLATE + :373-378)
                tag = self.tgt_dict.index(f"<lang:{self.tgt_langs[index]}>")
                if tag == self.tgt_dict.unk():
                    raise ValueError(
                        "dictionary is missing the language tag "
                        f"<lang:{self.tgt_langs[index]}> required by "
                        "prepend_tgt_lang_tag"
                    )
                tgt = np.concatenate([[tag], tgt]).astype(tgt.dtype)
            item["target"] = tgt
        if self.src_texts[index] is not None:
            # transcript for CTC: no EOS (reference: criterions/ctc.py:365)
            t = self._encode_text(self.src_texts[index], self.src_bpe, self.src_dict)
            item["transcript"] = t[:-1]
        if self.aligned_tgt_texts[index] is not None:
            item["aligned_target"] = self._encode_text(
                self.aligned_tgt_texts[index], self.bpe, self.tgt_dict
            )
        for k, texts in self.mlo_texts.items():
            if texts[index] is not None:
                t = self._encode_text(texts[index], self.src_bpe, self.mlo_dicts[k])
                item[f"transcript{k}"] = t[:-1]
        return item

    # ----------------------------------------------------------------------- #
    def ordered_indices(self, shuffle: bool = True, seed: int = 1, epoch: int = 1):
        """Length-sorted indices with shuffled tie-break (reference:
        SpeechToTextDataset.ordered_indices — random within same length)."""
        if shuffle:
            rng = np.random.default_rng(seed + epoch)
            perm = rng.permutation(len(self))
        else:
            perm = np.arange(len(self))
        order = np.argsort(self.n_frames[perm], kind="stable")[::-1]
        return perm[order]

    def collater(
        self,
        samples: List[Dict[str, Any]],
        frame_buckets: Optional[np.ndarray] = None,
        token_buckets: Optional[np.ndarray] = None,
        batch_multiple: int = 1,
        pad_id: int = 1,
        eos_id: int = 2,
    ) -> Dict[str, Any]:
        """Pad to bucketed shapes; build EOS-shifted prev_tokens
        (reference: speech_to_text_dataset.py:411-486)."""
        B_real = len(samples)
        B = round_up(B_real, batch_multiple)
        max_T = max(s["features"].shape[0] for s in samples)
        if frame_buckets is not None:
            max_T = int(bucketize(np.asarray([max_T]), frame_buckets)[0])
        D = samples[0]["features"].shape[1] if samples[0]["features"].ndim > 1 else 1
        feat_shape = (B, max_T, D) if samples[0]["features"].ndim > 1 else (B, max_T)
        feats = np.zeros(feat_shape, dtype=np.float32)
        feat_lengths = np.zeros((B,), dtype=np.int32)
        for i, s in enumerate(samples):
            T = min(s["features"].shape[0], max_T)
            feats[i, :T] = s["features"][:T]
            feat_lengths[i] = T
        batch = {
            "features": feats,
            "feat_lengths": feat_lengths,
            "ids": np.asarray(
                [s["id"] for s in samples] + [-1] * (B - B_real), dtype=np.int64
            ),
            "nsentences": B_real,
        }
        if "target" in samples[0]:
            max_U = max(len(s["target"]) for s in samples)
            if token_buckets is not None:
                max_U = int(bucketize(np.asarray([max_U]), token_buckets)[0])
            target, prev, tgt_lengths = collate_targets(
                [s["target"] for s in samples], B, max_U, pad_id, eos_id
            )
            batch.update(
                target=target,
                prev_tokens=prev,
                target_lengths=tgt_lengths,
                ntokens=float(tgt_lengths.sum()),
            )
        def collate_tokens(key: str, out_key: str):
            max_S = max(len(s[key]) for s in samples)
            if token_buckets is not None:
                max_S = int(bucketize(np.asarray([max_S]), token_buckets)[0])
            arr = np.full((B, max_S), pad_id, dtype=np.int32)
            lens = np.zeros((B,), dtype=np.int32)
            for i, s in enumerate(samples):
                t = s[key][:max_S]
                arr[i, : len(t)] = t
                lens[i] = len(t)
            batch[out_key] = arr
            batch[f"{out_key}_lengths"] = lens

        if "transcript" in samples[0]:
            collate_tokens("transcript", "transcript")
        if "aligned_target" in samples[0]:
            collate_tokens("aligned_target", "aligned_target")
        for key in samples[0]:
            if key.startswith("transcript") and key != "transcript" and \
                    key != "transcript_lengths":
                collate_tokens(key, key)
        return batch

"""Memory-mapped binarised token datasets in fairseq's ``.idx`` / ``.bin`` format
(counterpart of s2t_tpu/data/indexed_dataset.py; numpy only, the port's own copy).

The on-disk format that fairseq-preprocess writes, so binarised corpora load
here unchanged, and files written here load there.

Layout (MMapIndexedDataset.Index):
  magic  b"MMIDIDX\\x00\\x00"
  version u64 = 1
  dtype   u8 code (1..8 — numpy dtypes, 8 = uint16/4 = int32/7 = int64 ...)
  count   u64
  sizes   count x int32
  pointers count x int64 (byte offsets into .bin)
``.bin`` is the concatenated token arrays.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import List

import numpy as np

_MAGIC = b"MMIDIDX\x00\x00"
# must match the reference's _code_to_dtype byte-for-byte
# (fairseq/data/indexed_dataset.py:106-117): 6 is float32, 7 is float64
_DTYPES = {
    1: np.uint8, 2: np.int8, 3: np.int16, 4: np.int32,
    5: np.int64, 6: np.float32, 7: np.float64, 8: np.uint16,
    9: np.uint32, 10: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


class MMapIndexedDataset:
    """Random-access reader over the mmap'ed .bin with a loaded index."""

    def __init__(self, path_prefix: str | Path):
        p = str(path_prefix)
        with open(p + ".idx", "rb") as f:
            magic = f.read(9)
            assert magic == _MAGIC, f"bad index magic in {p}.idx"
            (version,) = struct.unpack("<Q", f.read(8))
            assert version == 1, version
            (code,) = struct.unpack("<B", f.read(1))
            self.dtype = np.dtype(_DTYPES[code])
            (count,) = struct.unpack("<Q", f.read(8))
            self.sizes = np.frombuffer(f.read(count * 4), dtype=np.int32)
            self.pointers = np.frombuffer(f.read(count * 8), dtype=np.int64)
        self._bin = np.memmap(p + ".bin", dtype=self.dtype, mode="r")
        self.itemsize = self.dtype.itemsize

    def __len__(self):
        return len(self.sizes)

    def __getitem__(self, i: int) -> np.ndarray:
        start = self.pointers[i] // self.itemsize
        return np.asarray(self._bin[start : start + self.sizes[i]])

    @property
    def n_frames(self) -> np.ndarray:  # batching protocol
        return self.sizes.astype(np.int64)


class MMapIndexedDatasetBuilder:
    """Streaming writer producing the same files fairseq-preprocess does."""

    def __init__(self, path_prefix: str | Path, dtype=np.int32):
        self.prefix = str(path_prefix)
        self.dtype = np.dtype(dtype)
        self._bin = open(self.prefix + ".bin", "wb")
        self.sizes: List[int] = []
        self.pointers: List[int] = []
        self._offset = 0

    def add_item(self, tokens) -> None:
        arr = np.asarray(tokens, dtype=self.dtype)
        self.pointers.append(self._offset)
        self.sizes.append(len(arr))
        self._bin.write(arr.tobytes(order="C"))
        self._offset += arr.nbytes

    def finalize(self) -> None:
        self._bin.close()
        with open(self.prefix + ".idx", "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<Q", 1))
            f.write(struct.pack("<B", _DTYPE_CODES[self.dtype]))
            f.write(struct.pack("<Q", len(self.sizes)))
            f.write(np.asarray(self.sizes, np.int32).tobytes())
            f.write(np.asarray(self.pointers, np.int64).tobytes())


class BinarizedTranslationDataset:
    """Parallel bitext over two mmap datasets (the fairseq-preprocess output
    pair), same item protocol as TranslationDataset."""

    def __init__(self, src_prefix, tgt_prefix=None):
        self.src = MMapIndexedDataset(src_prefix)
        self.tgt = MMapIndexedDataset(tgt_prefix) if tgt_prefix else None
        if self.tgt is not None:
            assert len(self.src) == len(self.tgt)
        self.n_frames = self.src.sizes.astype(np.int64)

    def __len__(self):
        return len(self.src)

    def __getitem__(self, index: int):
        item = {"id": index, "source": self.src[index].astype(np.int64)}
        if self.tgt is not None:
            item["target"] = self.tgt[index].astype(np.int64)
        return item

    def ordered_indices(self, shuffle=True, seed=1, epoch=1):
        if shuffle:
            rng = np.random.default_rng(seed + epoch)
            perm = rng.permutation(len(self))
        else:
            perm = np.arange(len(self))
        return perm[np.argsort(self.n_frames[perm], kind="stable")[::-1]]

    def collater(self, samples, **kw):
        from s2t_tpu_torch.data.text_dataset import TranslationDataset

        return TranslationDataset.collater(self, samples, **kw)

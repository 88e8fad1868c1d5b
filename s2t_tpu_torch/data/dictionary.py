"""Symbol dictionary: token <-> id mapping with the fairseq file format
(counterpart of s2t_tpu/data/dictionary.py, all of it).

  - specials ``<s>`` (bos=0), ``<pad>`` (pad=1), ``</s>`` (eos=2), ``<unk>`` (unk=3)
  - plain-text dict files: one ``token count`` pair per line, loadable/saveable
  - ``encode_line`` / ``string`` round trip with post-processing
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterable, List, Optional

import numpy as np


class Dictionary:
    def __init__(
        self,
        bos: str = "<s>",
        pad: str = "<pad>",
        eos: str = "</s>",
        unk: str = "<unk>",
        extra_special_symbols: Optional[Iterable[str]] = None,
    ):
        self.bos_word, self.pad_word, self.eos_word, self.unk_word = bos, pad, eos, unk
        self.symbols: List[str] = []
        self.count: List[int] = []
        self.indices: Dict[str, int] = {}
        self.bos_index = self.add_symbol(bos)
        self.pad_index = self.add_symbol(pad)
        self.eos_index = self.add_symbol(eos)
        self.unk_index = self.add_symbol(unk)
        for s in extra_special_symbols or []:
            self.add_symbol(s)
        self.nspecial = len(self.symbols)

    # -- container protocol -------------------------------------------------
    def __len__(self) -> int:
        return len(self.symbols)

    def __getitem__(self, idx: int) -> str:
        if 0 <= idx < len(self.symbols):
            return self.symbols[idx]
        return self.unk_word

    def __contains__(self, sym: str) -> bool:
        return sym in self.indices

    def __eq__(self, other) -> bool:
        return isinstance(other, Dictionary) and self.indices == other.indices

    def index(self, sym: str) -> int:
        return self.indices.get(sym, self.unk_index)

    # -- specials ------------------------------------------------------------
    def bos(self) -> int:
        return self.bos_index

    def pad(self) -> int:
        return self.pad_index

    def eos(self) -> int:
        return self.eos_index

    def unk(self) -> int:
        return self.unk_index

    # -- construction ----------------------------------------------------------
    def add_symbol(self, word: str, n: int = 1, overwrite: bool = False) -> int:
        if word in self.indices and not overwrite:
            idx = self.indices[word]
            self.count[idx] += n
            return idx
        idx = len(self.symbols)
        self.indices[word] = idx
        self.symbols.append(word)
        self.count.append(n)
        return idx

    @classmethod
    def load(cls, f: str | Path) -> "Dictionary":
        """Load from a fairseq-format dict file: ``symbol count`` per line."""
        d = cls()
        with open(f, encoding="utf-8") as fh:
            for line in fh:
                line = line.rstrip("\n")
                if not line:
                    continue
                try:
                    word, cnt = line.rsplit(" ", 1)
                    cnt = int(cnt)
                except ValueError:
                    word, cnt = line, 1
                d.add_symbol(word, n=cnt, overwrite=False)
        return d

    def save(self, f: str | Path) -> None:
        with open(f, "w", encoding="utf-8") as fh:
            for sym, cnt in zip(
                self.symbols[self.nspecial :], self.count[self.nspecial :]
            ):
                fh.write(f"{sym} {cnt}\n")

    # -- encoding --------------------------------------------------------------
    def encode_line(
        self,
        line: str,
        append_eos: bool = True,
        add_if_not_exist: bool = False,
    ) -> np.ndarray:
        words = line.split()
        ids = []
        for w in words:
            if add_if_not_exist:
                ids.append(self.add_symbol(w))
            else:
                ids.append(self.index(w))
        if append_eos:
            ids.append(self.eos_index)
        return np.asarray(ids, dtype=np.int32)

    def string(
        self,
        tensor,
        bpe_symbol: Optional[str] = None,
        escape_unk: bool = False,
        extra_symbols_to_ignore: Optional[set] = None,
        include_eos: bool = False,
    ) -> str:
        """ids -> space-joined token string, skipping pad/eos/bos.

        ``bpe_symbol='sentencepiece'`` collapses SPM pieces (reference:
        fairseq/utils.py post_process)."""
        ignore = {self.pad_index, self.bos_index}
        if not include_eos:
            ignore.add(self.eos_index)
        if extra_symbols_to_ignore:
            ignore |= set(extra_symbols_to_ignore)
        toks = [self[int(i)] for i in np.asarray(tensor).reshape(-1) if int(i) not in ignore]
        sent = " ".join(toks)
        return post_process(sent, bpe_symbol)


def post_process(sentence: str, symbol: Optional[str]) -> str:
    """Detokenisation post-processing (reference: fairseq/utils.py post_process)."""
    if symbol is None or symbol == "none":
        return sentence
    if symbol == "sentencepiece":
        return sentence.replace(" ", "").replace("▁", " ").strip()
    if symbol == "wordpiece":
        return sentence.replace(" ", "").replace("_", " ").strip()
    if symbol == "letter":
        return sentence.replace(" ", "").replace("|", " ").strip()
    if symbol == "subword_nmt":
        symbol = "@@ "
    if symbol.endswith(" "):
        return (sentence + " ").replace(symbol, "").rstrip()
    return sentence

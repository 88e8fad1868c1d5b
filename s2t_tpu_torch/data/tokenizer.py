"""Subword tokenizers with ▁ word-boundary pieces (counterpart of
s2t_tpu/data/tokenizer.py, all of it).

The SPM-style unigram / BPE models and GPT-2 byte-level BPE come from the HF
``tokenizers`` package, imported inside the calls that need it; ``char``,
``moses``, ``byte`` and ``bert`` are pure Python.  All tokenizers emit and
consume space-separated piece strings, so ``Dictionary`` and
``post_process('sentencepiece')`` round-trip as in the JAX package.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, List, Optional

from s2t_tpu_torch.registry import TOKENIZERS, register_tokenizer


@register_tokenizer("unigram")
@register_tokenizer("spm")
class SPMTokenizer:
    """Unigram (SPM-default) subword model via HF tokenizers."""

    kind = "unigram"

    def __init__(self, model_path: Optional[str] = None, tok=None):
        if tok is not None:
            self.tok = tok
        else:
            from tokenizers import Tokenizer

            self.tok = Tokenizer.from_file(str(model_path))

    @classmethod
    def train(
        cls,
        lines: Iterable[str],
        vocab_size: int,
        model_path: str | Path,
        character_coverage: float = 1.0,
        special_tokens: Optional[List[str]] = None,
    ) -> "SPMTokenizer":
        from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

        # real SPM always has <unk> (id 0): OOV input must degrade to the
        # unk piece, never raise (Dictionary maps "<unk>" to its unk index).
        # Bites in practice when ST source text hits a target-language model.
        # dedup: a caller that already passes <unk> must not hand the HF
        # trainer a duplicated special-token list
        specials = ["<unk>"] + [
            t for t in (special_tokens or []) if t != "<unk>"
        ]
        if cls.kind == "unigram":
            tok = Tokenizer(models.Unigram())
            trainer = trainers.UnigramTrainer(
                vocab_size=vocab_size,
                special_tokens=specials,
                unk_token="<unk>",
                shrinking_factor=0.75,
            )
        else:
            tok = Tokenizer(models.BPE(unk_token="<unk>"))
            trainer = trainers.BpeTrainer(
                vocab_size=vocab_size,
                special_tokens=specials,
            )
        tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁")
        tok.decoder = decoders.Metaspace(replacement="▁")
        tok.train_from_iterator(lines, trainer)
        tok.save(str(model_path))
        return cls(tok=tok)

    def encode(self, text: str) -> List[str]:
        try:
            return self.tok.encode(text).tokens
        except Exception:
            # model saved without an unk id (pre-fix files): encode word by
            # word so only the genuinely uncoverable spans degrade to <unk>
            out: List[str] = []
            for w in text.strip().split():
                try:
                    out.extend(self.tok.encode(w).tokens)
                except Exception:
                    out.append("<unk>")
            return out

    def encode_line(self, text: str) -> str:
        return " ".join(self.encode(text))

    def decode(self, pieces: List[str] | str) -> str:
        if isinstance(pieces, str):
            pieces = pieces.split()
        # OOV pieces stay visible in detokenized output (the reference's
        # post_process("sentencepiece") keeps the unk piece; silently
        # deleting it would mask coverage problems in CLI/interactive output)
        return "".join(
            " ⁇ " if p == "<unk>" else p for p in pieces
        ).replace("▁", " ").strip()

    def vocab(self) -> List[str]:
        v = self.tok.get_vocab()
        return sorted(v, key=lambda s: v[s])


@register_tokenizer("bpe")
class BPETokenizer(SPMTokenizer):
    kind = "bpe"


@register_tokenizer("char")
class CharTokenizer:
    """Character tokenizer with ▁ word boundaries (test/fallback path)."""

    def __init__(self, model_path: Optional[str] = None):
        pass

    @classmethod
    def train(cls, lines, vocab_size=None, model_path=None, **kw):
        return cls()

    def encode(self, text: str) -> List[str]:
        return list("▁" + text.strip().replace(" ", "▁"))

    def encode_line(self, text: str) -> str:
        return " ".join(self.encode(text))

    def decode(self, pieces: List[str] | str) -> str:
        if isinstance(pieces, str):
            pieces = pieces.split()
        return "".join(pieces).replace("▁", " ").strip()


@register_tokenizer("gpt2")
class GPT2Tokenizer:
    """Byte-level BPE (reference: fairseq/data/encoders/gpt2_bpe.py) via HF
    tokenizers ByteLevel pre-tokenisation; train or load from file."""

    def __init__(self, model_path: Optional[str] = None, tok=None):
        if tok is not None:
            self.tok = tok
        else:
            from tokenizers import Tokenizer

            self.tok = Tokenizer.from_file(str(model_path))

    @classmethod
    def train(cls, lines, vocab_size, model_path, special_tokens=None, **kw):
        from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

        tok = Tokenizer(models.BPE())
        tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=True)
        tok.decoder = decoders.ByteLevel()
        trainer = trainers.BpeTrainer(
            vocab_size=vocab_size, special_tokens=special_tokens or [],
            initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
        )
        tok.train_from_iterator(lines, trainer)
        tok.save(str(model_path))
        return cls(tok=tok)

    def encode(self, text: str) -> List[str]:
        return self.tok.encode(text).tokens

    def encode_line(self, text: str) -> str:
        return " ".join(self.encode(text))

    def decode(self, pieces: List[str] | str) -> str:
        if isinstance(pieces, str):
            pieces = pieces.split()
        ids = [self.tok.token_to_id(p) for p in pieces]
        return self.tok.decode([i for i in ids if i is not None]).strip()

    def vocab(self) -> List[str]:
        v = self.tok.get_vocab()
        return sorted(v, key=lambda s: v[s])


@register_tokenizer("moses")
class MosesTokenizer:
    """Moses-style pre-tokenizer (reference: fairseq/data/encoders/
    moses_tokenizer.py via sacremoses, absent here): the core rules —
    punctuation splitting with number/abbreviation protection, aggressive
    dash handling off, escape-free output."""

    _PUNCT = r"([\.,!\?;:\(\)\[\]\{\}\"“”„…«»])"

    def __init__(self, model_path: Optional[str] = None, **kw):
        import re

        self._re_punct = re.compile(self._PUNCT)
        self._re_num = re.compile(r"(?<=\d)[\.,](?=\d)")
        self._re_multi = re.compile(r"\s+")
        self._re_apos = re.compile(r"(\w)'(\w)")

    @classmethod
    def train(cls, lines=None, **kw):
        return cls()

    def encode(self, text: str) -> List[str]:
        return self.encode_line(text).split()

    def encode_line(self, text: str) -> str:
        import re

        t = text.strip()
        # protect decimal/thousand separators inside numbers, preserving
        # WHICH separator it was ('.' vs ',')
        t = self._re_num.sub(
            lambda m: "\x00" if m.group(0) == "." else "\x01", t
        )
        t = self._re_punct.sub(r" \1 ", t)
        t = self._re_apos.sub(r"\1 '\2", t)  # l'homme -> l 'homme
        t = t.replace("\x00", ".").replace("\x01", ",")
        return self._re_multi.sub(" ", t).strip()

    def decode(self, pieces: List[str] | str) -> str:
        import re

        if isinstance(pieces, list):
            pieces = " ".join(pieces)
        out = re.sub(r" ([\.,!\?;:\)\]\}])", r"\1", pieces)
        out = re.sub(r"([\(\[\{]) ", r"\1", out)
        return out.strip()


@register_tokenizer("byte")
class ByteTokenizer:
    """Byte-level tokenization (reference: fairseq/data/encoders/bytes.py —
    UTF-8 bytes as tokens, printable-escape symbols so the vocab is plain
    text).  Vocabulary is the fixed 256 byte symbols."""

    _OFFSET = 0x2400  # map control/space bytes into the Unicode pictures block

    def __init__(self, model_path: Optional[str] = None):
        pass

    @classmethod
    def train(cls, lines=None, **kw):
        return cls()

    def _sym(self, b: int) -> str:
        ch = chr(b)
        if b <= 0x20 or b >= 0x7F:  # non-printable: escape
            return chr(self._OFFSET + b)
        return ch

    def encode(self, text: str) -> List[str]:
        return [self._sym(b) for b in text.encode("utf-8")]

    def encode_line(self, text: str) -> str:
        return " ".join(self.encode(text))

    def decode(self, pieces: List[str] | str) -> str:
        if isinstance(pieces, str):
            pieces = pieces.split()
        bs = bytearray()
        for p in pieces:
            for ch in p:
                o = ord(ch)
                bs.append(o - self._OFFSET if o >= self._OFFSET else o)
        return bs.decode("utf-8", errors="replace")

    def vocab(self) -> List[str]:
        return [self._sym(b) for b in range(256)]


@register_tokenizer("bert")
class BertWordpieceTokenizer:
    """Greedy longest-match WordPiece over a BERT-style vocab file
    (reference: fairseq/data/encoders/hf_bert_bpe.py): continuation pieces
    carry the ## prefix; unknown spans fall back to [UNK]."""

    def __init__(self, model_path: Optional[str] = None, vocab=None):
        if vocab is None:
            with open(model_path) as f:
                vocab = [l.rstrip("\n") for l in f if l.strip()]
        self._vocab = list(vocab)
        self._set = set(self._vocab)

    @classmethod
    def train(cls, lines, vocab_size=1000, model_path=None, **kw):
        """Character + frequent-substring vocab (a practical stand-in for the
        original WordPiece trainer; real BERT vocabs load via model_path)."""
        from collections import Counter

        counts = Counter()
        words = Counter()
        for line in lines:
            for w in line.strip().lower().split():
                words[w] += 1
        vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
        chars = set()
        for w in words:
            chars.add(w[0])
            chars.update("##" + c for c in w[1:])
        vocab += sorted(chars)
        for w, c in words.most_common():
            if len(vocab) >= vocab_size:
                break
            if w not in vocab:
                vocab.append(w)
        tok = cls(vocab=vocab[:vocab_size])
        if model_path:
            with open(model_path, "w") as f:
                f.write("\n".join(tok._vocab))
        return tok

    def _wordpiece(self, word: str) -> List[str]:
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while end > start:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self._set:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return ["[UNK]"]
            pieces.append(cur)
            start = end
        return pieces

    def encode(self, text: str) -> List[str]:
        out = []
        for w in text.strip().lower().split():
            out.extend(self._wordpiece(w))
        return out

    def encode_line(self, text: str) -> str:
        return " ".join(self.encode(text))

    def decode(self, pieces: List[str] | str) -> str:
        if isinstance(pieces, str):
            pieces = pieces.split()
        words: List[str] = []
        for p in pieces:
            if p in ("[CLS]", "[SEP]", "[PAD]"):
                continue
            if p.startswith("##") and words:
                words[-1] += p[2:]
            else:
                words.append(p)
        return " ".join(words)

    def vocab(self) -> List[str]:
        return list(self._vocab)


def build_tokenizer(cfg: Optional[dict]) -> Optional[object]:
    """Build from a data-config dict like {"bpe_tokenizer": {"bpe": "unigram",
    "model_path": ...}} (reference: S2TDataConfig.bpe_tokenizer)."""
    if not cfg:
        return None
    kind = cfg.get("bpe") or cfg.get("tokenizer") or "unigram"
    cls = TOKENIZERS.get(kind)
    if kind in ("char", "moses", "byte"):
        return cls()
    path = cfg.get("model_path") or cfg.get("sentencepiece_model")
    if not path:
        raise ValueError(f"tokenizer {kind!r} requires model_path")
    return cls(model_path=path)

"""Frozen copy of the WordPiece rules both configurations tokenise with.

BERT-style basic tokenisation (lowercase, split on whitespace and on every
non-word character), then greedy longest-match-first WordPiece with ``##``
continuations against a ``vocab.txt``; without a vocabulary each token is
hashed (FNV-1a 64) into the ids above 1,000. ``collapse_numbers`` maps data
figures to shape tokens before the split, as the trained checkpoint's
tokenizer does. Kept here so the reference shares no code with the program.
"""

from __future__ import annotations

import re

_PUNCT_SPLIT = re.compile(r"(\W)")
_COMMA_IN_NUMBER = re.compile(r"(?<=\d),(?=\d)")
_NUMBER = re.compile(r"\d+(?:\.\d+)?")
_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = 0xFFFFFFFFFFFFFFFF


def fnv1a64(data: bytes) -> int:
    h = _FNV_OFFSET
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h


def number_shape(tok: str) -> str:
    if "." in tok:
        return "numdec"
    if len(tok) == 4 and tok[:2] in ("19", "20"):
        return tok
    if len(tok) <= 2:
        return tok
    return f"num{min(len(tok), 9)}"


class Tokenizer:
    """Text -> ids: ``[CLS] pieces... [SEP]``, at most ``max_len`` ids."""

    def __init__(self, vocab_path: str | None = None, vocab_size: int = 30522,
                 max_len: int = 256, collapse_numbers: bool = False):
        self.vocab = None
        if vocab_path is not None:
            with open(vocab_path, encoding="utf-8") as f:
                self.vocab = {line.rstrip("\r\n"): i for i, line in enumerate(f)}
            vocab_size = max(self.vocab.values()) + 1
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.collapse_numbers = collapse_numbers
        v = self.vocab or {}
        self.unk = v.get("[UNK]", 100)
        self.cls = v.get("[CLS]", 101)
        self.sep = v.get("[SEP]", 102)

    def _words(self, text: str) -> list[str]:
        text = text.lower()
        if self.collapse_numbers:
            text = _COMMA_IN_NUMBER.sub("", text)
            text = _NUMBER.sub(lambda m: f" {number_shape(m.group(0))} ", text)
        return [f.strip() for piece in text.split() for f in _PUNCT_SPLIT.split(piece) if f.strip()]

    def _pieces(self, word: str) -> list[int]:
        if self.vocab is None:
            span = max(1, self.vocab_size - 1000)
            return [min(1000, self.vocab_size - 1) + fnv1a64(word.encode()) % span]
        if word in self.vocab:
            return [self.vocab[word]]
        out, start = [], 0
        while start < len(word):
            for end in range(len(word), start, -1):
                sub = word[start:end] if start == 0 else "##" + word[start:end]
                if sub in self.vocab:
                    out.append(self.vocab[sub])
                    start = end
                    break
            else:
                return [self.unk]
        return out

    def encode(self, text: str) -> list[int]:
        ids = [self.cls]
        for word in self._words(text):
            ids.extend(self._pieces(word))
            if len(ids) >= self.max_len - 1:
                break
        return ids[: self.max_len - 1] + [self.sep]

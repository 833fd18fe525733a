"""WordPiece tokenizer for the MiniLM encoder (host-side).

From-scratch implementation of BERT-style WordPiece (lowercase, greedy
longest-match-first with ``##`` continuations) — the tokenization the
reference gets implicitly through sentence-transformers. Loads a standard
``vocab.txt``; in zero-egress images with no vocab file a deterministic
hash-bucket fallback keeps the model runnable (ids = hash(token) into the
vocab range, skipping special ids).
"""

from __future__ import annotations

import os
import re
from typing import Optional, Sequence

import numpy as np

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = 0xFFFFFFFFFFFFFFFF


def fnv1a64(data: bytes) -> int:
    """FNV-1a 64-bit hash (the port's copy of ``ragfin_tpu.models.featurizer.fnv1a64``)."""
    h = _FNV_OFFSET
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h

PAD, UNK, CLS, SEP = "[PAD]", "[UNK]", "[CLS]", "[SEP]"
_PUNCT_SPLIT = re.compile(r"(\W)")
_COMMA_IN_NUMBER = re.compile(r"(?<=\d),(?=\d)")
_NUMBER = re.compile(r"\d+(?:\.\d+)?")


def number_shape(tok: str) -> str:
    """Collapse data-value numbers to magnitude-shape tokens, keeping scope
    numbers literal.

    Mirrors the featurizer's retrieval-token rule
    (``featurizer._is_retrieval_token``): decimal figures and long integers
    are answer payload (₹ amounts, ratios) whose exact values carry no
    retrieval signal and would explode the vocabulary; years (19xx/20xx) and
    short integers (quarter digits, small counts) are genuine retrieval keys
    and stay verbatim. Shape tokens are plain lowercase words so they
    survive the punctuation split."""
    if "." in tok:
        return "numdec"
    if len(tok) == 4 and tok[:2] in ("19", "20"):
        return tok
    if len(tok) <= 2:
        return tok
    return f"num{min(len(tok), 9)}"


class WordPieceTokenizer:
    def __init__(
        self,
        vocab: Optional[dict[str, int]] = None,
        vocab_size: int = 30522,
        max_len: int = 256,
        lowercase: bool = True,
        collapse_numbers: bool = False,
    ):
        if vocab is not None and not vocab:
            raise ValueError("empty WordPiece vocab (unreadable vocab.txt?)")
        self.vocab = vocab
        self.vocab_size = vocab_size if vocab is None else max(vocab.values()) + 1
        self.max_len = max_len
        self.lowercase = lowercase
        self.collapse_numbers = collapse_numbers
        if vocab is not None:
            self.pad_id = vocab.get(PAD, 0)
            self.unk_id = vocab.get(UNK, 100)
            self.cls_id = vocab.get(CLS, 101)
            self.sep_id = vocab.get(SEP, 102)
        else:
            self.pad_id, self.unk_id, self.cls_id, self.sep_id = 0, 100, 101, 102

    @classmethod
    def from_vocab_file(cls, path: str, **kwargs) -> "WordPieceTokenizer":
        vocab = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                # rstrip CR too: a CRLF vocab.txt would leave "\r" on every
                # token and silently map all text to [UNK].
                vocab[line.rstrip("\r\n")] = i
        return cls(vocab=vocab, **kwargs)

    @classmethod
    def find_checkpoint_vocab(cls, path: str, **kwargs) -> Optional["WordPieceTokenizer"]:
        vocab_path = os.path.join(path, "vocab.txt")
        if os.path.exists(vocab_path):
            return cls.from_vocab_file(vocab_path, **kwargs)
        return None

    # --- text → ids ------------------------------------------------------
    def _basic_tokens(self, text: str) -> list[str]:
        if self.lowercase:
            text = text.lower()
        if self.collapse_numbers:
            # Comma-grouped amounts become one number token first, then
            # every number maps to its shape BEFORE the punctuation split —
            # decimals would otherwise fragment at the '.'.
            text = _COMMA_IN_NUMBER.sub("", text)
            text = _NUMBER.sub(lambda m: f" {number_shape(m.group(0))} ", text)
        out = []
        for piece in text.split():
            for frag in _PUNCT_SPLIT.split(piece):
                frag = frag.strip()
                if frag:
                    out.append(frag)
        return out

    def _wordpiece(self, token: str) -> list[int]:
        assert self.vocab is not None
        if token in self.vocab:
            return [self.vocab[token]]
        pieces = []
        start = 0
        while start < len(token):
            end = len(token)
            piece_id = None
            while end > start:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece_id = self.vocab[sub]
                    break
                end -= 1
            if piece_id is None:
                return [self.unk_id]
            pieces.append(piece_id)
            start = end
        return pieces

    def _hash_ids(self, token: str) -> list[int]:
        # Deterministic fallback: hash into the non-special id range.
        # (Floor at 1: vocab_size <= 1000 would modulo by zero/negative and
        # emit invalid ids.)
        span = max(1, self.vocab_size - 1000)
        return [min(1000, self.vocab_size - 1) + fnv1a64(token.encode()) % span]

    def encode(self, text: str) -> list[int]:
        ids = [self.cls_id]
        for token in self._basic_tokens(text):
            ids.extend(self._wordpiece(token) if self.vocab is not None else self._hash_ids(token))
            if len(ids) >= self.max_len - 1:
                break
        ids = ids[: self.max_len - 1]
        ids.append(self.sep_id)
        return ids

    def encode_batch(
        self, texts: Sequence[str], pad_multiple: int = 16
    ) -> tuple[np.ndarray, np.ndarray]:
        """Returns (input_ids [B, S], attention_mask [B, S]) padded to a
        static-friendly multiple."""
        encoded = [self.encode(t) for t in texts]
        longest = max((len(e) for e in encoded), default=1)
        seq = max(pad_multiple, -(-longest // pad_multiple) * pad_multiple)
        ids = np.full((len(texts), seq), self.pad_id, np.int32)
        mask = np.zeros((len(texts), seq), np.int32)
        for row, e in enumerate(encoded):
            ids[row, : len(e)] = e
            mask[row, : len(e)] = 1
        return ids, mask

    def save_vocab(self, path: str) -> None:
        """Write ``vocab.txt`` (line number = id) — the format
        :meth:`from_vocab_file` reads back."""
        assert self.vocab is not None, "hash-bucket tokenizer has no vocab to save"
        inv = sorted(self.vocab.items(), key=lambda kv: kv[1])
        if [i for _, i in inv] != list(range(len(inv))):
            raise ValueError("vocab ids must be contiguous 0..n-1 to save as vocab.txt")
        with open(path, "w", encoding="utf-8") as f:
            for tok, _ in inv:
                f.write(tok + "\n")


def _learn_bpe_pieces(counts: dict[str, int], budget: int, min_pair_freq: int = 4) -> list[str]:
    """Greedy BPE merges over the word-frequency table → subword pieces.

    Words are symbol sequences (first symbol bare, rest ``##``-marked, BERT
    convention); each iteration merges the most frequent adjacent pair and
    records the merged unit as a vocabulary piece. The learned stems/affixes
    ("deposit", "##s", "seg", "##ment") are what give greedy WordPiece a
    graceful decomposition for unseen or misspelled words — with a
    whole-word-only vocabulary, "deposists" shatters into nine single-char
    pieces whose mean-pooled embedding is noise (the round-4 encoder's
    distribution-shift fragility). Deterministic: ties break lexicographic.
    """
    words: dict[tuple, int] = {}
    for w, f in counts.items():
        if len(w) > 1:
            sym = tuple([w[0]] + ["##" + c for c in w[1:]])
            words[sym] = words.get(sym, 0) + f
    pieces: list[str] = []
    while len(pieces) < budget:
        pair_counts: dict[tuple, int] = {}
        for sym, f in words.items():
            for a, b in zip(sym, sym[1:]):
                pair_counts[(a, b)] = pair_counts.get((a, b), 0) + f
        if not pair_counts:
            break
        (a, b), freq = min(
            pair_counts.items(), key=lambda kv: (-kv[1], kv[0])
        )
        if freq < min_pair_freq:
            break
        merged = a + b[2:]  # b is always a ## continuation
        pieces.append(merged)
        new_words: dict[tuple, int] = {}
        for sym, f in words.items():
            out = []
            i = 0
            while i < len(sym):
                if i + 1 < len(sym) and sym[i] == a and sym[i + 1] == b:
                    out.append(merged)
                    i += 2
                else:
                    out.append(sym[i])
                    i += 1
            t = tuple(out)
            new_words[t] = new_words.get(t, 0) + f
        words = new_words
    return pieces


def build_wordpiece_vocab(
    texts: Sequence[str],
    vocab_size: int = 8192,
    min_freq: int = 2,
    collapse_numbers: bool = True,
    lowercase: bool = True,
    subword_pieces: bool = True,
    subword_reserve: int = 1024,
) -> dict[str, int]:
    """Build a domain WordPiece vocabulary from a corpus (deterministic).

    Zero-egress images ship no pretrained vocab (SURVEY.md §7 parity note),
    so the trained encoder's vocabulary is learned from the domain corpus
    itself: all words above ``min_freq`` (most frequent first), plus full
    single-character coverage with ``##`` continuations so greedy WordPiece
    never emits [UNK] for ASCII text, plus (``subword_pieces``) BPE-learned
    stems/affixes filling the remaining budget so out-of-vocabulary and
    misspelled words decompose into meaningful units instead of single
    characters (round-5: the 607-token whole-word-only v3 vocabulary left
    7.5k of the budget unused and shattered any unseen word).
    """
    probe = WordPieceTokenizer(
        vocab=None, lowercase=lowercase, collapse_numbers=collapse_numbers
    )
    counts: dict[str, int] = {}
    chars: set[str] = set()
    for text in texts:
        for tok in probe._basic_tokens(text):
            counts[tok] = counts.get(tok, 0) + 1
            chars.update(tok)
    vocab: dict[str, int] = {}
    for special in (PAD, UNK, CLS, SEP):
        vocab[special] = len(vocab)
    # Character floor: every single char and its continuation piece.
    for ch in sorted(chars):
        for piece in (ch, "##" + ch):
            if piece not in vocab:
                vocab[piece] = len(vocab)
    # Scope-number literals the corpus may not cover densely but queries
    # use (years / quarter digits pass number_shape verbatim).
    if collapse_numbers:
        for y in range(1990, 2041):
            vocab.setdefault(str(y), len(vocab))
        for d in range(0, 100):
            vocab.setdefault(str(d), len(vocab))
        for shape in ("numdec", "num3", "num4", "num5", "num6", "num7", "num8", "num9"):
            vocab.setdefault(shape, len(vocab))
    # Whole words fill up to the budget minus a reserve for subword pieces
    # (a big extra-text corpus must not crowd out the OOV-decomposition
    # machinery); leftover reserve goes back to words afterwards.
    word_cap = vocab_size - (subword_reserve if subword_pieces else 0)
    eligible = [
        (tok, freq)
        for tok, freq in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
        if freq >= min_freq
    ]
    for tok, _ in eligible:
        if len(vocab) >= word_cap:
            break
        vocab.setdefault(tok, len(vocab))
    if subword_pieces and len(vocab) < vocab_size:
        for piece in _learn_bpe_pieces(counts, vocab_size - len(vocab)):
            if len(vocab) >= vocab_size:
                break
            vocab.setdefault(piece, len(vocab))
    for tok, _ in eligible:
        if len(vocab) >= vocab_size:
            break
        vocab.setdefault(tok, len(vocab))
    return vocab

"""Host-side text featurizer: text -> hashed n-gram feature ids + TF-IDF weights.

Copy of ``ragfin_tpu/models/featurizer.py`` (only this docstring differs).
This is the "tokenizer" stage of the weight-free lexical encoder
(:mod:`ragfin_tpu_torch.models.bag_encoder`): each text becomes a bag of
hashed word unigrams/bigrams with TF-IDF weights, which the device encoder
projects into the 384-dim embedding space via a fixed random table (a
Johnson-Lindenstrauss projection of the sparse TF-IDF vector, so cosine
similarity on the device approximates lexical TF-IDF cosine).

Numbers are first-class tokens (financial QA hinges on "10,636" matching
"₹10,636 crore"): digit-group commas are stripped and decimals kept intact.

The hash is FNV-1a 64-bit, mirrored by the native C++ batch featurizer
(``native/fasthash.cpp``, bound in :mod:`ragfin_tpu_torch.models.fasthash`)
used for large corpora.
"""

from __future__ import annotations

import math
import re
from collections import Counter
from dataclasses import dataclass, field
from typing import Iterable, Optional, Sequence

import numpy as np

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = 0xFFFFFFFFFFFFFFFF

# Digit-group commas: 10,636 → 10636 (applied before tokenization).
_COMMA_IN_NUMBER = re.compile(r"(?<=\d),(?=\d)")
# Tokens: decimal numbers kept whole, else alphabetic runs.
_TOKEN = re.compile(r"\d+(?:\.\d+)?|[a-z]+")


def fnv1a64(data: bytes) -> int:
    """FNV-1a 64-bit hash (mirrored in native/fasthash.cpp)."""
    h = _FNV_OFFSET
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h


def tokenize(text: str) -> list[str]:
    """Lowercase word/number tokens with numeric comma-groups collapsed."""
    return _TOKEN.findall(_COMMA_IN_NUMBER.sub("", text.lower()))


def _is_retrieval_token(tok: str) -> bool:
    """Data-value numbers are not retrieval keys.

    Decimal numbers (44.0, 15.22) and long integers (10636 crore) are answer
    payload: queries never quote them, and at million-chunk scale their
    near-unique feature ids saturate the hash table — every bucket aliases
    ~dozens of them, corrupting IDF and injecting large spurious cosine hits
    on random documents (measured: a colliding query bigram contributed 8x
    more score than the true 'icici' match). Short integers stay: quarter
    digits, fiscal years, and small counts are genuine retrieval keys.
    """
    if "." in tok:
        return False
    if tok[0].isdigit() and len(tok) >= 5:
        return False
    return True


def retrieval_tokens(text: str) -> list[str]:
    """Tokens used for features: tokenize() minus data-value numbers.
    Mirrored bit-for-bit by native/fasthash.cpp."""
    return [t for t in tokenize(text) if _is_retrieval_token(t)]


def features(text: str) -> list[str]:
    """Unigrams + adjacent-word bigrams ("net profit" → "net_profit")."""
    toks = retrieval_tokens(text)
    return toks + [f"{a}_{b}" for a, b in zip(toks, toks[1:])]


@dataclass
class HashedFeaturizer:
    """Maps text to (feature ids, weights) arrays for the device encoder.

    ``vocab_size`` buckets; IDF statistics are fit on the corpus at index-build
    time and reused for queries (``fit`` → ``encode_batch``). Without fitting,
    weights fall back to pure sublinear TF.
    """

    vocab_size: int = 1 << 16
    sublinear_tf: bool = True
    bigram_weight: float = 1.0
    drop_oov: bool = True
    idf: dict[int, float] = field(default_factory=dict)
    n_docs: int = 0

    def feature_ids(self, text: str) -> Counter:
        counts: Counter = Counter()
        toks = retrieval_tokens(text)
        for tok in toks:
            counts[fnv1a64(tok.encode()) % self.vocab_size] += 1.0
        if self.bigram_weight:
            for a, b in zip(toks, toks[1:]):
                counts[fnv1a64(f"{a}_{b}".encode()) % self.vocab_size] += self.bigram_weight
        return counts

    def fit(self, texts: Iterable[str], batch: int = 65536) -> "HashedFeaturizer":
        """Fit IDF statistics over a corpus (smooth idf, like sklearn).

        Uses the native batch featurizer (native/fasthash.cpp) when built —
        the host-side hot loop at million-chunk corpus scale. Runs in
        ``batch``-sized slices: a single whole-corpus native call allocates
        [N, 4096] int32 (153 GB at 10M chunks — round-5 OOM), and the
        per-row Python df loop was O(N * feats); per-batch ``np.unique``
        counts document frequency vectorized (feature ids are unique per
        row by construction — repeats fold into tf)."""
        import numpy as np

        texts = list(texts)
        df: Counter = Counter()
        for start in range(0, len(texts), batch):
            chunk = texts[start : start + batch]
            native = self._native_batch(chunk)
            if native is not None:
                ids, _tf, lens = native
                cols = np.arange(ids.shape[1])
                valid = cols[None, :] < np.asarray(lens)[:, None]
                vals, counts = np.unique(ids[valid], return_counts=True)
                for v, c in zip(vals.tolist(), counts.tolist()):
                    df[v] += c
            else:
                for text in chunk:
                    for fid in self.feature_ids(text):
                        df[fid] += 1
        n = len(texts)
        self.n_docs = n
        self.idf = {
            fid: math.log((1 + n) / (1 + d)) + 1.0 for fid, d in df.items()
        }
        self._idf_arr = None
        return self

    def _native_batch(self, texts, max_feats: int = 4096):
        from . import fasthash

        if not fasthash.available():
            return None
        # Bit-parity guards vs the Python path: the C ABI passes
        # NUL-terminated strings (an embedded NUL would truncate the text
        # natively but not in Python), and Python lowercases BEFORE the
        # [a-z]+ scan, which maps some Unicode chars to ASCII (e.g. KELVIN
        # SIGN -> 'k') that the byte-level native scanner would skip.
        # Lowercasing here makes both paths see the same bytes; NUL texts
        # fall back to Python.
        if any("\x00" in t for t in texts):
            return None
        texts = [t.lower() for t in texts]
        out = fasthash.featurize_batch(
            texts, self.vocab_size, self.bigram_weight, max_feats=max_feats
        )
        if out is not None and len(out[2]) and int(out[2].max()) >= max_feats:
            # A row saturated its capacity: the native path would silently
            # drop the overflow features and diverge from the pure-Python
            # featurizer (bit-parity contract). Double the capacity and
            # retry up to the vocab size (distinct features can't exceed it).
            if max_feats < self.vocab_size:
                return self._native_batch(texts, min(max_feats * 2, self.vocab_size))
            return None  # pathological: fall back to the Python path
        return out

    def _idf_array(self) -> np.ndarray:
        """Dense IDF lookup (0 = OOV → dropped) for vectorized weighting."""
        arr = getattr(self, "_idf_arr", None)
        if arr is None:
            arr = np.zeros((self.vocab_size,), np.float32)
            for fid, v in self.idf.items():
                arr[fid] = v
            self._idf_arr = arr
        return arr

    def weigh(self, counts: Counter) -> dict[int, float]:
        """TF-IDF weights. Corpus-unseen features are dropped once IDF is
        fitted: in exact sparse TF-IDF cosine an OOV term contributes zero to
        every document dot product, but in the random-projected space it would
        inject a max-IDF noise vector into the query embedding — dropping it
        keeps JL cosine faithful to exact TF-IDF ranking."""
        out = {}
        for fid, tf in counts.items():
            w = 1.0 + math.log(tf) if (self.sublinear_tf and tf > 0) else tf
            if self.n_docs:
                idf = self.idf.get(fid)
                if idf is None:
                    if self.drop_oov:
                        continue
                    idf = math.log(1 + self.n_docs) + 1.0
                w *= idf
            out[fid] = w
        return out

    @staticmethod
    def _canonical_order(ids: np.ndarray, wts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Sort each row's features by (id, weight), zero-weight entries last.

        Feature EMISSION order follows first-occurrence token order, which
        varies with bytes that produce no features (dropped data-value
        numbers shift hash-scan order) — so two texts with IDENTICAL feature
        multisets can present them in different permutations. Every
        downstream f32 reduction (row L2 norms in the exact-bucket scorer,
        the JL bag sum behind the device matrix) is accumulation-order
        sensitive, and a 1-ulp norm difference between figure-perturbed
        near-duplicates silently breaks the lowest-row tie-break that exact
        scoring guarantees (measured: the one residual zero-recall query at
        1M+20k scale — gold's norm landed one ulp high and lost every "tie"
        to ~200 forgeries). Canonical ordering makes equal multisets bitwise
        identical everywhere."""
        sentinel = np.where(wts != 0, ids, np.int32(np.iinfo(np.int32).max))
        order = np.lexsort((wts, sentinel))  # per-row: id asc, then weight
        return (
            np.take_along_axis(ids, order, axis=-1),
            np.take_along_axis(wts, order, axis=-1),
        )

    def encode_batch(
        self,
        texts: Sequence[str],
        pad_to: Optional[int] = None,
        pad_multiple: int = 128,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batch featurize: returns (ids [B, L] int32, weights [B, L] float32).

        L is the max feature count in the batch rounded up to ``pad_multiple``
        (static-shape friendly for jit caching); padding uses id 0 with weight
        0 so padded entries contribute nothing to the bag sum. Rows are in
        canonical (id-sorted) feature order — see :meth:`_canonical_order`.
        """
        native = self._native_batch(list(texts))
        if native is not None:
            raw_ids, raw_tf, lens = native
            max_len = max(int(lens.max()) if len(lens) else 1, 1)
            length = pad_to or max(pad_multiple, -(-max_len // pad_multiple) * pad_multiple)
            ids = np.zeros((len(texts), length), np.int32)
            tf = np.zeros((len(texts), length), np.float32)
            take = min(length, raw_ids.shape[1])
            col_mask = np.arange(take)[None, :] < lens[:, None]
            ids[:, :take] = np.where(col_mask, raw_ids[:, :take], 0)
            tf[:, :take] = np.where(col_mask, raw_tf[:, :take], 0.0)
        else:
            # Python fallback emits the SAME (ids, tf) arrays and then runs
            # the SAME vectorized weighting below — computing weights via
            # the scalar f64 path (weigh()) drifted from the native f32 np
            # pipeline by an ulp, and this codebase has already paid for a
            # 1-ulp norm difference once (see _canonical_order).
            counted = [self.feature_ids(t) for t in texts]
            max_len = max((len(c) for c in counted), default=1)
            length = pad_to or max(pad_multiple, -(-max_len // pad_multiple) * pad_multiple)
            ids = np.zeros((len(texts), length), np.int32)
            tf = np.zeros((len(texts), length), np.float32)
            for row, counts in enumerate(counted):
                for col, (fid, c) in enumerate(list(counts.items())[:length]):
                    ids[row, col] = fid
                    tf[row, col] = c
        wts = np.where(tf > 0, 1.0 + np.log(np.maximum(tf, 1e-9)), 0.0) if self.sublinear_tf else tf
        if self.n_docs:
            idf = self._idf_array()[ids]
            wts = wts * idf if self.drop_oov else wts * np.where(idf > 0, idf, math.log(1 + self.n_docs) + 1.0)
        wts = np.where(tf > 0, wts, 0.0).astype(np.float32)
        # Zero-weight slots (padding AND OOV-dropped features) carry id 0,
        # as documented — real ids in dead slots would diverge between
        # hosts with and without the native library.
        ids = np.where(wts != 0, ids, 0)
        return self._canonical_order(ids, wts)

    # --- persistence -----------------------------------------------------
    def state_dict(self) -> dict:
        return {
            "vocab_size": self.vocab_size,
            "sublinear_tf": self.sublinear_tf,
            "drop_oov": self.drop_oov,
            "bigram_weight": self.bigram_weight,
            "n_docs": self.n_docs,
            "idf_ids": list(self.idf.keys()),
            "idf_vals": list(self.idf.values()),
        }

    @classmethod
    def from_state_dict(cls, state: dict) -> "HashedFeaturizer":
        f = cls(
            vocab_size=int(state["vocab_size"]),
            sublinear_tf=bool(state["sublinear_tf"]),
            drop_oov=bool(state.get("drop_oov", True)),
            bigram_weight=float(state["bigram_weight"]),
        )
        f.n_docs = int(state["n_docs"])
        f.idf = {int(i): float(v) for i, v in zip(state["idf_ids"], state["idf_vals"])}
        return f

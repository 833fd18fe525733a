"""Unified embedder interface: text batch -> unit embeddings [B, 384].

Counterpart of ``ragfin_tpu/models/embedder.py``, with its three backends
behind one protocol (selected by ``Settings.embed_backend``):

- :class:`HashedEmbedder`: the weight-free lexical default (featurizer on
  the host, bag encoder on the device).
- :class:`MiniLMEmbedder`: the MiniLM-class transformer, WordPiece
  tokenisation, batched bf16 forward; loads a local HF checkpoint directory
  when one is given and loads, seeded random weights otherwise.
- :class:`TrainedEmbedder`: the committed in-domain encoder.

Every backend takes ``device`` (``None`` = the card, which must exist).
"""

from __future__ import annotations

import logging
from typing import Optional, Protocol, Sequence

import numpy as np
import torch

from ..config.constants import EMBED_DIM
from ..utils.device import DeviceLike, resolve_device
from ..utils.profiling import METRICS


class Embedder(Protocol):
    dim: int

    def fit(self, texts: Sequence[str]) -> "Embedder": ...

    def encode_texts(self, texts: Sequence[str]) -> np.ndarray: ...

    def state_dict(self) -> dict: ...


def row_bucket(rows: int, n_texts: int, batch_size: int) -> int:
    """Row count a batch is padded to: the full batch for a bulk encode's
    tail, else the {1, 8, 64, k*64} buckets (``TrainedEmbedder`` in the JAX
    package, where each shape is one compile)."""
    if n_texts > batch_size:
        return batch_size
    if rows <= 1:
        return 1
    if rows <= 8:
        return 8
    return min(batch_size, -(-rows // 64) * 64)


class HashedEmbedder:
    """Featurizer + bag-encoder pipeline as one object."""

    backend = "hashed"

    def __init__(self, vocab_size: int = 1 << 16, dim: int = EMBED_DIM, seed: int = 0,
                 featurizer=None, encoder=None, device: DeviceLike = None):
        from .bag_encoder import BagEncoder
        from .featurizer import HashedFeaturizer

        self.featurizer = featurizer or HashedFeaturizer(vocab_size=vocab_size)
        self.encoder = encoder or BagEncoder(
            vocab_size=vocab_size, dim=dim, seed=seed, device=device
        )
        self.device = self.encoder.device
        self.dim = dim

    def fit(self, texts: Sequence[str]) -> "HashedEmbedder":
        self.featurizer.fit(texts)
        return self

    @METRICS.spanned("encode")
    @torch.inference_mode()
    def encode_texts(self, texts: Sequence[str]) -> np.ndarray:
        with METRICS.span("encode.tokenize"):
            ids, wts = self.featurizer.encode_batch(list(texts))
        with METRICS.span("encode.forward"):
            emb = self.encoder.encode(ids, wts)
        with METRICS.span("encode.readback"):
            return emb.cpu().numpy()

    def state_dict(self) -> dict:
        return {
            "backend": self.backend,
            "featurizer": self.featurizer.state_dict(),
            "encoder": self.encoder.state_dict(),
        }

    @classmethod
    def from_state_dict(
        cls, state: dict, encoder_table=None, device: DeviceLike = None
    ) -> "HashedEmbedder":
        from .bag_encoder import BagEncoder
        from .featurizer import HashedFeaturizer

        return cls(
            featurizer=HashedFeaturizer.from_state_dict(state["featurizer"]),
            encoder=BagEncoder.from_state_dict(
                state["encoder"], table=encoder_table, device=device
            ),
        )


class MiniLMEmbedder:
    """The MiniLM forward as an embedder (batched, bf16 activations).

    A failed or partial checkpoint load (missing file, truncated weights, no
    ``vocab.txt``) falls back to seeded random weights with ``pretrained``
    False, which ``state_dict`` reports: the JAX package's documented
    contract. The random weights are drawn from a ``torch.Generator`` and
    differ from the JAX package's Flax init."""

    backend = "minilm"

    def __init__(self, checkpoint: Optional[str] = None, seed: int = 0, batch_size: int = 64,
                 max_len: int = 256, device: DeviceLike = None):
        from .minilm import MiniLMConfig, MiniLMEncoder, init_params, load_hf_weights
        from .tokenizer import WordPieceTokenizer

        self.device = resolve_device(device)
        self.config = MiniLMConfig()
        self.dim = self.config.hidden_size
        self.batch_size = batch_size
        self.checkpoint = checkpoint
        params = tokenizer = None
        if checkpoint:
            try:
                params = load_hf_weights(checkpoint, self.config)
                tokenizer = WordPieceTokenizer.find_checkpoint_vocab(checkpoint, max_len=max_len)
            except Exception as e:  # noqa: BLE001 - any load failure means random init
                logging.getLogger(__name__).warning(
                    "minilm checkpoint %r did not load (%r); seeded random weights", checkpoint, e
                )
                params = tokenizer = None
            if tokenizer is None:
                # Pretrained weights with no checkpoint vocab would pair the
                # real embedding matrix with hash-bucket token ids.
                params = None
        self.pretrained = params is not None
        self.model = MiniLMEncoder(self.config)
        self.model.load_state_dict(params if params is not None else init_params(self.config, seed))
        self.model.to(self.device).eval()
        self.tokenizer = tokenizer or WordPieceTokenizer(max_len=max_len)

    def fit(self, texts: Sequence[str]) -> "MiniLMEmbedder":
        return self  # nothing corpus-dependent

    @METRICS.spanned("encode")
    @torch.inference_mode()
    def encode_texts(self, texts: Sequence[str]) -> np.ndarray:
        out = []
        for start in range(0, len(texts), self.batch_size):
            batch = list(texts[start : start + self.batch_size])
            with METRICS.span("encode.tokenize"):
                ids, mask = self.tokenizer.encode_batch(batch)
            with METRICS.span("encode.forward"):
                ids_t = torch.from_numpy(np.asarray(ids, np.int64)).to(self.device)
                mask_t = torch.from_numpy(np.asarray(mask)).to(self.device)
                emb = self.model(ids_t, mask_t)
            with METRICS.span("encode.readback"):
                out.append(emb.float().cpu().numpy())
        return np.concatenate(out, axis=0) if out else np.zeros((0, self.dim), np.float32)

    def state_dict(self) -> dict:
        return {"backend": self.backend, "checkpoint": self.checkpoint, "pretrained": self.pretrained}


class TrainedEmbedder:
    """The committed in-domain encoder (``checkpoints/domain_encoder``) as an
    embedder. Raises on a missing or corrupt checkpoint: serving untrained
    weights under the name "trained" would be a quality lie."""

    backend = "trained"

    def __init__(
        self,
        checkpoint: Optional[str] = None,
        batch_size: int = 256,
        pad_multiple: int = 16,
        device: DeviceLike = None,
    ):
        from .domain_encoder import DEFAULT_CKPT_DIR, load_encoder_checkpoint
        from .minilm import MiniLMEncoder, params_from_flax

        self.device = resolve_device(device)
        self.checkpoint = checkpoint or DEFAULT_CKPT_DIR
        params, self.tokenizer, self.config, self.meta = load_encoder_checkpoint(
            self.checkpoint
        )
        self.model = MiniLMEncoder(self.config)
        self.model.load_state_dict(params_from_flax(params))
        self.model.to(self.device).eval()
        self.dim = self.config.hidden_size
        self.batch_size = batch_size
        # Bulk encodes may set pad_multiple = max_position for one [B, S]
        # shape; interactive queries keep 16 and the 64-token buckets below.
        self.pad_multiple = pad_multiple

    def fit(self, texts: Sequence[str]) -> "TrainedEmbedder":
        return self  # nothing corpus-dependent at index-build time

    @METRICS.spanned("encode")
    @torch.inference_mode()
    def encode_texts(self, texts: Sequence[str]) -> np.ndarray:
        out = []
        for start in range(0, len(texts), self.batch_size):
            batch = list(texts[start : start + self.batch_size])
            rows = len(batch)
            with METRICS.span("encode.tokenize"):
                ids, mask = self.tokenizer.encode_batch(batch, pad_multiple=self.pad_multiple)
                if rows < self.batch_size:
                    # Same row and sequence buckets as the JAX package, so both
                    # encode the same padded shapes.
                    target = row_bucket(rows, len(texts), self.batch_size)
                    s_pad = max(64, -(-ids.shape[1] // 64) * 64) - ids.shape[1]
                    if s_pad:
                        ids = np.pad(ids, ((0, 0), (0, s_pad)))
                        mask = np.pad(mask, ((0, 0), (0, s_pad)))
                    if target > rows:
                        ids = np.pad(ids, ((0, target - rows), (0, 0)))
                        mask = np.pad(mask, ((0, target - rows), (0, 0)))
            with METRICS.span("encode.forward"):
                ids_t = torch.from_numpy(np.asarray(ids, np.int64)).to(self.device)
                mask_t = torch.from_numpy(np.asarray(mask)).to(self.device)
                emb = self.model(ids_t, mask_t)[:rows]
            with METRICS.span("encode.readback"):
                out.append(emb.float().cpu().numpy())
        return np.concatenate(out, axis=0) if out else np.zeros((0, self.dim), np.float32)

    def state_dict(self) -> dict:
        return {"backend": self.backend, "checkpoint": self.checkpoint, "meta": self.meta}


def make_embedder(backend: str = "hashed", **kwargs) -> Embedder:
    """The JAX package's factory: kwargs any backend knows are accepted and
    passed to the chosen one if it takes them; ``device`` goes to all."""
    known = {
        "hashed": ("vocab_size", "dim", "seed", "featurizer", "encoder", "device"),
        "minilm": ("checkpoint", "seed", "batch_size", "max_len", "device"),
        "trained": ("checkpoint", "batch_size", "pad_multiple", "device"),
    }
    if backend not in known:
        raise ValueError(f"unknown embed backend: {backend}")
    unknown = set(kwargs) - set().union(*known.values())
    if unknown:
        raise TypeError(f"unknown embedder kwargs: {sorted(unknown)}")
    cls = {"hashed": HashedEmbedder, "minilm": MiniLMEmbedder, "trained": TrainedEmbedder}[backend]
    return cls(**{k: v for k, v in kwargs.items() if k in known[backend]})

"""Text batch -> unit embeddings [B, 384], through the trained encoder.

Counterpart of ``ragfin_tpu/models/embedder.py``. Only the ``trained``
backend is ported; ``hashed`` and ``minilm`` wait for ROADMAP Queue A
item 6.
"""

from __future__ import annotations

from typing import Optional, Protocol, Sequence

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device


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

    @torch.inference_mode()
    def encode_texts(self, texts: Sequence[str]) -> np.ndarray:
        out = []
        for start in range(0, len(texts), self.batch_size):
            batch = list(texts[start : start + self.batch_size])
            ids, mask = self.tokenizer.encode_batch(batch, pad_multiple=self.pad_multiple)
            rows = len(batch)
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
            ids_t = torch.from_numpy(np.asarray(ids, np.int64)).to(self.device)
            mask_t = torch.from_numpy(np.asarray(mask)).to(self.device)
            emb = self.model(ids_t, mask_t)[:rows]
            out.append(emb.float().cpu().numpy())
        return np.concatenate(out, axis=0) if out else np.zeros((0, self.dim), np.float32)

    def state_dict(self) -> dict:
        return {"backend": self.backend, "checkpoint": self.checkpoint, "meta": self.meta}


def make_embedder(backend: str = "trained", **kwargs) -> Embedder:
    if backend in ("hashed", "minilm"):
        raise NotImplementedError(
            f"embed backend '{backend}' is not ported yet (ROADMAP Queue A item 6)"
        )
    if backend != "trained":
        raise ValueError(f"unknown embed backend: {backend}")
    known = ("checkpoint", "batch_size", "pad_multiple", "device")
    unknown = set(kwargs) - set(known)
    if unknown:
        raise TypeError(f"unknown embedder kwargs: {sorted(unknown)}")
    return TrainedEmbedder(**kwargs)

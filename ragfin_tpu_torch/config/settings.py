"""Environment-driven configuration for the vector half of the port.

Counterpart of ``ragfin_tpu/config/settings.py``, cut to the fields the
vector-RAG path reads. The environment variables and defaults are the JAX
package's, so one ``.env`` configures both packages alike.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Optional


def load_dotenv(path: str = ".env") -> None:
    """Minimal .env loader (no python-dotenv dependency)."""
    if not os.path.exists(path):
        return
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, _, value = line.partition("=")
            os.environ.setdefault(key.strip(), value.strip().strip("'\""))


def _default_backend() -> str:
    """The trained encoder is the default wherever its committed checkpoint
    exists; the hashed backend the JAX package falls back to is not ported
    yet (ROADMAP Queue A item 6)."""
    from ..models.domain_encoder import DEFAULT_CKPT_DIR

    if os.path.exists(os.path.join(DEFAULT_CKPT_DIR, "config.json")):
        return "trained"
    return "hashed"


@dataclass
class Settings:
    index_dir: str = ".ragfin_index"
    default_top_k: int = 3
    embed_backend: str = field(default_factory=lambda: _default_backend())
    trained_checkpoint: Optional[str] = None  # None -> packaged default dir
    # "float32" (exact f32 scoring) | "bfloat16" | "int8" (per-column scales)
    index_dtype: str = "float32"
    index_type: str = "flat"  # "flat" | "ivf" (IVF: ROADMAP Slice 3)
    integrity_weight: float = 0.0
    batch_queries: bool = True  # dynamic micro-batching on the query path

    def validate(self) -> list[str]:
        """Configuration issues as warnings, like the JAX package's."""
        issues = []
        if self.default_top_k < 1:
            issues.append("default_top_k must be >= 1")
        if self.embed_backend != "trained":
            issues.append(
                f"embed_backend '{self.embed_backend}' is not ported "
                "(ROADMAP Queue A item 6); only 'trained' runs"
            )
        else:
            from ..models.domain_encoder import DEFAULT_CKPT_DIR

            ckpt = self.trained_checkpoint or DEFAULT_CKPT_DIR
            if not os.path.exists(os.path.join(ckpt, "config.json")):
                issues.append(f"embed_backend=trained but no checkpoint at '{ckpt}'")
        if self.index_dtype not in ("float32", "bfloat16", "int8"):
            issues.append(f"unknown index_dtype '{self.index_dtype}'")
        if self.index_type != "flat":
            issues.append(f"index_type '{self.index_type}' is not ported (ROADMAP Slice 3)")
        return issues


def _from_env() -> Settings:
    load_dotenv()
    env = os.environ
    return Settings(
        index_dir=env.get("RAGFIN_INDEX_DIR", ".ragfin_index"),
        default_top_k=int(env.get("RAGFIN_TOP_K", "3")),
        embed_backend=env.get("RAGFIN_EMBED_BACKEND", _default_backend()),
        trained_checkpoint=env.get("RAGFIN_TRAINED_CHECKPOINT"),
        index_dtype=env.get("RAGFIN_INDEX_DTYPE", "float32"),
        index_type=env.get("RAGFIN_INDEX_TYPE", "flat"),
        integrity_weight=float(env.get("RAGFIN_INTEGRITY_WEIGHT", "0")),
        batch_queries=env.get("RAGFIN_BATCH_QUERIES", "1") not in ("0", "false", "no"),
    )


@lru_cache(maxsize=1)
def get_config() -> Settings:
    return _from_env()

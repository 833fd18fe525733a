"""Environment-driven configuration of the port.

Counterpart of ``ragfin_tpu/config/settings.py``, cut to the fields the
ported paths (vector, graph and hybrid retrieval, flat and IVF index) read. The environment variables and defaults are the JAX
package's, so one ``.env`` configures both packages alike.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Optional

from .constants import SUPPORTED_MODELS


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
    # Model / provider ("fake" = no LLM: lexical question entities and
    # rule-based extraction)
    default_model: str = "fake"
    gemini_api_key: Optional[str] = None
    openai_api_key: Optional[str] = None
    groq_api_key: Optional[str] = None
    ollama_base_url: str = "http://localhost:11434"

    index_dir: str = ".ragfin_index"
    default_top_k: int = 3
    embed_backend: str = field(default_factory=lambda: _default_backend())
    trained_checkpoint: Optional[str] = None  # None -> packaged default dir
    # "float32" (exact f32 scoring) | "bfloat16" | "int8" (per-column scales)
    index_dtype: str = "float32"
    # "flat" = exact search; "ivf" = the reference's index type
    # (cluster-pruned approximate, nlist/nprobe semantics)
    index_type: str = "flat"
    ivf_nprobe: int = 32
    integrity_weight: float = 0.0
    batch_queries: bool = True  # dynamic micro-batching on the query path

    def get_api_key_for_model(self, model_name: str) -> Optional[str]:
        """Per-provider key lookup."""
        if "gemini" in model_name:
            return self.gemini_api_key
        if "gpt" in model_name:
            return self.openai_api_key
        if "llama" in model_name or "groq" in model_name:
            return self.groq_api_key
        return None

    def validate(self) -> list[str]:
        """Configuration issues as warnings, like the JAX package's."""
        issues = []
        if self.default_model not in SUPPORTED_MODELS:
            issues.append(f"unknown default_model '{self.default_model}'")
        if self.default_model != "fake" and not self.get_api_key_for_model(self.default_model):
            issues.append(f"no API key configured for '{self.default_model}'")
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
        if self.index_type not in ("flat", "ivf"):
            issues.append(f"unknown index_type '{self.index_type}'")
        if self.ivf_nprobe < 1:
            issues.append("ivf_nprobe must be >= 1")
        if self.integrity_weight > 0 and self.index_type == "ivf":
            issues.append(
                "integrity_weight > 0 requires the FilteredSearch pipeline "
                "(index_type=flat); with index_type=ivf it never applies"
            )
        return issues


def _from_env() -> Settings:
    load_dotenv()
    env = os.environ
    return Settings(
        default_model=env.get("RAGFIN_MODEL", env.get("DEFAULT_MODEL", "fake")),
        gemini_api_key=env.get("GEMINI_API_KEY") or env.get("GOOGLE_API_KEY"),
        openai_api_key=env.get("OPENAI_API_KEY"),
        groq_api_key=env.get("GROQ_API_KEY"),
        ollama_base_url=env.get("OLLAMA_BASE_URL", "http://localhost:11434"),
        index_dir=env.get("RAGFIN_INDEX_DIR", ".ragfin_index"),
        default_top_k=int(env.get("RAGFIN_TOP_K", "3")),
        embed_backend=env.get("RAGFIN_EMBED_BACKEND", _default_backend()),
        trained_checkpoint=env.get("RAGFIN_TRAINED_CHECKPOINT"),
        index_dtype=env.get("RAGFIN_INDEX_DTYPE", "float32"),
        index_type=env.get("RAGFIN_INDEX_TYPE", "flat"),
        ivf_nprobe=int(env.get("RAGFIN_IVF_NPROBE", "32")),
        integrity_weight=float(env.get("RAGFIN_INTEGRITY_WEIGHT", "0")),
        batch_queries=env.get("RAGFIN_BATCH_QUERIES", "1") not in ("0", "false", "no"),
    )


@lru_cache(maxsize=1)
def get_config() -> Settings:
    return _from_env()

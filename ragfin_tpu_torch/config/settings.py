"""Environment-driven configuration of the port.

Counterpart of ``ragfin_tpu/config/settings.py``, with the same fields,
environment variables and defaults, so one ``.env`` configures both packages
alike. One field is the port's own: ``device`` (``RAGFIN_DEVICE``, the
counterpart of pinning ``JAX_PLATFORMS``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Optional

from .constants import PORTS, SUPPORTED_MODELS


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
    exists; without it, the weight-free hashed backend rather than random
    weights."""
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

    # Data locations
    data_dir: str = "extract_data"
    chunks_snapshot: Optional[str] = None
    index_dir: str = ".ragfin_index"

    # None = the CUDA card (no card raises); "cpu" runs the port on the CPU.
    device: Optional[str] = None

    default_top_k: int = 3
    collection_name: str = "fin_chunks"
    embed_backend: str = field(default_factory=lambda: _default_backend())
    minilm_checkpoint: Optional[str] = None  # a local HF checkpoint directory
    trained_checkpoint: Optional[str] = None  # None -> packaged default dir
    topk_method: str = "auto"  # "auto" | "dense" | "blocked" | "fused"
    # "float32" (exact f32 scoring) | "bfloat16" | "int8" (per-column scales)
    index_dtype: str = "float32"
    # "flat" = exact search; "ivf" = the reference's index type
    # (cluster-pruned approximate, nlist/nprobe semantics)
    index_type: str = "flat"
    ivf_nprobe: int = 32
    integrity_weight: float = 0.0
    # Serving ports (reference registry)
    ports: dict = field(default_factory=lambda: dict(PORTS))
    batch_queries: bool = True  # dynamic micro-batching on the query path

    # Timeouts
    base_timeout_s: float = 30.0

    def get_api_key_for_model(self, model_name: str) -> Optional[str]:
        """Per-provider key lookup."""
        if "gemini" in model_name:
            return self.gemini_api_key
        if "gpt" in model_name:
            return self.openai_api_key
        if "llama" in model_name or "groq" in model_name:
            return self.groq_api_key
        return None

    def get_timeout_for_model(self, model_name: str) -> float:
        """Model-dependent timeouts: 2x for local llama."""
        if "llama" in model_name and not self.groq_api_key:
            return self.base_timeout_s * 2
        return self.base_timeout_s

    def validate(self) -> list[str]:
        """Configuration issues as warnings, like the JAX package's."""
        issues = []
        if self.default_model not in SUPPORTED_MODELS:
            issues.append(f"unknown default_model '{self.default_model}'")
        if self.default_model != "fake" and not self.get_api_key_for_model(self.default_model):
            issues.append(f"no API key configured for '{self.default_model}'")
        if self.default_top_k < 1:
            issues.append("default_top_k must be >= 1")
        if self.embed_backend not in ("hashed", "trained", "minilm"):
            issues.append(f"unknown embed_backend '{self.embed_backend}'")
        if self.embed_backend == "minilm" and not self.minilm_checkpoint:
            issues.append("embed_backend=minilm without minilm_checkpoint (random init)")
        if self.embed_backend == "trained":
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
        if self.integrity_weight > 0 and (
            self.index_type == "ivf" or self.embed_backend != "hashed"
        ):
            # Integrity weighting runs through the FilteredSearch pipeline
            # with the hashed featurizer; otherwise it may not apply (the
            # engine's health() reports `integrity_active`, the runtime truth).
            issues.append(
                "integrity_weight > 0 requires the FilteredSearch pipeline "
                "(index_type=flat + embed_backend=hashed); as configured it "
                "may never apply — check /health integrity_active"
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
        data_dir=env.get("RAGFIN_DATA_DIR", "extract_data"),
        chunks_snapshot=env.get("RAGFIN_CHUNKS_SNAPSHOT"),
        index_dir=env.get("RAGFIN_INDEX_DIR", ".ragfin_index"),
        device=env.get("RAGFIN_DEVICE") or None,
        default_top_k=int(env.get("RAGFIN_TOP_K", "3")),
        embed_backend=env.get("RAGFIN_EMBED_BACKEND", _default_backend()),
        minilm_checkpoint=env.get("RAGFIN_MINILM_CHECKPOINT"),
        trained_checkpoint=env.get("RAGFIN_TRAINED_CHECKPOINT"),
        topk_method=env.get("RAGFIN_TOPK_METHOD", "auto"),
        index_dtype=env.get("RAGFIN_INDEX_DTYPE", "float32"),
        index_type=env.get("RAGFIN_INDEX_TYPE", "flat"),
        ivf_nprobe=int(env.get("RAGFIN_IVF_NPROBE", "32")),
        integrity_weight=float(env.get("RAGFIN_INTEGRITY_WEIGHT", "0")),
        base_timeout_s=float(env.get("RAGFIN_TIMEOUT_S", "30")),
        batch_queries=env.get("RAGFIN_BATCH_QUERIES", "1") not in ("0", "false", "no"),
    )


@lru_cache(maxsize=1)
def get_config() -> Settings:
    return _from_env()


def switch_default_model(model_name: str) -> Settings:
    """Runtime model switch via env + cache clear."""
    os.environ["RAGFIN_MODEL"] = model_name
    get_config.cache_clear()
    return get_config()

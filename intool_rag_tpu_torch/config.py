"""Environment-driven configuration (the subset of
``intool_rag_tpu/config.py`` this port reads).

Same variable names and defaults as the JAX package, so one env file
drives both. ``USE_PALLAS`` keeps its name and means "use the
hand-written kernels".
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from pathlib import Path


def _env_str(name: str, default: str) -> str:
    return os.getenv(name, default)


def _env_int(name: str, default: int) -> int:
    return int(os.getenv(name, str(default)))


def _env_float(name: str, default: float) -> float:
    return float(os.getenv(name, str(default)))


def _env_bool(name: str, default: bool) -> bool:
    return os.getenv(name, "true" if default else "false").strip().lower() in (
        "1", "true", "yes", "on",
    )


def _field(fn):
    return dataclasses.field(default_factory=fn)


# the shipped OCR weights: the JAX package's artifact, read as data
OCR_DEFAULT_WEIGHTS = Path(__file__).resolve().parents[1] / "intool_rag_tpu" / "ocr" / "weights" / "default.npz"


@dataclasses.dataclass
class Config:
    """Runtime configuration; every field has an env-var override."""

    # --- Providers ---
    GEMINI_API_KEY: str = _field(lambda: _env_str("GEMINI_API_KEY", ""))

    # --- Embedding ---
    # "" / "cuda" (the JAX package's "tpu"; both names work) / "hf": the
    # encoder; "hash", "ollama", "gemini"
    EMBEDDING_PROVIDER: str = _field(lambda: _env_str("EMBEDDING_PROVIDER", ""))
    EMBEDDING_MODEL: str = _field(lambda: _env_str("EMBEDDING_MODEL", "BAAI/bge-m3"))
    # encoder size when no weights are given: auto (bge_m3 on the card,
    # tiny on the CPU), bge_m3, small or tiny
    EMBEDDING_PRESET: str = _field(lambda: _env_str("EMBEDDING_PRESET", "auto"))
    EMBEDDING_BATCH_SIZE: int = _field(lambda: _env_int("EMBEDDING_BATCH_SIZE", 64))
    EMBEDDING_CHECKPOINT: str = _field(lambda: _env_str("EMBEDDING_CHECKPOINT", ""))
    EMBEDDING_QUERY_INSTRUCTION: str = _field(
        lambda: _env_str(
            "EMBEDDING_QUERY_INSTRUCTION",
            "Represent this sentence for searching relevant passages: ",
        )
    )
    EMBEDDING_PASSAGE_INSTRUCTION: str = _field(
        lambda: _env_str("EMBEDDING_PASSAGE_INSTRUCTION", "")
    )

    # --- LLM (semantic analysis at ingest, answers of /query) ---
    # "fake", "cuda" (the JAX package's "tpu"; both names work), "gemini",
    # "ollama"; left empty: Gemini with a key, else Ollama, else the fake LLM
    LLM_PROVIDER: str = _field(lambda: _env_str("LLM_PROVIDER", ""))
    LLM_MODEL: str = _field(lambda: _env_str("LLM_MODEL", "qwen2.5:7b-instruct-q4_K_M"))
    LLM_TEMPERATURE: float = _field(lambda: _env_float("LLM_TEMPERATURE", 0.3))
    LLM_MAX_TOKENS: int = _field(lambda: _env_int("LLM_MAX_TOKENS", 512))
    LLM_BASE_URL: str = _field(lambda: _env_str("LLM_BASE_URL", "http://localhost:11434"))
    # local HF Llama checkpoint directory for the in-process decoder
    # (providers/cuda_llm.py); empty: a small random-weight model
    LLM_MODEL_PATH: str = _field(lambda: _env_str("LLM_MODEL_PATH", ""))
    # sampling controls of the in-process decoder (0 / 1.0 = off)
    LLM_TOP_K: int = _field(lambda: _env_int("LLM_TOP_K", 0))
    LLM_TOP_P: float = _field(lambda: _env_float("LLM_TOP_P", 1.0))
    # how the in-process decoder serves (providers/cuda_llm.py):
    # LLM_CONTINUOUS_SLOTS > 0 puts every request into a wave server of that
    # many continuous-batching slots (models/scheduler.py), whose steps are
    # batched prompt-lookup waves of LLM_SPECULATIVE_GAMMA tokens when it is
    # > 1 at temperature 0; without slots, LLM_SPECULATIVE_GAMMA > 0 at
    # temperature 0 speculates on one stream; 0 and 0: one generate a request
    LLM_CONTINUOUS_SLOTS: int = _field(lambda: _env_int("LLM_CONTINUOUS_SLOTS", 0))
    LLM_SPECULATIVE_GAMMA: int = _field(lambda: _env_int("LLM_SPECULATIVE_GAMMA", 0))

    # --- HTTP to providers (providers/http_utils.py) ---
    HTTP_MAX_RETRIES: int = _field(lambda: _env_int("HTTP_MAX_RETRIES", 3))
    HTTP_RETRY_DELAY: float = _field(lambda: _env_float("HTTP_RETRY_DELAY", 2.0))
    HTTP_CONNECT_TIMEOUT: float = _field(lambda: _env_float("HTTP_CONNECT_TIMEOUT", 10.0))
    HTTP_READ_TIMEOUT: float = _field(lambda: _env_float("HTTP_READ_TIMEOUT", 120.0))
    HTTP_WRITE_TIMEOUT: float = _field(lambda: _env_float("HTTP_WRITE_TIMEOUT", 10.0))

    # --- Reranker ---
    RERANKER_MODEL: str = _field(lambda: _env_str("RERANKER_MODEL", "BAAI/bge-reranker-v2-m3"))
    RERANKER_ENABLED: bool = _field(lambda: _env_bool("RERANKER_ENABLED", False))
    RERANKER_TOP_K: int = _field(lambda: _env_int("RERANKER_TOP_K", 10))
    RERANKER_CANDIDATES: int = _field(lambda: _env_int("RERANKER_CANDIDATES", 100))

    # --- Chunking ---
    CHUNK_MAX_CHARS: int = _field(lambda: _env_int("CHUNK_MAX_CHARS", 1000))
    CHUNK_MIN_CHARS: int = _field(lambda: _env_int("CHUNK_MIN_CHARS", 100))
    CHUNK_TARGET_CHARS: int = _field(lambda: _env_int("CHUNK_TARGET_CHARS", 600))
    CHUNK_OVERLAP_CHARS: int = _field(lambda: _env_int("CHUNK_OVERLAP_CHARS", 0))

    # --- Retrieval ---
    RETRIEVAL_CANDIDATES: int = _field(lambda: _env_int("RETRIEVAL_CANDIDATES", 50))
    RETRIEVAL_MIN_SCORE: float = _field(lambda: _env_float("RETRIEVAL_MIN_SCORE", 0.3))
    HYBRID_SEARCH_ENABLED: bool = _field(lambda: _env_bool("HYBRID_SEARCH_ENABLED", True))
    BM25_WEIGHT: float = _field(lambda: _env_float("BM25_WEIGHT", 0.3))
    VECTOR_WEIGHT: float = _field(lambda: _env_float("VECTOR_WEIGHT", 0.7))
    FUSION_MODE: str = _field(lambda: _env_str("FUSION_MODE", "weighted"))  # or "rrf"
    RRF_K: int = _field(lambda: _env_int("RRF_K", 60))
    TOP_PAGES: int = _field(lambda: _env_int("TOP_PAGES", 5))

    # --- Page ranking ---
    PAGE_CHUNK_BOOST: float = _field(lambda: _env_float("PAGE_CHUNK_BOOST", 0.05))
    PAGE_CHUNK_BOOST_CAP: float = _field(lambda: _env_float("PAGE_CHUNK_BOOST_CAP", 0.15))
    TABLE_BOOST_MULTIPLIER: float = _field(lambda: _env_float("TABLE_BOOST_MULTIPLIER", 1.5))
    TABLE_CONTEXT_PRIORITY: bool = _field(lambda: _env_bool("TABLE_CONTEXT_PRIORITY", True))

    # --- Context assembly (query/response.py) ---
    CONTEXT_MAX_RESULTS: int = _field(lambda: _env_int("CONTEXT_MAX_RESULTS", 3))
    MAX_CONTEXT_LENGTH: int = _field(lambda: _env_int("MAX_CONTEXT_LENGTH", 8000))

    # --- Caches (storage/cache.py) ---
    CACHE_EMBEDDINGS: bool = _field(lambda: _env_bool("CACHE_EMBEDDINGS", True))
    CACHE_QUERY_RESULTS: bool = _field(lambda: _env_bool("CACHE_QUERY_RESULTS", True))
    CACHE_DIR: Path = _field(lambda: Path(_env_str("CACHE_DIR", "./storages/cache")))

    # --- Storage ---
    STORAGE_DIR: Path = _field(lambda: Path(_env_str("STORAGE_DIR", "./storages")))

    # --- Index / kernels ---
    INDEX_DTYPE: str = _field(lambda: _env_str("INDEX_DTYPE", "bfloat16"))  # or float32
    DENSE_INT8: bool = _field(lambda: _env_bool("DENSE_INT8", False))
    DENSE_INT8_RESIDUAL: bool = _field(lambda: _env_bool("DENSE_INT8_RESIDUAL", False))
    INDEX_KIND: str = _field(lambda: _env_str("INDEX_KIND", "flat"))
    SEARCH_BLOCK_N: int = _field(lambda: _env_int("SEARCH_BLOCK_N", 16384))
    # multi-device corpus sharding: "auto" shards the dense index over every
    # local device when there are two or more and the corpus holds at least
    # SHARDED_SEARCH_MIN_ROWS rows; "off" stays on one device; "on" shards
    # whenever two or more devices are visible
    SHARDED_SEARCH: str = _field(lambda: _env_str("SHARDED_SEARCH", "auto"))
    SHARDED_SEARCH_MIN_ROWS: int = _field(lambda: _env_int("SHARDED_SEARCH_MIN_ROWS", 100_000))
    USE_PALLAS: bool = _field(lambda: _env_bool("USE_PALLAS", True))
    IVF_NLIST: int = _field(lambda: _env_int("IVF_NLIST", 1024))
    IVF_NPROBE: int = _field(lambda: _env_int("IVF_NPROBE", 64))
    # candidate pool the host int8 tier rescores exactly (0 = off)
    IVF_REFINE_K: int = _field(lambda: _env_int("IVF_REFINE_K", 0))
    # residual code width of ivf_residual / segmented: 4 (int4, 0.5 byte a
    # dim) or 1 (sign codes, 0.125 byte a dim; pair with IVF_REFINE_K)
    IVF_RESIDUAL_BITS: int = _field(lambda: _env_int("IVF_RESIDUAL_BITS", 4))

    # --- BM25 ---
    BM25_K1: float = _field(lambda: _env_float("BM25_K1", 1.5))
    BM25_B: float = _field(lambda: _env_float("BM25_B", 0.75))
    BM25_MAX_QUERY_TERMS: int = _field(lambda: _env_int("BM25_MAX_QUERY_TERMS", 32))

    # --- OCR fallback for scanned PDF pages ---
    # on exactly when the shipped weights exist, as in the JAX package:
    # without trained weights the recognizer would emit noise
    OCR_ENABLED: bool = _field(lambda: _env_bool("OCR_ENABLED", OCR_DEFAULT_WEIGHTS.exists()))

    # --- Logging (logging.py: the root level, set on the first logger) ---
    LOG_LEVEL: str = _field(lambda: _env_str("LOG_LEVEL", "INFO"))

    # --- Mesh ---
    # the JAX package's mesh axis sizes (0 = all devices), with its defaults;
    # read by nothing in either package: the sharded entry points take a
    # mesh (parallel/mesh.py). Another value draws a warning (__post_init__)
    MESH_DATA_AXIS: int = _field(lambda: _env_int("MESH_DATA_AXIS", 0))
    MESH_MODEL_AXIS: int = _field(lambda: _env_int("MESH_MODEL_AXIS", 1))

    # --- Serving ---
    SERVICE_HOST: str = _field(lambda: _env_str("SERVICE_HOST", "0.0.0.0"))
    SERVICE_PORT: int = _field(lambda: _env_int("SERVICE_PORT", 8001))
    QUERY_MICRO_BATCH_WINDOW_MS: float = _field(
        lambda: _env_float("QUERY_MICRO_BATCH_WINDOW_MS", 2.0)
    )
    QUERY_MAX_BATCH: int = _field(lambda: _env_int("QUERY_MAX_BATCH", 64))

    def __post_init__(self) -> None:
        if (self.MESH_DATA_AXIS, self.MESH_MODEL_AXIS) != (0, 1):
            warnings.warn(
                f"MESH_DATA_AXIS={self.MESH_DATA_AXIS} / MESH_MODEL_AXIS={self.MESH_MODEL_AXIS} are ignored: "
                "nothing reads them, as in the JAX package; pass a mesh to the sharded entry points "
                "(parallel/mesh.py: train_mesh, seq_mesh)", stacklevel=2)

    @property
    def UPLOAD_DIR(self) -> Path:
        return self.STORAGE_DIR / "uploads"

    def ensure_dirs(self) -> None:
        """Create the storage directories (explicit, not at import)."""
        for d in (self.STORAGE_DIR, self.UPLOAD_DIR, self.CACHE_DIR):
            d.mkdir(parents=True, exist_ok=True)


_config: Config | None = None


def get_config() -> Config:
    """Process-wide config singleton (reads the environment on first call)."""
    global _config
    if _config is None:
        _config = Config()
    return _config


def reset_config() -> Config:
    """Rebuild the singleton from the current environment."""
    global _config
    _config = Config()
    return _config

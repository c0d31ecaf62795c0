"""Gemini provider over the public REST API (port of
``intool_rag_tpu/providers/gemini.py``). Active only when
``GEMINI_API_KEY`` is set; the factories pass it by otherwise."""

from __future__ import annotations

import numpy as np

from ..config import get_config
from ..exceptions import EmbeddingProviderError, LLMProviderError
from ..llm.base import BaseLLM
from ..llm.semantic.base import SectionSpec, SemanticAnalyzer
from .http_utils import request_with_retry
from .ollama import parse_sections
from .prompts import STRUCTURE_ANALYSIS_PROMPT, tag_pages

_BASE = "https://generativelanguage.googleapis.com/v1beta"
_GEN_MODEL = "gemini-2.0-flash"
_EMBED_MODEL = "gemini-embedding-001"


def _key() -> str:
    return get_config().GEMINI_API_KEY


class GeminiLLM(BaseLLM):
    def __init__(self, model: str = _GEN_MODEL) -> None:
        self.model = model

    def generate(self, prompt: str, **kwargs) -> str:
        cfg = get_config()
        resp = request_with_retry(
            "POST",
            f"{_BASE}/models/{self.model}:generateContent?key={_key()}",
            json={
                "contents": [{"parts": [{"text": prompt}]}],
                "generationConfig": {
                    "temperature": kwargs.get("temperature", cfg.LLM_TEMPERATURE),
                    "maxOutputTokens": kwargs.get("max_tokens", cfg.LLM_MAX_TOKENS),
                },
            },
        )
        if resp.status_code != 200:
            raise LLMProviderError(f"gemini generate failed: {resp.status_code}")
        data = resp.json()
        try:
            return data["candidates"][0]["content"]["parts"][0]["text"]
        except (KeyError, IndexError) as exc:
            raise LLMProviderError(f"unexpected gemini response: {exc}") from exc

    def is_ready(self) -> bool:
        return bool(_key())

    def get_info(self) -> dict:
        return {"provider": "gemini", "model": self.model}


class GeminiEmbeddingProvider:
    """One batched REST call per ``embed_batch``."""

    def __init__(self, model: str = _EMBED_MODEL, dimension: int = 768) -> None:
        self.model = model
        self._dim = dimension

    @property
    def dimension(self) -> int:
        return self._dim

    @property
    def model_name(self) -> str:
        return self.model

    def embed_batch(self, texts: list[str], *, is_query: bool = False) -> np.ndarray:
        resp = request_with_retry(
            "POST",
            f"{_BASE}/models/{self.model}:batchEmbedContents?key={_key()}",
            json={
                "requests": [
                    {
                        "model": f"models/{self.model}",
                        "content": {"parts": [{"text": t}]},
                        "taskType": "RETRIEVAL_QUERY" if is_query else "RETRIEVAL_DOCUMENT",
                    }
                    for t in texts
                ]
            },
        )
        if resp.status_code != 200:
            raise EmbeddingProviderError(f"gemini embed failed: {resp.status_code}")
        vecs = np.asarray([e["values"] for e in resp.json()["embeddings"]], np.float32)
        norms = np.linalg.norm(vecs, axis=1, keepdims=True)
        return vecs / np.maximum(norms, 1e-9)

    def embed_single(self, text: str, *, is_query: bool = False) -> np.ndarray:
        return self.embed_batch([text], is_query=is_query)[0]


class GeminiSemanticAnalyzer(SemanticAnalyzer):
    def __init__(self, llm: GeminiLLM | None = None) -> None:
        self.llm = llm or GeminiLLM()

    def analyze(self, pages: list[str]) -> list[SectionSpec]:
        raw = self.llm.generate(
            STRUCTURE_ANALYSIS_PROMPT.format(document=tag_pages(pages)), temperature=0.0, max_tokens=16384,
        )
        return parse_sections(raw)

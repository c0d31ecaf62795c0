"""Ollama provider: generation and semantic analysis over its local REST
API (port of ``intool_rag_tpu/providers/ollama.py``)."""

from __future__ import annotations

import json
from typing import Iterator

from ..config import get_config
from ..exceptions import LLMProviderError
from ..llm.base import BaseLLM
from ..llm.semantic.base import SectionSpec, SemanticAnalyzer
from . import http_utils
from .http_utils import request_with_retry, stream_lines
from .json_utils import sanitize_json
from .prompts import STRUCTURE_ANALYSIS_PROMPT, tag_pages


class OllamaLLM(BaseLLM):
    def __init__(self, model: str | None = None, base_url: str | None = None) -> None:
        cfg = get_config()
        self.model = model or cfg.LLM_MODEL
        self.base_url = (base_url or cfg.LLM_BASE_URL).rstrip("/")

    def generate(self, prompt: str, **kwargs) -> str:
        cfg = get_config()
        resp = request_with_retry(
            "POST",
            f"{self.base_url}/api/generate",
            json={
                "model": self.model,
                "prompt": prompt,
                "stream": False,
                "options": {
                    "temperature": kwargs.get("temperature", cfg.LLM_TEMPERATURE),
                    "num_predict": kwargs.get("max_tokens", cfg.LLM_MAX_TOKENS),
                },
            },
        )
        if resp.status_code != 200:
            raise LLMProviderError(f"ollama generate failed: {resp.status_code}")
        return resp.json().get("response", "")

    def generate_stream(self, prompt: str, **kwargs) -> Iterator[str]:
        cfg = get_config()
        status, lines = stream_lines(
            "POST",
            f"{self.base_url}/api/generate",
            json={"model": self.model, "prompt": prompt, "stream": True,
                  "options": {"temperature": kwargs.get("temperature", cfg.LLM_TEMPERATURE)}},
        )
        if status != 200:
            raise LLMProviderError(f"ollama generate failed: {status}")
        for line in lines:
            if not line:
                continue
            chunk = json.loads(line)
            if chunk.get("response"):
                yield chunk["response"]
            if chunk.get("done"):
                break

    def is_ready(self) -> bool:
        try:
            status, lines = http_utils.transport("GET", f"{self.base_url}/api/tags", timeout=2.0)
            for _ in lines:  # read the answer through, which closes the connection
                pass
            return status == 200
        except Exception:
            return False

    def get_info(self) -> dict:
        return {"provider": "ollama", "model": self.model, "base_url": self.base_url}


def parse_sections(raw: str) -> list[SectionSpec]:
    """The ``SectionSpec``s of an analyzer's JSON answer; entries without a
    title are dropped, titles cut to 120 characters."""
    data = sanitize_json(raw)
    sections = data.get("sections", data) if isinstance(data, dict) else data
    return [
        SectionSpec(
            title=str(s.get("title", ""))[:120],
            level=s.get("level", "section"),
            page_index=int(s.get("page_index", 0)),
            summary=str(s.get("summary", "")),
        )
        for s in sections
        if isinstance(s, dict) and s.get("title")
    ]


class OllamaSemanticAnalyzer(SemanticAnalyzer):
    def __init__(self, llm: OllamaLLM | None = None) -> None:
        self.llm = llm or OllamaLLM()

    def analyze(self, pages: list[str]) -> list[SectionSpec]:
        prompt = STRUCTURE_ANALYSIS_PROMPT.format(document=tag_pages(pages))
        return parse_sections(self.llm.generate(prompt, temperature=0.0, max_tokens=16384))

"""The port's providers and factories against the JAX package's.

Hash embeddings, JSON hardening and prompts must be equal; both factories
must choose the same provider for the same environment; the Ollama and
Gemini clients must send the same requests and parse the same canned
answers into the same sections and vectors. The port's HTTP goes through
``providers/http_utils.transport``, which the tests replace; the JAX
package's through its ``request_with_retry``, replaced the same way. One
test drives the real transport against a server on localhost.
"""

from __future__ import annotations

import json
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

import intool_rag_tpu.providers.gemini as jgemini
import intool_rag_tpu.providers.ollama as jollama
import intool_rag_tpu.providers.ollama_embed as jollama_embed
from intool_rag_tpu import config as jconfig
from intool_rag_tpu.llm.embeddings import factory as jembed_factory
from intool_rag_tpu.llm.semantic import factory as jsem_factory
from intool_rag_tpu.providers.hash_embed import HashEmbeddingProvider as JHash
from intool_rag_tpu.providers.json_utils import sanitize_json as jsanitize
from intool_rag_tpu.providers.prompts import STRUCTURE_ANALYSIS_PROMPT as JPROMPT
from intool_rag_tpu.providers.prompts import tag_pages as jtag_pages
from intool_rag_tpu_torch import config as tconfig
from intool_rag_tpu_torch.exceptions import ProviderConnectionError, ProviderTimeoutError
from intool_rag_tpu_torch.llm.embeddings import factory as tembed_factory
from intool_rag_tpu_torch.llm.semantic import factory as tsem_factory
from intool_rag_tpu_torch.providers import gemini as tgemini
from intool_rag_tpu_torch.providers import http_utils
from intool_rag_tpu_torch.providers import ollama as tollama
from intool_rag_tpu_torch.providers import ollama_embed as tollama_embed
from intool_rag_tpu_torch.providers.hash_embed import HashEmbeddingProvider as THash
from intool_rag_tpu_torch.providers.json_utils import sanitize_json as tsanitize
from intool_rag_tpu_torch.providers.prompts import STRUCTURE_ANALYSIS_PROMPT as TPROMPT
from intool_rag_tpu_torch.providers.prompts import tag_pages as ttag_pages

TEXTS = [
    "The Quick-Brown FOX jumps over the invoice total",
    "€uro price 5€ and C++ a+b",
    "发票金额总计 with mixed内容 and numbers 42",
    "",
    "МОСКВА ΑΘΗΝΑ ﬁle ① İstanbul",
]


@pytest.fixture
def env(monkeypatch):
    """Sets variables for both packages' configs and rebuilds both; undone
    (and both rebuilt) afterwards."""
    for name in ("EMBEDDING_PROVIDER", "LLM_PROVIDER", "GEMINI_API_KEY", "EMBEDDING_CHECKPOINT"):
        monkeypatch.setenv(name, "")
    monkeypatch.setenv("HTTP_RETRY_DELAY", "0")

    def set_env(**values):
        for name, value in values.items():
            monkeypatch.setenv(name, value)
        jconfig.reset_config()
        tconfig.reset_config()

    set_env()
    yield set_env
    monkeypatch.undo()
    jconfig.reset_config()
    tconfig.reset_config()
    for f in (jembed_factory, tembed_factory):
        f.reset_embedding_provider()
    for f in (jsem_factory, tsem_factory):
        f.reset_semantic_analyzer()


# ------------------------------------------------------------------ pure functions


@pytest.mark.parametrize("prefix", ["", "Represent this sentence for searching relevant passages: "])
@pytest.mark.parametrize("dim", [64, 256])
def test_hash_embeddings_bit_equal(env, prefix, dim):
    env(EMBEDDING_QUERY_INSTRUCTION=prefix)
    for is_query in (False, True):
        got = THash(dim).embed_batch(TEXTS, is_query=is_query)
        want = JHash(dim).embed_batch(TEXTS, is_query=is_query)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert THash(dim).model_name == JHash(dim).model_name


@pytest.mark.parametrize("text", [
    '```json\n{"sections": [{"title": "A"}]}\n```',
    'Sure! Here it is: {"a": [1, 2, {"b": "}"}]} trailing words',
    "[1, 2, 3] and then {\"x\": 1}",
    '```\n[{"t": 1}, {"t": 2}]\n```',
    "  {\"plain\": true}  ",
])
def test_sanitize_json_equal(text):
    assert tsanitize(text) == jsanitize(text)


def test_sanitize_json_raises_alike():
    for text in ("no json here", "{unclosed", '{"broken": [1, 2} then [3, 4]'):
        with pytest.raises(json.JSONDecodeError):
            jsanitize(text)
        with pytest.raises(json.JSONDecodeError):
            tsanitize(text)


def test_prompts_equal():
    pages = ["first page", "", "third 页 €"]
    assert TPROMPT == JPROMPT
    assert ttag_pages(pages) == jtag_pages(pages)
    assert TPROMPT.format(document=ttag_pages(pages)) == JPROMPT.format(document=jtag_pages(pages))


# ------------------------------------------------------------------ factories


def _ollama_ready(monkeypatch, ready: bool) -> None:
    """Ollama's readiness in both packages: the JAX probe replaced, the
    port's through its transport (an answer, or a refused connection)."""
    monkeypatch.setattr(jollama.OllamaLLM, "is_ready", lambda self: ready)

    def transport(method, url, body=None, *, timeout=None):
        assert url.endswith("/api/tags") and timeout == 2.0
        if not ready:
            raise ProviderConnectionError("connection refused")
        return 200, iter([b'{"models": []}'])

    monkeypatch.setattr(http_utils, "transport", transport)


@pytest.mark.parametrize("case", [
    ("", "", False, "HeuristicSemanticAnalyzer"),  # the default configuration, offline
    ("", "", True, "OllamaSemanticAnalyzer"),
    ("", "key", False, "GeminiSemanticAnalyzer"),
    ("", "key", True, "GeminiSemanticAnalyzer"),
    ("fake", "key", True, "HeuristicSemanticAnalyzer"),
    ("heuristic", "", True, "HeuristicSemanticAnalyzer"),
    ("ollama", "", False, "HeuristicSemanticAnalyzer"),
    ("gemini", "", True, "OllamaSemanticAnalyzer"),
], ids=lambda c: f"{c[0] or 'unset'}-{'key' if c[1] else 'nokey'}-{'ollama' if c[2] else 'offline'}")
def test_semantic_factory_table(env, monkeypatch, case):
    provider, key, ready, want = case
    env(LLM_PROVIDER=provider, GEMINI_API_KEY=key)
    _ollama_ready(monkeypatch, ready)
    for f in (jsem_factory, tsem_factory):
        f.reset_semantic_analyzer()
    assert type(jsem_factory.get_semantic_analyzer()).__name__ == want
    assert type(tsem_factory.get_semantic_analyzer()).__name__ == want


def _stub_encoders(monkeypatch) -> None:
    """Both packages' encoder providers replaced by stubs of the same name,
    so the table is read without building an encoder."""
    import intool_rag_tpu.providers.tpu_embed as jtpu
    import intool_rag_tpu_torch.providers.cuda_embed as tcuda

    def stub(name):
        return type(name, (), {"__init__": lambda self, device=None: setattr(self, "device", device)})

    monkeypatch.setattr(jtpu, "TPUEmbeddingProvider", stub("TPUEmbeddingProvider"))
    monkeypatch.setattr(tcuda, "CudaEmbeddingProvider", stub("CudaEmbeddingProvider"))


PORT_NAMES = {"CudaEmbeddingProvider": "TPUEmbeddingProvider"}


@pytest.mark.parametrize("case", [
    ("hash", ""), ("ollama", ""), ("gemini", "key"), ("gemini", ""), ("", "key"), ("", ""),
    ("tpu", ""), ("hf", ""), ("unknown", ""), ("HASH", "key"),
], ids=lambda c: f"{c[0] or 'unset'}-{'key' if c[1] else 'nokey'}")
def test_embedding_factory_table(env, monkeypatch, case):
    choice, key = case
    env(EMBEDDING_PROVIDER=choice, GEMINI_API_KEY=key)
    _stub_encoders(monkeypatch)
    want = type(jembed_factory._build()).__name__
    got = tembed_factory._build(device="cpu")
    assert PORT_NAMES.get(type(got).__name__, type(got).__name__) == want
    if want == "TPUEmbeddingProvider":
        assert got.device == "cpu"  # the device the caller asked for reaches the encoder


def test_embedding_factory_cuda_names_the_encoder(env, monkeypatch):
    env(EMBEDDING_PROVIDER="cuda")
    _stub_encoders(monkeypatch)
    assert type(tembed_factory.get_embedding_provider(device="cpu")).__name__ == "CudaEmbeddingProvider"


@pytest.mark.parametrize("choice", ["", "cuda", "hf"])
def test_missing_cuda_device_raises_instead_of_hash(env, monkeypatch, choice):
    """Where the JAX factory drops to hash embeddings when its encoder
    cannot start, the port's raises: without a CUDA device the encoder
    provider refuses, and nothing hides that."""
    env(EMBEDDING_PROVIDER=choice)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tembed_factory.get_embedding_provider()
    assert tembed_factory._provider is None


# ------------------------------------------------------------------ canned answers

SECTIONS_TEXT = "```json\n" + json.dumps({"sections": [
    {"title": "Introduction", "level": "chapter", "page_index": 0, "summary": "What it is."},
    {"title": "", "level": "section", "page_index": 1},
    {"title": "Pricing in €" + " long" * 40, "level": "section", "page_index": "2"},
    "not a dict",
    {"title": "Terms", "page_index": 3},
]}) + "\n```"
VECTORS = [[3.0, 4.0, 0.0], [0.0, 0.0, 2.0], [1.0, 1.0, 1.0]]


def _answer(url: str) -> dict:
    if url.endswith("/api/generate"):
        return {"response": SECTIONS_TEXT}
    if url.endswith("/api/embed"):
        return {"embeddings": VECTORS}
    if ":generateContent" in url:
        return {"candidates": [{"content": {"parts": [{"text": SECTIONS_TEXT}]}}]}
    if ":batchEmbedContents" in url:
        return {"embeddings": [{"values": v} for v in VECTORS]}
    raise AssertionError(url)


@pytest.fixture
def canned(monkeypatch):
    """Both packages answered from ``_answer``; returns the requests each
    sent, as (method, url, json body)."""
    sent = {"jax": [], "port": []}

    class JResponse:
        status_code = 200

        def __init__(self, url):
            self._data = _answer(url)

        def json(self):
            return self._data

    def jax_request(method, url, **kwargs):
        sent["jax"].append((method, url, kwargs.get("json")))
        return JResponse(url)

    for mod in (jollama, jgemini, jollama_embed):
        monkeypatch.setattr(mod, "request_with_retry", jax_request)

    def transport(method, url, body=None, *, timeout=None):
        sent["port"].append((method, url, None if body is None else json.loads(body)))
        return 200, iter([json.dumps(_answer(url)).encode()])

    monkeypatch.setattr(http_utils, "transport", transport)
    return sent


def test_ollama_analyzer_parses_alike(env, canned):
    pages = ["Introduction text", "Pricing €", "Terms"]
    got = tollama.OllamaSemanticAnalyzer().analyze(pages)
    want = jollama.OllamaSemanticAnalyzer().analyze(pages)
    assert [vars(s) for s in got] == [vars(s) for s in want]
    assert len(got) == 3 and len(got[1].title) == 120
    assert canned["port"] == canned["jax"]


def test_gemini_analyzer_parses_alike(env, canned):
    env(GEMINI_API_KEY="key")
    pages = ["Introduction text", "Pricing €"]
    got = tgemini.GeminiSemanticAnalyzer().analyze(pages)
    want = jgemini.GeminiSemanticAnalyzer().analyze(pages)
    assert [vars(s) for s in got] == [vars(s) for s in want]
    assert canned["port"] == canned["jax"]


@pytest.mark.parametrize("which", ["ollama", "gemini"])
def test_embedders_parse_alike(env, canned, which):
    env(GEMINI_API_KEY="key", EMBEDDING_QUERY_INSTRUCTION="query: ")
    make = {"ollama": (tollama_embed.OllamaEmbeddingProvider, jollama_embed.OllamaEmbeddingProvider),
            "gemini": (tgemini.GeminiEmbeddingProvider, jgemini.GeminiEmbeddingProvider)}[which]
    port, ref = make[0](), make[1]()
    for is_query in (False, True):
        got = port.embed_batch(TEXTS[:3], is_query=is_query)
        want = ref.embed_batch(TEXTS[:3], is_query=is_query)
        assert got.dtype == np.float32 and np.array_equal(got, want)
    if which == "ollama":
        assert port.dimension == ref.dimension == 3
    assert canned["port"] == canned["jax"]


def test_ollama_generate_stream(env, monkeypatch):
    lines = [b'{"response": "Hel"}\n', b'\n', b'{"response": "lo"}\n', b'{"response": "", "done": true}\n',
             b'{"response": "never"}\n']
    monkeypatch.setattr(http_utils, "transport", lambda method, url, body=None, *, timeout=None: (200, iter(lines)))
    assert "".join(tollama.OllamaLLM().generate_stream("hi")) == "Hello"


# ------------------------------------------------------------------ retries and the real transport


def test_retries_then_succeeds(env, monkeypatch):
    env(HTTP_MAX_RETRIES="3")
    calls = []

    def flaky(method, url, body=None, *, timeout=None):
        calls.append(url)
        if len(calls) == 1:
            raise ProviderConnectionError("refused")
        if len(calls) == 2:
            return 503, iter([b"busy"])
        if len(calls) == 3:
            raise ProviderTimeoutError("read timed out")
        return 404, iter([b"missing"])

    monkeypatch.setattr(http_utils, "transport", flaky)
    resp = http_utils.request_with_retry("GET", "http://localhost:1/x")
    assert (resp.status_code, resp.text, len(calls)) == (404, "missing", 4)


@pytest.mark.parametrize("error", [ProviderConnectionError, ProviderTimeoutError])
def test_retries_give_up_with_the_last_error(env, monkeypatch, error):
    env(HTTP_MAX_RETRIES="2")
    calls = []

    def down(method, url, body=None, *, timeout=None):
        calls.append(url)
        raise error("down")

    monkeypatch.setattr(http_utils, "transport", down)
    with pytest.raises(error):
        http_utils.request_with_retry("POST", "http://localhost:1/x", json={"a": 1})
    assert len(calls) == 3  # the first try and HTTP_MAX_RETRIES retries


def test_transport_against_a_local_server(env):
    """The standard-library transport end to end, on localhost only: a
    JSON answer, a streamed answer, readiness, and a refused connection."""

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, body):
            self.send_response(code)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            self._send(200 if self.path == "/api/tags" else 404, b'{"models": []}')

        def do_POST(self):  # noqa: N802
            request = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
            if request.get("stream"):
                self._send(200, b'{"response": "a"}\n{"response": "b", "done": true}\n')
            else:
                self._send(200, json.dumps({"response": request["prompt"][::-1]}).encode())

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        llm = tollama.OllamaLLM(base_url=f"http://127.0.0.1:{server.server_address[1]}")
        assert llm.is_ready()
        assert llm.generate("abc") == "cba"
        assert "".join(llm.generate_stream("x")) == "ab"
    finally:
        server.shutdown()
        server.server_close()
    with socket.socket() as s:  # a port nobody listens on
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env(HTTP_MAX_RETRIES="0")
    closed = tollama.OllamaLLM(base_url=f"http://127.0.0.1:{port}")
    assert not closed.is_ready()
    with pytest.raises(ProviderConnectionError):
        closed.generate("abc")

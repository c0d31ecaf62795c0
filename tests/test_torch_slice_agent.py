"""The served surface as a whole: the port's HTTP service against the JAX
package's, each over its own ``STORAGE_DIR`` holding the same ingested
uploads (``test_torch_agent.py``'s ``services``: hash embeddings, an f32
store), both served over HTTP by their own ``ServiceServer``.

- ``POST /agent/query`` for questions of every intent and a project
  filter: equal bodies but for ``execution_time_ms`` (relevance scores to
  2e-4, the retrieval tolerance); ``GET /agent/health`` equal;
- ``POST /query`` with the fake LLM, then, with ``LLM_CONTINUOUS_SLOTS=2``,
  through the tiny decoder (f32, temperature 0, the JAX weights carried
  across) behind each package's wave server, four requests at once: equal
  bodies; the wave servers count the same requests and tokens;
- ``GET /metrics``: the same keys, counters, latency-window names and
  counts, corpus and query-cache numbers, and batcher requests. Left out:
  the latencies themselves, ``batches_run`` and the number of waves, which
  depend on how concurrent requests met in time.
"""

from __future__ import annotations

import dataclasses
import json
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from test_torch_agent import SCORE_TOL, agent_questions, same_agent_answer, services  # noqa: F401

torch.set_num_threads(2)
WAVE_KEYS = ("llm_wave_requests", "llm_wave_tokens", "llm_compactions", "llm_wave_errors")


@pytest.fixture(scope="module")
def servers(services):  # noqa: F811
    from intool_rag_tpu.service.http import ServiceServer as JServer
    from intool_rag_tpu_torch.service.http import ServiceServer

    jservice, tservice, _ = services
    jserver, tserver = JServer(jservice, host="127.0.0.1", port=0), ServiceServer(tservice, host="127.0.0.1", port=0)
    jserver.start_background()
    tserver.start_background()
    yield jserver.port, tserver.port
    jserver.shutdown()
    tserver.shutdown()


def _call(port: int, method: str, path: str, body: dict | None = None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.status, json.loads(resp.read())


def _both(ports, method: str, path: str, body: dict | None = None):
    (js, want), (ts, got) = (_call(p, method, path, body) for p in ports)
    assert js == ts == 200
    return want, got


def _same_query_answer(got: dict, want: dict) -> None:
    assert set(got) == set(want) == {"answer", "sources", "confidence"}
    assert (got["answer"], got["confidence"]) == (want["answer"], want["confidence"])
    assert len(got["sources"]) == len(want["sources"])
    for g, w in zip(got["sources"], want["sources"]):
        assert {k: v for k, v in g.items() if k != "relevance_score"} == \
            {k: v for k, v in w.items() if k != "relevance_score"}
        assert g["relevance_score"] == pytest.approx(w["relevance_score"], abs=SCORE_TOL)


def _process_counters(get_metrics) -> dict:
    return {k: get_metrics().snapshot()["counters"].get(k, 0) for k in WAVE_KEYS}


def test_served_surface_equals_jax(services, servers, monkeypatch):  # noqa: F811
    from intool_rag_tpu import config as jconfig
    from intool_rag_tpu.models import decoder as jdec
    from intool_rag_tpu.observability import get_metrics as jmetrics
    from intool_rag_tpu.providers.tpu_llm import TPULLM
    from intool_rag_tpu_torch import config as tconfig
    from intool_rag_tpu_torch.models import decoder as tdec
    from intool_rag_tpu_torch.observability import get_metrics as tmetrics
    from intool_rag_tpu_torch.providers.cuda_llm import CudaLLM

    jservice, tservice, _ = services
    for question, project in agent_questions():
        want, got = _both(servers, "POST", "/agent/query", {"question": question, "project": project})
        same_agent_answer(got, want)
    assert _both(servers, "GET", "/agent/health") == ({"status": "ok", "pipeline": "page-aware-agent"},) * 2
    questions = [q for q, _ in agent_questions()[:4]]
    for question in questions + questions[:1]:  # the repeat is a cache hit in both
        _same_query_answer(*reversed(_both(servers, "POST", "/query", {"question": question})))

    jcfg = dataclasses.replace(jdec.DecoderConfig.tiny(), vocab_size=260, max_position=256)
    tcfg = dataclasses.replace(tdec.DecoderConfig.tiny(), vocab_size=260, max_position=256)
    params = jdec.init_decoder_params(jcfg, seed=5)
    monkeypatch.setenv("LLM_CONTINUOUS_SLOTS", "2")
    jconfig.reset_config()
    tconfig.reset_config()
    jllm = TPULLM(config=jcfg, params=params, max_new_tokens=16, temperature=0.0)
    tllm = CudaLLM(config=tcfg, params=tdec.decoder_state_from_flax(jax.tree.map(np.asarray, params)),
                   max_new_tokens=16, temperature=0.0, device="cpu")
    jfake, tfake = jservice._llm, tservice._llm
    jservice._llm, tservice._llm = jllm, tllm
    before = _process_counters(jmetrics), _process_counters(tmetrics)
    try:
        bodies = [{"question": q, "top_pages": 3} for q in questions]  # another cache key than the fake answers
        with ThreadPoolExecutor(max_workers=4) as pool:
            pairs = list(pool.map(lambda b: _both(servers, "POST", "/query", b), bodies))
    finally:
        jservice._llm, tservice._llm = jfake, tfake
        tllm.close()
        monkeypatch.delenv("LLM_CONTINUOUS_SLOTS")
        jconfig.reset_config()
        tconfig.reset_config()
    for want, got in pairs:
        _same_query_answer(got, want)
    after = _process_counters(jmetrics), _process_counters(tmetrics)
    jdelta, tdelta = ({k: a[k] - b[k] for k in WAVE_KEYS} for a, b in zip(after, before))
    assert tdelta == jdelta and tdelta["llm_wave_requests"] == len(bodies) and tdelta["llm_wave_tokens"] > 0

    want, got = _both(servers, "GET", "/metrics")
    assert set(got) == set(want) and "process" in got
    for key in ("counters", "corpus", "query_cache"):
        assert got[key] == want[key], key
    assert {k: v["count"] for k, v in got["latency_s"].items()} == {k: v["count"] for k, v in want["latency_s"].items()}
    assert got["batcher"]["requests_served"] == want["batcher"]["requests_served"]
    n_agent = len(agent_questions())
    assert got["counters"]["agent_requests"] == n_agent and got["latency_s"]["agent.query"]["count"] == n_agent
    assert got["counters"]["query_requests"] == len(questions) + 1 + len(bodies)
    assert {"llm.wave", "query.generate", "query.retrieve"} <= set(got["process"]["latency_s"]) | \
        set(got["latency_s"])

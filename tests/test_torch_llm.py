"""The port's in-process LLM provider and LLM factory against the JAX
package's: ``CudaLLM(device="cpu")`` and ``TPULLM`` over the same tiny
decoder weights encode prompts alike and answer alike at temperature 0;
the HF checkpoint loader; the factory's choices and its refusals."""

from __future__ import annotations

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from intool_rag_tpu.models import decoder as jdec
from intool_rag_tpu_torch.models import decoder as tdec

torch.set_num_threads(2)
# the tiny test config with room for the byte tokenizer's ids and for prompts of 100+ bytes
JCFG = dataclasses.replace(jdec.DecoderConfig.tiny(), vocab_size=260, max_position=256)
TCFG = dataclasses.replace(tdec.DecoderConfig.tiny(), vocab_size=260, max_position=256)
PROMPTS = [
    "Context:\n[Page 1]\nThe warranty covers two years.\n\nQuestion: How long is the warranty?\n\nAnswer:",
    "short",
    "x" * 300 + " a prompt whose tail is kept",
]


@pytest.fixture
def env(monkeypatch):
    from intool_rag_tpu import config as jconfig
    from intool_rag_tpu_torch import config as tconfig
    from intool_rag_tpu_torch.llm import factory

    for name in ("LLM_PROVIDER", "GEMINI_API_KEY", "LLM_MODEL_PATH", "LLM_CONTINUOUS_SLOTS",
                 "LLM_SPECULATIVE_GAMMA"):
        monkeypatch.delenv(name, raising=False)

    def reset():
        jconfig.reset_config()
        tconfig.reset_config()
        factory.reset_llm()

    reset()
    yield reset
    reset()


@pytest.fixture(scope="module")
def pair():
    """(TPULLM, CudaLLM on the CPU) over the same weights, temperature 0."""
    from intool_rag_tpu.providers.tpu_llm import TPULLM
    from intool_rag_tpu_torch.providers.cuda_llm import CudaLLM

    params = jdec.init_decoder_params(JCFG, seed=1)
    state = tdec.decoder_state_from_flax(jax.tree.map(np.asarray, params))
    return (TPULLM(config=JCFG, params=params, max_new_tokens=24, temperature=0.0),
            CudaLLM(config=TCFG, params=state, max_new_tokens=24, temperature=0.0, device="cpu"))


def test_encode_prompt_equal(pair):
    jllm, tllm = pair
    for prompt in PROMPTS:
        want, got = jllm._encode_prompt(prompt), tllm._encode_prompt(prompt)
        for w, g in zip(want, got):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    ids, mask = tllm._encode_prompt(PROMPTS[2])
    assert ids.shape == (1, 256) and mask.sum() == 256 - 24  # the tail within the position budget


def test_generate_text_equal_at_temperature_zero(pair):
    jllm, tllm = pair
    for prompt in PROMPTS:
        assert tllm.generate(prompt) == jllm.generate(prompt)


def test_generate_stream_chunks(pair):
    _, tllm = pair
    text = tllm.generate(PROMPTS[0])
    chunks = list(tllm.generate_stream(PROMPTS[0]))
    assert "".join(chunks) == text
    assert all(len(c) <= 32 for c in chunks) and all(len(c) == 32 for c in chunks[:-1])
    info = tllm.get_info()
    assert info["provider"] == "CudaLLM" and info["layers"] == TCFG.num_layers and tllm.is_ready()


def test_sampling_seed_is_stable_and_sampled_text_repeats(env):
    from intool_rag_tpu_torch.providers.cuda_llm import CudaLLM, prompt_seed

    assert prompt_seed("abc") == prompt_seed("abc") != prompt_seed("abd")
    llm = CudaLLM(config=TCFG, max_new_tokens=16, temperature=1.0, device="cpu")
    assert llm.generate(PROMPTS[0]) == llm.generate(PROMPTS[0])


def test_byte_tokenizer_roundtrip_and_clamp():
    from intool_rag_tpu.providers.tpu_llm import ByteTokenizer as JByte
    from intool_rag_tpu.providers.tpu_llm import _bucket as jbucket
    from intool_rag_tpu_torch.providers.cuda_llm import _BUCKETS, ByteTokenizer, _bucket

    tok = ByteTokenizer()
    for text in ("plain", "€uro ünïcode"):
        assert tok.encode(text) == JByte().encode(text)
        assert tok.decode(tok.encode(text)) == text
    assert tok.decode([300, 40, 0, 2, 31999]) == JByte().decode([300, 40, 0, 2, 31999])
    for n in (1, 64, 65, 2048, 5000):
        assert _bucket(n, _BUCKETS) == jbucket(n)
    assert [_bucket(n, _BUCKETS) for n in (1, 65, 5000)] == [64, 128, 2048]


def test_default_model_without_a_path(env):
    from intool_rag_tpu_torch.providers.cuda_llm import ByteTokenizer, CudaLLM

    llm = CudaLLM(device="cpu", max_new_tokens=4)
    assert llm.config.vocab_size == ByteTokenizer.vocab_size + 1 and llm.config.dtype == "float32"
    assert isinstance(llm.generate("hello"), str)


@pytest.mark.parametrize("var", ["LLM_CONTINUOUS_SLOTS", "LLM_SPECULATIVE_GAMMA"])
def test_slots_or_gamma_generate_like_the_static_path_and_jax(env, monkeypatch, var):
    """``LLM_CONTINUOUS_SLOTS`` (the wave server over the continuous-batching
    scheduler) or ``LLM_SPECULATIVE_GAMMA`` (single-stream prompt-lookup
    speculation) at 4, temperature 0: the same text as ``TPULLM`` with the
    same setting, and as the static path wherever the wave server's prompt
    cap (128 tokens at 1,024 positions) keeps the whole prompt. With
    sampling the wave server's text repeats (each wave draws from seed 0)."""
    from intool_rag_tpu.providers.tpu_llm import TPULLM
    from intool_rag_tpu_torch.providers.cuda_llm import CudaLLM

    jcfg, tcfg = dataclasses.replace(JCFG, max_position=1024), dataclasses.replace(TCFG, max_position=1024)
    params = jdec.init_decoder_params(jcfg, seed=1)
    state = tdec.decoder_state_from_flax(jax.tree.map(np.asarray, params))
    greedy = dict(max_new_tokens=24, temperature=0.0)
    static = CudaLLM(config=tcfg, params=state, device="cpu", **greedy)
    monkeypatch.setenv(var, "4")
    env()
    jllm = TPULLM(config=jcfg, params=params, **greedy)
    tllm = CudaLLM(config=tcfg, params=state, device="cpu", **greedy)
    try:
        assert (tllm._waves is not None) == (var == "LLM_CONTINUOUS_SLOTS")
        for prompt in PROMPTS:
            got = tllm.generate(prompt)
            assert got == jllm.generate(prompt)
            if len(prompt.encode()) < 128:
                assert got == static.generate(prompt)
    finally:
        tllm.close()
    if var == "LLM_CONTINUOUS_SLOTS":
        sampled = CudaLLM(config=tcfg, params=state, device="cpu", max_new_tokens=16, temperature=0.3)
        try:
            assert sampled._waves.gen.gamma == 0 and sampled._waves.gen.temperature == 0.3
            assert sampled.generate(PROMPTS[0]) == sampled.generate(PROMPTS[0])
        finally:
            sampled.close()


def test_hf_checkpoint_loads_like_jax(env, monkeypatch, tmp_path):
    """``LLM_MODEL_PATH`` at a local directory holding a tiny
    ``LlamaForCausalLM`` (safetensors) and a WordPiece tokenizer: both
    providers load the same config, the same bf16 weights bit for bit and
    the same tokenizer. Greedy text is compared in f32: in bf16 a last-bit
    difference (``test_torch_decoder.py``) flips near-ties of this random
    model's argmax."""
    pytest.importorskip("transformers")
    from test_torch_tokenizer import build_wordpiece
    from transformers import LlamaConfig, LlamaForCausalLM

    from intool_rag_tpu.providers.tpu_llm import TPULLM
    from intool_rag_tpu_torch.providers.cuda_llm import CudaLLM

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    path = build_wordpiece(tmp_path / "llama", vocab_size=120)
    torch.manual_seed(0)
    LlamaForCausalLM(LlamaConfig(
        vocab_size=128, hidden_size=64, num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        intermediate_size=128, max_position_embeddings=256, tie_word_embeddings=False,
    )).save_pretrained(str(path), safe_serialization=True)
    assert json.loads((path / "config.json").read_text())["num_hidden_layers"] == 2
    monkeypatch.setenv("LLM_MODEL_PATH", str(path))
    monkeypatch.setenv("LLM_TEMPERATURE", "0")
    monkeypatch.setenv("LLM_MAX_TOKENS", "12")
    env()
    tllm = CudaLLM(device="cpu")
    assert (tllm.config.num_layers, tllm.config.vocab_size, tllm.config.dtype) == (2, 128, "bfloat16")
    assert tllm.model.lm_head.weight.dtype == torch.bfloat16
    jconfig, jparams, jtok = TPULLM._load_hf(str(path))
    assert dataclasses.asdict(tllm.config) == dataclasses.asdict(jconfig)
    want = tdec.decoder_state_from_flax(jax.tree.map(np.asarray, jdec.cast_params_for_inference(jconfig, jparams)))
    got = tllm.model.state_dict()
    assert set(got) == set(want) and all(torch.equal(got[k].float(), want[k]) for k in want)
    f32 = dict(max_new_tokens=12, temperature=0.0)
    jllm = TPULLM(config=dataclasses.replace(jconfig, dtype="float32"), params=jparams, tokenizer=jtok, **f32)
    tllm = CudaLLM(config=dataclasses.replace(tllm.config, dtype="float32"),
                   params=tdec.decoder_state_from_flax(jax.tree.map(np.asarray, jparams)),
                   tokenizer=tllm.tokenizer, device="cpu", **f32)
    for prompt in ("the warranty covers parts", "invoices are due within thirty days"):
        np.testing.assert_array_equal(tllm._encode_prompt(prompt)[0], jllm._encode_prompt(prompt)[0])
        assert tllm.generate(prompt) == jllm.generate(prompt)


def test_factory_choices(env, monkeypatch):
    from intool_rag_tpu_torch.llm.factory import get_llm
    from intool_rag_tpu_torch.providers import http_utils
    from intool_rag_tpu_torch.providers.fake import FakeLLM
    from intool_rag_tpu_torch.providers.gemini import GeminiLLM

    calls = []

    def unreachable(method, url, body=None, *, timeout=None):
        from intool_rag_tpu_torch.exceptions import ProviderConnectionError

        calls.append(url)
        raise ProviderConnectionError(f"{url}: refused")

    monkeypatch.setattr(http_utils, "transport", unreachable)
    monkeypatch.setenv("LLM_PROVIDER", "fake")
    env()
    assert isinstance(get_llm(), FakeLLM) and get_llm() is get_llm() and not calls
    for choice in ("", "ollama"):  # Ollama does not answer: the fake LLM serves
        monkeypatch.setenv("LLM_PROVIDER", choice)
        env()
        assert isinstance(get_llm(), FakeLLM)
    assert calls and all(u.endswith("/api/tags") for u in calls)
    monkeypatch.setenv("LLM_PROVIDER", "")
    monkeypatch.setenv("GEMINI_API_KEY", "k")
    env()
    assert isinstance(get_llm(), GeminiLLM)


@pytest.mark.parametrize("choice", ["cuda", "tpu"])
def test_factory_decoder_choice_raises_without_cuda(env, monkeypatch, choice):
    from intool_rag_tpu_torch.llm.factory import get_llm
    from intool_rag_tpu_torch.providers.cuda_llm import CudaLLM

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.setenv("LLM_PROVIDER", choice)
    env()
    with pytest.raises(RuntimeError, match="CUDA"):
        get_llm()
    assert isinstance(get_llm("cpu"), CudaLLM)


class _Gen:
    """A stand-in scheduler for the wave server: echoes, raises, or kills its worker."""

    segment_advance = 16

    def __init__(self, fail: BaseException | None = None) -> None:
        self.fail = fail
        self.waves: list[int] = []

    def generate_many(self, prompts, limits):
        if self.fail is not None:
            raise self.fail
        self.waves.append(len(prompts))
        return [list(p)[: n] for p, n in zip(prompts, limits)], {"total_tokens": sum(limits), "compactions": 0}


def test_wave_server_serves_waves_and_surfaces_failures():
    """Concurrent submits are served in waves with their own results; a
    wave's exception reaches every waiter and the server keeps serving; a
    worker that dies fails every later submit at once."""
    from concurrent.futures import ThreadPoolExecutor

    from intool_rag_tpu_torch.observability import get_metrics
    from intool_rag_tpu_torch.providers.cuda_llm import _WaveServer

    gen = _Gen()
    server = _WaveServer(gen)
    before = get_metrics().snapshot()["counters"].get("llm_wave_requests", 0)
    with ThreadPoolExecutor(max_workers=6) as pool:
        got = list(pool.map(lambda i: server.submit([i, i + 1, i + 2], 2), range(6)))
    assert got == [[i, i + 1] for i in range(6)] and sum(gen.waves) == 6
    assert get_metrics().snapshot()["counters"]["llm_wave_requests"] == before + 6
    gen.fail = ValueError("the card fell over")
    with pytest.raises(ValueError, match="fell over"):
        server.submit([1], 1)
    gen.fail = None
    assert server.submit([5, 6], 1) == [5]
    server.close()

    dying = _WaveServer(_Gen(fail=SystemExit("worker gone")))
    with pytest.raises(RuntimeError, match="died|dead"):
        dying.submit([1], 1)
    with pytest.raises(RuntimeError, match="dead"):
        dying.submit([1], 1)

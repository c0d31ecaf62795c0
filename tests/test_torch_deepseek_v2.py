"""The port's DeepSeek-V2 decoder (``models/deepseek_v2.py``) against the
plain float32 reference (``tests/torch_reference/deepseek_v2.py``) on seeded
weights, at a tiny float32 size on the CPU: hidden 64, 4 heads, latent 32,
rope 16 + nope 32, v 32, 8 experts top-3 plus 2 shared, 3 layers (1 dense,
2 expert), YaRN ×4 over 32 original positions, prompts past 32 positions.
Also the provider, the scheduler and the service over it.

Tolerances: 1e-4 in logits between the port and the reference (float32
both; the orders of summation differ: batched, blocked and cached products
against one sequence's full forward), 1e-5 between the port's two
attention forms (the same products, absorbed or not)."""

from __future__ import annotations

import copy
import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from intool_rag_tpu_torch.models import deepseek_v2 as ds
from intool_rag_tpu_torch.models.decoder import generate
from intool_rag_tpu_torch.models.scheduler import ContinuousGenerator

torch.set_num_threads(2)
_spec = importlib.util.spec_from_file_location(
    "torch_reference_deepseek_v2", Path(__file__).parent / "torch_reference" / "deepseek_v2.py")
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

CFG = ds.DeepseekV2Config.tiny()
SEED = 3_000_000_017
LOGIT_TOL = 1e-4


def hf_config(c: ds.DeepseekV2Config) -> dict:
    """``c`` as the keys of an HF ``deepseek_v2`` ``config.json``."""
    return {
        "model_type": "deepseek_v2", "vocab_size": c.vocab_size, "hidden_size": c.hidden_size,
        "num_hidden_layers": c.num_layers, "num_attention_heads": c.num_heads, "num_key_value_heads": c.num_heads,
        "kv_lora_rank": c.kv_lora_rank, "q_lora_rank": None, "qk_nope_head_dim": c.qk_nope_head_dim,
        "qk_rope_head_dim": c.qk_rope_head_dim, "v_head_dim": c.v_head_dim, "intermediate_size": c.intermediate_size,
        "moe_intermediate_size": c.moe_intermediate_size, "n_routed_experts": c.n_routed_experts,
        "n_shared_experts": c.n_shared_experts, "num_experts_per_tok": c.num_experts_per_tok,
        "first_k_dense_replace": c.first_k_dense_replace, "routed_scaling_factor": c.routed_scaling_factor,
        "moe_layer_freq": 1, "topk_method": "greedy", "scoring_func": "softmax", "norm_topk_prob": False,
        "n_group": 1, "topk_group": 1, "rope_theta": c.rope_theta, "rms_norm_eps": c.rms_norm_eps,
        "max_position_embeddings": c.max_position, "tie_word_embeddings": False, "hidden_act": "silu",
        "rope_scaling": {"type": "yarn", "factor": c.rope_factor,
                         "original_max_position_embeddings": c.rope_original_max_position,
                         "beta_fast": c.rope_beta_fast, "beta_slow": c.rope_beta_slow, "mscale": c.rope_mscale,
                         "mscale_all_dim": c.rope_mscale_all_dim},
    }


@pytest.fixture(scope="module")
def model():
    return ds.DeepseekV2LM(CFG, device="cpu").init_random(SEED).eval()


@pytest.fixture(scope="module")
def weight():
    return ref.redraw(hf_config(CFG), SEED, "cpu", dtype=torch.float32)


def _prompts(lengths, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(3, CFG.vocab_size, (n,), generator=g).tolist() for n in lengths]


def _ref_logits(weight, seq: list[int], start: int) -> torch.Tensor:
    return ref.forward(hf_config(CFG), weight, [torch.tensor(seq)], logits_from=[start])["logits"][0]


def _left_padded(prompts):
    s = max(len(p) for p in prompts)
    ids = torch.zeros((len(prompts), s), dtype=torch.long)
    mask = torch.zeros((len(prompts), s), dtype=torch.long)
    for i, p in enumerate(prompts):
        ids[i, s - len(p):] = torch.tensor(p)
        mask[i, s - len(p):] = 1
    return ids, mask


def test_yarn_constants_at_the_published_sizes():
    lite = ds.DeepseekV2Config.lite()
    assert ds.yarn_range(lite) == (10, 23)
    assert ds.yarn_mscale(40.0, 0.707) == pytest.approx(1.2608038, abs=5e-8)
    assert ds.softmax_scale(lite) == pytest.approx(0.1147214, abs=5e-8)
    hf = hf_config(lite)
    assert ref.yarn_range(hf) == (10, 23) and ref.softmax_scale(hf) == pytest.approx(ds.softmax_scale(lite), rel=1e-12)
    ramp = ((torch.arange(32.0) - 10) / 13).clamp(0, 1)
    extra = 1e4 ** (-torch.arange(0, 64, 2, dtype=torch.float32) / 64)
    torch.testing.assert_close(ds.yarn_inv_freq(lite), extra / 40 * ramp + extra * (1 - ramp), rtol=1e-6, atol=0)
    positions = torch.tensor([[0, 1, 31, 4095, 4096, 8191]])
    cos, sin = ds.rope_tables(positions, lite)
    want_cos, want_sin = ref.rope_cos_sin(hf, 8192, "cpu")
    torch.testing.assert_close(cos[0], want_cos[positions[0]], rtol=0, atol=2e-5)
    torch.testing.assert_close(sin[0], want_sin[positions[0]], rtol=0, atol=2e-5)


@torch.no_grad()
def test_prefill_then_generate_match_the_reference_forward(model, weight):
    """A left-padded batch of two prompts past the 32 original positions:
    the prefill's logits at every real position, then each decode step's
    (teacher-forced on ``generate``'s own tokens), against the reference's
    full forward over prompt and tokens."""
    prompts = _prompts([45, 38])
    ids, mask = _left_padded(prompts)
    new = 6
    out = generate(model, ids, mask, max_new_tokens=new)
    cache = model.init_cache(2)
    positions = torch.clamp(torch.cumsum(mask, 1) - 1, min=0)
    logits = [model(ids, positions, cache, mask.bool())]
    pos = positions[:, -1] + 1
    for t in range(new - 1):
        logits.append(model(out[:, t:t + 1], (pos + t)[:, None], cache))
    for i, p in enumerate(prompts):
        want = _ref_logits(weight, p + out[i].tolist(), 0)
        got = torch.cat([logits[0][i, ids.shape[1] - len(p):], *(lg[i] for lg in logits[1:])])
        torch.testing.assert_close(got, want[: len(p) + new - 1], rtol=0, atol=LOGIT_TOL)
        assert out[i].tolist() == want[len(p) - 1 : len(p) - 1 + new].argmax(-1).tolist()


def test_continuous_generator_refill_and_compaction_match_the_reference(model, weight):
    """One slot, so every logit row the scheduler samples belongs to the
    stream in the slot: each refill's first row, then its stream's
    ``budget - 1`` decode rows. A 128-position cache forces a compaction."""
    gen = ContinuousGenerator(model, n_slots=1, seg_len=16)
    rows: list[tuple[str, torch.Tensor]] = []
    sample, insert = gen._sample, gen._insert

    def recording_sample(logits):
        rows.append((gen.phase, logits.clone()))
        return sample(logits)

    def recording_insert(*args):
        gen.phase = "refill"
        try:
            return insert(*args)
        finally:
            gen.phase = "decode"

    gen.phase = "decode"
    gen._sample, gen._insert = recording_sample, recording_insert
    prompts, budgets = _prompts([40, 36], seed=1), [44, 20]
    toks, stats = gen.generate_many(prompts, budgets)
    assert stats["compactions"] >= 1 and [len(t) for t in toks] == budgets
    starts = [i for i, (phase, _) in enumerate(rows) if phase == "refill"]
    assert len(starts) == 2
    for p, t, s in zip(prompts, toks, starts):
        got = torch.cat([lg for _, lg in rows[s : s + len(t)]])
        want = _ref_logits(weight, p + t, len(p) - 1)[: len(t)]
        torch.testing.assert_close(got, want, rtol=0, atol=LOGIT_TOL)
        assert t == want.argmax(-1).tolist()


def test_two_slots_stream_the_reference_tokens(model, weight):
    gen = ContinuousGenerator(model, n_slots=2, seg_len=8)
    prompts, budgets = _prompts([41, 33, 50], seed=2), [12, 5, 9]
    toks, _ = gen.generate_many(prompts, budgets)
    for p, t in zip(prompts, toks):
        assert t == _ref_logits(weight, p + t, len(p) - 1)[: len(t)].argmax(-1).tolist()


@torch.no_grad()
def test_absorbed_decode_equals_the_expanded_form(model):
    """One layer's attention over a filled cache, three one-token steps
    in each form."""
    prompt = _prompts([47], seed=3)[0]
    ids = torch.tensor([prompt])
    cache = model.init_cache(1)
    model(ids, torch.arange(len(prompt))[None], cache)
    layer = model.layers[1]
    g = torch.Generator().manual_seed(3)
    steps = [torch.randn(1, 1, CFG.hidden_size, generator=g) for _ in range(3)]
    out = {}
    for form in ("absorbed", "expanded"):
        c = copy.deepcopy(cache)
        out[form] = []
        for j, hidden in enumerate(steps):
            pos = torch.tensor([[len(prompt) + j]])
            blocked = ~ds.attention_mask(c, pos, None)[:, 0]
            parts = layer.attn.project(hidden, ds.rope_tables(pos, CFG))
            out[form].append(layer.attn.attend(*parts, blocked, c, form))
            c.length += 1
    for a, b in zip(out["absorbed"], out["expanded"]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@torch.no_grad()
def test_prefill_in_row_chunks_and_query_blocks_equals_one_call(model):
    """``prefill`` runs 64 tokens of rows at a time here (``tiny``'s
    ``prefill_chunk_tokens``) and the expanded attention in query blocks;
    both give one whole call's last logits and cache."""
    prompts = _prompts([40, 30, 33], seed=4)
    ids, mask = _left_padded(prompts)
    positions = torch.clamp(torch.cumsum(mask, 1) - 1, min=0)
    whole = model.init_cache(3)
    want = model(ids, positions, whole, mask.bool())[:, -1]
    chunked = model.init_cache(3)
    got = model.prefill(ids, positions, chunked, mask.bool())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert chunked.length == whole.length == ids.shape[1]
    assert torch.equal(chunked.valid, whole.valid)
    torch.testing.assert_close(chunked.kv, whole.kv, rtol=0, atol=1e-6)
    q, k, v = (torch.randn(2, 9, 3, d) for d in (8, 8, 5))
    blocked = ~torch.ones(2, 1, 9, 9, dtype=torch.bool).tril()
    torch.testing.assert_close(ds._causal_attention(q, k, v, blocked, 0.3, block=2 * 3 * 9),
                               ds._causal_attention(q, k, v, blocked, 0.3), rtol=0, atol=1e-6)


@pytest.mark.parametrize("capacity", [None, "tokens"])
def test_grouped_experts_equal_a_per_expert_loop(capacity):
    g = torch.Generator().manual_seed(5)
    t, h, width, e, k = 11, 16, 12, 6, 3
    x = torch.randn(t, h, generator=g)
    w_gu = torch.randn(e, 2 * width, h, generator=g) / 4
    w_down = torch.randn(e, h, width, generator=g) / 4
    idx = torch.stack([torch.randperm(e - 1, generator=g)[:k] for _ in range(t)])  # expert e - 1 gets no token
    weights = torch.softmax(torch.randn(t, k, generator=g), -1)
    y, counts = ds.grouped_experts(x, weights, idx, w_gu, w_down, t if capacity else None)
    want = torch.zeros(t, h)
    for j in range(e):
        rows, pick = (idx == j).nonzero(as_tuple=True)
        gate, up = (x[rows] @ w_gu[j].T).chunk(2, -1)
        want.index_add_(0, rows, (torch.nn.functional.silu(gate) * up) @ w_down[j].T * weights[rows, pick, None])
    torch.testing.assert_close(y, want, rtol=0, atol=1e-5)
    assert counts.tolist() == torch.bincount(idx.reshape(-1), minlength=e).tolist() and counts[-1] == 0


def test_hf_named_state_dict_loads_through_the_new_loader(model, weight):
    hf = {name: weight(name) for name in ref.hf_shapes(hf_config(CFG))}
    hf["model.layers.0.self_attn.rotary_emb.inv_freq"] = torch.zeros(8)  # a buffer HF checkpoints may carry
    state = ds.load_hf_deepseek_v2(CFG, hf)
    want = model.state_dict()
    assert set(state) == set(want) and all(torch.equal(state[k], want[k]) for k in want)
    del hf["lm_head.weight"]
    with pytest.raises(KeyError, match="lm_head"):
        ds.load_hf_deepseek_v2(CFG, hf)


def test_config_from_hf_refuses_what_it_does_not_compute():
    hf = hf_config(ds.DeepseekV2Config.lite())
    assert ds.DeepseekV2Config.from_hf(dict(hf, max_position_embeddings=163840)) == ds.DeepseekV2Config.lite()
    for key, value in (("q_lora_rank", 1536), ("topk_method", "group_limited_greedy"), ("norm_topk_prob", True),
                       ("scoring_func", "sigmoid")):
        with pytest.raises(ValueError, match=key):
            ds.DeepseekV2Config.from_hf(dict(hf, **{key: value}))


def test_tensor_parallel_refuses_deepseek():
    from intool_rag_tpu_torch.parallel.mesh import Mesh
    from intool_rag_tpu_torch.parallel.tp_decoder import validate_tp

    with pytest.raises(ValueError, match="Llama-family decoder only; DeepseekV2Config"):
        validate_tp(CFG, Mesh(["cpu"] * 2, ("model",)))


def test_scheduler_and_expert_counters(model):
    from intool_rag_tpu_torch.observability import get_metrics

    model.flush_counters()  # the tally of earlier direct calls on this module's model
    before = get_metrics().snapshot()["counters"]
    gen = ContinuousGenerator(model, n_slots=2, seg_len=4)
    toks, _ = gen.generate_many(_prompts([20, 9, 14], seed=6), [6, 3, 5])
    after = get_metrics().snapshot()["counters"]
    d = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    assert d["llm.decode_tokens"] == sum(len(t) for t in toks) - 3  # the first tokens come from the prefill
    assert d["llm.slot_steps"] == 2 * d["llm.decode_steps"] and d["llm.decode_steps"] % 4 == 0
    assert d["llm.prefill_tokens"] == 20 + 9 + 14 and d["llm.prefill_slots"] >= 32 + 16 + 16
    moe_layers = CFG.num_layers - CFG.first_k_dense_replace
    calls = d["moe.calls"]
    assert calls % moe_layers == 0 and d["moe.decode_calls"] == moe_layers * d["llm.decode_steps"]
    # real tokens' pairs only: no bucket padding, no idle slot
    k = CFG.num_experts_per_tok
    assert d["moe.decode_assignments"] == k * moe_layers * d["llm.decode_tokens"]
    assert d["moe.assignments"] - d["moe.decode_assignments"] == k * moe_layers * d["llm.prefill_tokens"]
    assert d["moe.decode_assignments"] < 2 * k * d["moe.decode_calls"]  # a slot idles at the end
    assert 0 < d["moe.experts_touched"] <= CFG.n_routed_experts * calls
    assert d["moe.expert_tokens_max"] * CFG.n_routed_experts >= d["moe.assignments"]
    assert model.moe_tally.device.sum() == 0 and model.moe_tally.calls == [0, 0]


@pytest.fixture
def env(monkeypatch, tmp_path):
    from intool_rag_tpu_torch import config
    from intool_rag_tpu_torch.llm import factory

    for name in ("LLM_PROVIDER", "GEMINI_API_KEY", "LLM_MODEL_PATH", "LLM_CONTINUOUS_SLOTS", "LLM_SPECULATIVE_GAMMA"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("STORAGE_DIR", str(tmp_path / "storage"))
    monkeypatch.setenv("CACHE_DIR", str(tmp_path / "cache"))

    def reset():
        config.reset_config()
        factory.reset_llm()

    reset()
    yield reset
    monkeypatch.undo()  # the settings go first: a config cached with them would outlive the test
    reset()


def test_provider_dispatches_on_model_type(env, monkeypatch, tmp_path, weight):
    pytest.importorskip("transformers")
    from safetensors.torch import save_file
    from test_torch_tokenizer import build_wordpiece

    from intool_rag_tpu_torch.providers.cuda_llm import CudaLLM

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    path = build_wordpiece(tmp_path / "dsv2", vocab_size=120)
    (path / "config.json").write_text(json.dumps(dict(hf_config(CFG), model_type="mistral")))
    monkeypatch.setenv("LLM_MODEL_PATH", str(path))
    env()
    with pytest.raises(ValueError, match="'mistral' is not served"):
        CudaLLM(device="cpu")
    (path / "config.json").write_text(json.dumps(dict(hf_config(CFG), max_position_embeddings=163840)))
    save_file({k: weight(k).contiguous() for k in ref.hf_shapes(hf_config(CFG))}, str(path / "model.safetensors"))
    env()
    llm = CudaLLM(device="cpu", max_new_tokens=4)
    assert isinstance(llm.model, ds.DeepseekV2LM) and llm._buckets == ds.DeepseekV2Config.prompt_buckets
    assert llm.config == dataclasses.replace(CFG, dtype="bfloat16", max_position=8192, prefill_chunk_tokens=16_384)
    got = {k: v.float() for k, v in llm.model.state_dict().items()}
    want = ds.DeepseekV2LM(CFG, device="cpu").init_random(SEED).state_dict()
    assert all(torch.equal(got[k], want[k].bfloat16().float()) for k in want)
    ids, mask = llm._encode_prompt("word " * 6000)  # past the Llama buckets' 2,048
    assert ids.shape == (1, 8192) and mask.sum() > 4096


def test_query_answers_through_a_tiny_deepseek_wave_server(env, monkeypatch):
    """``POST /query`` over an ingested text document, answered by a tiny
    DeepSeek-V2 ``CudaLLM`` behind the wave server (``LLM_CONTINUOUS_SLOTS``)."""
    from test_torch_agent import _multipart

    from intool_rag_tpu_torch.llm.semantic import factory as semantic
    from intool_rag_tpu_torch.observability import get_metrics
    from intool_rag_tpu_torch.providers.cuda_llm import ByteTokenizer, CudaLLM
    from intool_rag_tpu_torch.providers.hash_embed import HashEmbeddingProvider
    from intool_rag_tpu_torch.service.app import RAGService

    for key, val in {"LLM_CONTINUOUS_SLOTS": "2", "LLM_TEMPERATURE": "0", "RERANKER_ENABLED": "0",
                     "OCR_ENABLED": "0", "INDEX_DTYPE": "float32", "SHARDED_SEARCH": "off"}.items():
        monkeypatch.setenv(key, val)
    env()
    semantic.reset_semantic_analyzer()
    cfg = dataclasses.replace(CFG, vocab_size=ByteTokenizer.vocab_size + 1, max_position=256)
    llm = CudaLLM(config=cfg, device="cpu", max_new_tokens=8, seed=SEED)
    try:
        assert llm._waves is not None and isinstance(llm.model, ds.DeepseekV2LM)
        service = RAGService(HashEmbeddingProvider(dimension=32), device="cpu", llm=llm)
        text = "The warranty covers parts and labour for two years from the date of purchase."
        body, ctype = _multipart([("file", "warranty.txt", text.encode())])
        assert service.handle("POST", "/ingest?project=p&doc_id=warranty", body, ctype)[0] == 200
        waves = get_metrics().snapshot()["counters"].get("llm_waves", 0)
        status, out = service.handle("POST", "/query", b'{"question": "how long does the warranty cover parts?"}')
        assert status == 200 and out["sources"] and isinstance(out["answer"], str)
        assert get_metrics().snapshot()["counters"]["llm_waves"] == waves + 1
        prompt = "Context: two years. Question: how long? Answer:"  # under the wave server's 64-token cap
        ids, _ = llm._waves.gen.generate_many([ByteTokenizer().encode(prompt)], 8)
        assert llm.generate(prompt) == ByteTokenizer().decode(ids[0])
    finally:
        llm.close()
        semantic.reset_semantic_analyzer()


def _one_token_steps(model, steps: int, grad: bool, feed: torch.Tensor | None = None):
    """Logits of ``steps`` one-token calls after a prefill, with grad mode
    on (the layers' own path) or off (the step in parts), and the tokens
    fed: each call's argmax, or the columns of ``feed [2, steps]``."""
    prompts = _prompts([37, 44], seed=7)
    ids, mask = (t.to(model.embed.weight.device) for t in _left_padded(prompts))
    positions = torch.clamp(torch.cumsum(mask, 1) - 1, min=0)
    with torch.no_grad():
        cache = model.init_cache(2)
        tok = model.prefill(ids, positions, cache, mask.bool()).argmax(-1)
    out, fed = [], []
    with torch.set_grad_enabled(grad):
        for j in range(steps):
            tok = tok if feed is None else feed[:, j]
            fed.append(tok)
            logits = model(tok[:, None], positions[:, -1:] + 1 + j, cache)
            out.append(logits.detach())
            tok = logits[:, 0].argmax(-1)
    return torch.cat(out, 1), cache, torch.stack(fed, 1)


def test_one_token_steps_in_parts_equal_the_layers(model):
    """``_DecodeSteps`` (the parts a CUDA graph each on the card, run as is
    here) gives the layers' own one-token forward, logits and cache."""
    want, want_cache, _ = _one_token_steps(model, 4, grad=True)
    got, got_cache, _ = _one_token_steps(model, 4, grad=False)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    torch.testing.assert_close(got_cache.kv, want_cache.kv, rtol=0, atol=1e-6)


def test_one_token_graphs_equal_the_eager_step_on_card():
    """On the card the parts are CUDA graphs of the fused kernels
    (``ops/deepseek_decode.py``), at the attention widths the MLA kernel
    takes (16 heads, rank 512, rope 64); they give the eager step's logits
    and cache to bf16 rounding (the kernels keep the attention's scores in
    f32, round its weights to bf16 before normalising them, and sum in
    another order): the prefill's entries equal, the decoded ones and the
    logits within a few of bf16's 2^-8 relative steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU form")
    cfg = dataclasses.replace(CFG, dtype="bfloat16", num_heads=16, kv_lora_rank=512, qk_rope_head_dim=64)
    card = ds.DeepseekV2LM(cfg, device="cuda").init_random(SEED).eval()
    want, want_cache, fed = _one_token_steps(card, 4, grad=True)
    got, got_cache, _ = _one_token_steps(card, 4, grad=False, feed=fed)  # the same tokens: no argmax near a tie

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    prompt = 44  # the longer prompt: positions before it hold the prefill's entries alone
    assert torch.equal(got_cache.kv[:, :, :prompt], want_cache.kv[:, :, :prompt])
    assert rel(got_cache.kv, want_cache.kv) < 2e-2 and rel(got, want) < 2e-2


@torch.no_grad()
def test_decode_attends_from_the_first_real_position(model):
    """A refill tells the latent cache where its earliest real token lies;
    one-token calls attend from there, and read what they read from 0."""
    prompts = _prompts([40, 30], seed=8)
    ids, mask = _left_padded(prompts)  # bucket 40: the 30-token prompt padded on the left
    positions = torch.clamp(torch.cumsum(mask, 1) - 1, min=0)
    sub = model.init_cache(2, positions=64)
    model.prefill(torch.cat([torch.zeros(2, 24, dtype=torch.long), ids], 1),
                  torch.cat([torch.zeros(2, 24, dtype=torch.long), positions], 1), sub,
                  torch.cat([torch.zeros(2, 24, dtype=torch.bool), mask.bool()], 1))
    cache = model.init_cache(2)
    cache.length = 64
    cache.put_rows(torch.arange(2), 0, sub, first=64 - 40)
    assert cache.first == 24
    cache.put_rows(torch.tensor([1]), 0, model.init_cache(1, positions=64), first=50)
    assert cache.first == 24  # the lowest bound stays
    cache.put_rows(torch.arange(2), 0, sub, first=24)
    unbounded = copy.deepcopy(cache)
    unbounded.first = 0
    tok, pos = torch.tensor([[5], [9]]), positions[:, -1:] + 1
    torch.testing.assert_close(model(tok, pos, cache), model(tok, pos, unbounded), rtol=0, atol=1e-6)

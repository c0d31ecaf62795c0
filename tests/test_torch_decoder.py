"""The port's Llama-family decoder against the JAX ``DecoderLM``.

Weights come across through ``decoder_state_from_flax``; the same seeded
numpy inputs go through ``DecoderLM.apply`` / ``make_generate_fn`` and the
port's ``DecoderLM`` / ``generate`` on the CPU. Tolerances: logits max-abs
1e-4 in f32 (measured 2.4e-6), greedy tokens equal; bf16 within two bf16
steps of the largest logit (see ``test_bf16_logits_within_two_bf16_steps``).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intool_rag_tpu.models import decoder as jdec
from intool_rag_tpu_torch.models import decoder as tdec

torch.set_num_threads(2)
JCFG = jdec.DecoderConfig.tiny()
TCFG = tdec.DecoderConfig.tiny()
ATOL = 1e-4


@pytest.fixture(scope="module")
def jax_params():
    return jdec.init_decoder_params(JCFG, seed=3)


def _port_model(params, cfg=TCFG) -> tdec.DecoderLM:
    state = tdec.decoder_state_from_flax(jax.tree.map(lambda x: np.asarray(x, np.float32), params))
    model = tdec.DecoderLM(cfg, device="cpu").eval()
    model.load_state_dict(tdec.cast_params_for_inference(cfg, state))
    return model


def _ragged(rng, b, s, pads):
    ids = rng.integers(3, JCFG.vocab_size, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    for row, pad in enumerate(pads):
        mask[row, :pad] = 0
        ids[row, :pad] = 0
    pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)
    return ids, mask, pos


def _t(x):
    return torch.as_tensor(np.array(x)).long()


def _jax_logits(params, ids, pos, mask=None, cfg=JCFG):
    valid = None if mask is None else jnp.asarray(mask, bool)
    out, _ = jdec.DecoderLM(cfg).apply(params, jnp.asarray(ids), jnp.asarray(pos),
                                       jdec.init_cache(cfg, ids.shape[0]), valid)
    return np.asarray(out)


@torch.no_grad()
def _port_logits(model, ids, pos, mask=None):
    cache = tdec.init_cache(model.config, ids.shape[0], "cpu")
    return model(_t(ids), _t(pos), cache, None if mask is None else torch.as_tensor(mask).bool()).numpy()


def test_config_sizes_match_jax():
    for name in ("tiny", "tinyllama"):
        want, got = getattr(jdec.DecoderConfig, name)(), getattr(tdec.DecoderConfig, name)()
        assert dataclasses.asdict(want) == dataclasses.asdict(got)
    big = tdec.DecoderConfig.tinyllama()
    assert (big.num_layers, big.hidden_size, big.num_heads, big.num_kv_heads, big.intermediate_size,
            big.vocab_size, big.max_position, big.dtype) == (22, 2048, 32, 4, 5632, 32_000, 2048, "bfloat16")


def test_logits_match_jax_f32(jax_params):
    ids, mask, pos = _ragged(np.random.default_rng(0), 3, 12, [0, 4, 7])
    want = _jax_logits(jax_params, ids, pos, mask)
    got = _port_logits(_port_model(jax_params), ids, pos, mask)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_cached_decode_matches_full_forward(jax_params):
    """Prefill of 6 tokens then single-token steps: the one-shot logits,
    and the JAX package's stepwise ones (atol 1e-4)."""
    model = _port_model(jax_params)
    rng = np.random.default_rng(1)
    b, s = 2, 10
    ids = rng.integers(3, JCFG.vocab_size, (b, s)).astype(np.int32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    full = _port_logits(model, ids, pos)
    cache = tdec.init_cache(TCFG, b, "cpu")
    with torch.no_grad():
        parts = [model(_t(ids[:, :6]), _t(pos[:, :6]), cache).numpy()]
        for t in range(6, s):
            parts.append(model(_t(ids[:, t : t + 1]), _t(pos[:, t : t + 1]), cache).numpy())
    assert cache.length == s and cache.valid[:, :s].all() and not cache.valid[:, s:].any()
    stepped = np.concatenate(parts, axis=1)
    np.testing.assert_allclose(stepped, full, atol=ATOL, rtol=0)
    np.testing.assert_allclose(stepped, _jax_logits(jax_params, ids, pos), atol=ATOL, rtol=0)


def test_left_padded_prompt_matches_unpadded(jax_params):
    model = _port_model(jax_params)
    ids, mask, pos = _ragged(np.random.default_rng(2), 2, 10, [0, 3])
    padded = _port_logits(model, ids, pos, mask)
    alone = _port_logits(model, ids[1:, 3:], np.arange(7, dtype=np.int32)[None])
    assert np.isfinite(padded).all()  # pad queries see their own slot: no NaN
    np.testing.assert_allclose(padded[1, 3:], alone[0], atol=ATOL, rtol=0)


def test_cache_overflow_raises(jax_params):
    model = _port_model(jax_params)
    cache = tdec.init_cache(TCFG, 1, "cpu")
    ids = torch.zeros((1, TCFG.max_position + 1), dtype=torch.long)
    with pytest.raises(ValueError):
        model(ids, ids, cache)


@pytest.mark.parametrize("eos", [False, True])
def test_greedy_generate_equals_jax(jax_params, eos):
    """A ragged batch, greedy: the same tokens as ``make_generate_fn``. With
    ``eos`` the eos id is a token the model emits mid-sequence, so rows stop
    and pad."""
    model = _port_model(jax_params)
    ids, mask, _ = _ragged(np.random.default_rng(3), 4, 16, [0, 5, 9, 2])
    n = 24

    def both(eos_id):
        want = np.asarray(jdec.make_generate_fn(JCFG, max_new_tokens=n, eos_id=eos_id, pad_id=0)(
            jax_params, jnp.asarray(ids), jnp.asarray(mask), jax.random.PRNGKey(0)))
        got = tdec.generate(model, _t(ids), torch.as_tensor(mask), max_new_tokens=n, eos_id=eos_id,
                            pad_id=0).numpy()
        return want, got

    want, got = both(None)
    if eos:
        eos_id = int(want[0, n // 3])
        want, got = both(eos_id)
        stopped = [row for row in want if (row == eos_id).any() and np.argmax(row == eos_id) < n - 1]
        assert stopped and all((row[np.argmax(row == eos_id) + 1 :] == 0).all() for row in stopped)
    assert got.shape == (4, n)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("top_k, top_p", [(0, 1.0), (5, 1.0), (0, 0.9), (7, 0.5), (1, 1.0), (0, 0.0)])
def test_filter_logits_matches_jax(top_k, top_p):
    logits = np.random.default_rng(4).standard_normal((3, 64)).astype(np.float32) * 3
    want = np.asarray(jdec.filter_logits(jnp.asarray(logits), top_k=top_k, top_p=top_p))
    got = tdec.filter_logits(torch.as_tensor(logits), top_k=top_k, top_p=top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got[np.isfinite(got)], want[np.isfinite(want)])


def test_sampling_stays_in_the_kept_set_and_repeats_under_a_seed(jax_params):
    """Sampled draws differ from JAX's (another generator); they are held to
    their properties: every token is in ``filter_logits``' kept set, one
    seed gives one sequence."""
    logits = torch.as_tensor(np.random.default_rng(5).standard_normal((4, 64)).astype(np.float32))
    kept = torch.isfinite(tdec.filter_logits(logits, top_k=6, top_p=0.8))
    gen = torch.Generator().manual_seed(0)
    for _ in range(200):
        tok = tdec._sample(logits, 1.0, 6, 0.8, gen)
        assert kept[torch.arange(4), tok].all()
    model = _port_model(jax_params)
    ids, mask, _ = _ragged(np.random.default_rng(6), 2, 8, [0, 3])

    def run(seed):
        return tdec.generate(model, _t(ids), torch.as_tensor(mask), max_new_tokens=12, temperature=1.0,
                             top_k=20, top_p=0.95, generator=torch.Generator().manual_seed(seed)).numpy()

    np.testing.assert_array_equal(run(11), run(11))
    assert not np.array_equal(run(11), run(12))


def test_bf16_logits_within_two_bf16_steps():
    """bf16 compute (weights cast for inference in both packages): the
    activations, the lm_head output among them, are rounded to bf16 after
    each product, and XLA and torch on the CPU sum in different orders, so
    a last-bit difference reaches the logits; measured: one bf16 step (2^-5
    at |logit| ~4). Bar: two bf16 steps of the largest logit. Greedy tokens
    stay equal on this input."""
    jcfg = dataclasses.replace(JCFG, dtype="bfloat16")
    tcfg = dataclasses.replace(TCFG, dtype="bfloat16")
    params = jdec.cast_params_for_inference(jcfg, jdec.init_decoder_params(jcfg, seed=3))
    model = _port_model(params, tcfg)
    assert model.lm_head.weight.dtype == torch.bfloat16
    ids, mask, pos = _ragged(np.random.default_rng(0), 3, 12, [0, 4, 7])
    want = _jax_logits(params, ids, pos, mask, jcfg)
    got = _port_logits(model, ids, pos, mask)
    step = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= 2 * step
    jt = np.asarray(jdec.make_generate_fn(jcfg, max_new_tokens=12)(
        params, jnp.asarray(ids), jnp.asarray(mask), jax.random.PRNGKey(0)))
    tt = tdec.generate(model, _t(ids), torch.as_tensor(mask), max_new_tokens=12).numpy()
    np.testing.assert_array_equal(tt, jt)


def test_init_is_seeded_and_cast_for_inference():
    gen = torch.Generator().manual_seed(0)
    a = tdec.init_decoder_params(TCFG, gen)
    b = tdec.init_decoder_params(TCFG, torch.Generator().manual_seed(0))
    assert set(a) == set(tdec.DecoderLM(TCFG, device="cpu").state_dict())
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(a["final_ln.weight"], torch.ones(TCFG.hidden_size))
    bf = dataclasses.replace(TCFG, dtype="bfloat16")
    cast = tdec.cast_params_for_inference(bf, a)
    assert all(v.dtype == torch.bfloat16 for v in cast.values())
    assert tdec.cast_params_for_inference(TCFG, a) is a
    model = tdec.DecoderLM(TCFG, device="cpu").init_random(torch.Generator().manual_seed(0))
    assert all(torch.equal(model.state_dict()[k], a[k]) for k in a)


def test_load_hf_llama_matches_load_torch_llama():
    """One HF-named state dict, from a local ``LlamaForCausalLM`` (no hub
    files): the port's ``load_hf_llama`` and the JAX ``load_torch_llama``
    give the same logits (1e-4), and so does HF's own forward."""
    pytest.importorskip("transformers")
    from transformers import LlamaConfig, LlamaForCausalLM

    hf_cfg = LlamaConfig(
        vocab_size=JCFG.vocab_size, hidden_size=JCFG.hidden_size, num_hidden_layers=JCFG.num_layers,
        num_attention_heads=JCFG.num_heads, num_key_value_heads=JCFG.num_kv_heads,
        intermediate_size=JCFG.intermediate_size, max_position_embeddings=JCFG.max_position,
        rope_theta=JCFG.rope_theta, rms_norm_eps=JCFG.rms_norm_eps, tie_word_embeddings=False,
    )
    torch.manual_seed(0)
    hf = LlamaForCausalLM(hf_cfg).eval()
    state = hf.state_dict()
    jparams = jdec.load_torch_llama(JCFG, state)
    model = tdec.DecoderLM(TCFG, device="cpu").eval()
    model.load_state_dict(tdec.load_hf_llama(TCFG, state))
    ids = np.random.default_rng(7).integers(3, JCFG.vocab_size, (2, 9)).astype(np.int32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    got = _port_logits(model, ids, pos)
    np.testing.assert_allclose(got, _jax_logits(jparams, ids, pos), atol=ATOL, rtol=0)
    with torch.no_grad():
        hf_logits = hf(_t(ids)).logits.numpy()
    np.testing.assert_allclose(got, hf_logits, atol=ATOL, rtol=0)


def _cut(toks, eos):
    toks = [int(t) for t in toks]
    return toks[: toks.index(eos)] if eos in toks else toks


@pytest.mark.parametrize("gamma", [1, 2, 4])
@pytest.mark.parametrize("case", ["repeating", "random", "eos"])
def test_lookup_speculative_equals_greedy_and_jax(jax_params, gamma, case):
    """Single-stream prompt-lookup speculation: the static greedy tokens and
    those of the JAX ``make_lookup_speculative_fn`` (f32; equal, cut at the
    first EOS as both providers do). The prompt is left-padded; "repeating"
    repeats a block so that drafts are found, "eos" stops at a token the
    greedy stream emits."""
    model = _port_model(jax_params)
    rng = np.random.default_rng(11)
    block = rng.integers(3, JCFG.vocab_size, 6)
    body = np.concatenate([block, block, block[:3]]) if case == "repeating" else rng.integers(3, JCFG.vocab_size, 15)
    ids = np.zeros((1, 24), np.int32)
    mask = np.zeros((1, 24), np.int32)
    ids[0, -len(body):], mask[0, -len(body):] = body, 1
    n = 20
    plain = tdec.generate(model, _t(ids), torch.as_tensor(mask), max_new_tokens=n)[0].tolist()
    eos = plain[5] if case == "eos" else None
    want = tdec.generate(model, _t(ids), torch.as_tensor(mask), max_new_tokens=n, eos_id=eos)[0].tolist()
    got = tdec.generate_lookup_speculative(model, _t(ids), torch.as_tensor(mask), max_new_tokens=n, gamma=gamma,
                                           eos_id=eos).tolist()
    jax_toks = np.asarray(jdec.make_lookup_speculative_fn(JCFG, max_new_tokens=n, gamma=gamma, eos_id=eos)(
        jax_params, jnp.asarray(ids), jnp.asarray(mask)))
    assert len(got) == n
    assert _cut(got, eos) == _cut(want, eos) == _cut(jax_toks, eos)
    if eos is None:
        assert got == want


def test_lookup_speculative_refuses_a_batch(jax_params):
    model = _port_model(jax_params)
    with pytest.raises(ValueError, match="single-stream"):
        tdec.generate_lookup_speculative(model, torch.ones((2, 8), dtype=torch.long), torch.ones((2, 8)),
                                         max_new_tokens=4)


def test_greedy_tokens_on_card_equal_cpu(jax_params):
    """Card-only twin: the tiny f32 model's greedy tokens on the card equal
    its tokens on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cpu = _port_model(jax_params)
    card = tdec.DecoderLM(TCFG, device="cuda").eval()
    card.load_state_dict(cpu.state_dict())
    ids, mask, _ = _ragged(np.random.default_rng(3), 4, 16, [0, 5, 9, 2])
    want = tdec.generate(cpu, _t(ids), torch.as_tensor(mask), max_new_tokens=24).numpy()
    got = tdec.generate(card, _t(ids).cuda(), torch.as_tensor(mask).cuda(), max_new_tokens=24).cpu().numpy()
    np.testing.assert_array_equal(got, want)

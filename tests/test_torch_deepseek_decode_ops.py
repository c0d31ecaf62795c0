"""The fused ops of the DeepSeek-V2 one-token step
(``intool_rag_tpu_torch/ops/deepseek_decode.py``): on the CPU, each plain
version against the model's own operations that it stands for; on the card
(skipped here: the CUDA kernels have no CPU form), each kernel against its
plain version at the published sizes; the MLA kernel's split of each
row's positions is mirrored in Python and checked here.

Tolerances: the plain versions repeat the model's operations, so they agree
bit for bit or to float32 rounding (1e-6; a sum over all experts where the
model sums over the chosen ones). On the card the kernels take the same
bf16 inputs as the plain versions and sum in another order; the MLA kernel
keeps its scores in f32 where the plain attention rounds them to bf16, and
rounds its weights to bf16 before, not after, normalising them: bf16's
relative rounding (2^-8) bounds those."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from intool_rag_tpu_torch.models import deepseek_v2 as ds
from intool_rag_tpu_torch.models.decoder import RMSNorm
from intool_rag_tpu_torch.ops import deepseek_decode as fused

CFG = ds.DeepseekV2Config.tiny()
SEED = 3_000_000_019
needs_card = pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card: the kernels have no CPU form")


def _gen(seed: int, device="cpu") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


@pytest.fixture(scope="module")
def model():
    return ds.DeepseekV2LM(CFG, device="cpu").init_random(SEED).eval()


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30))


# ---------------- the plain versions (CPU) ----------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_reference_is_the_model_norm(dtype):
    g = _gen(1)
    x, res = torch.randn(5, 64, generator=g).to(dtype), torch.randn(5, 64, generator=g).to(dtype)
    norm = RMSNorm(64, 1e-6).to(dtype)
    with torch.no_grad():
        norm.weight.copy_(torch.rand(64, generator=g) + 0.5)
        assert torch.equal(fused.rms_norm_reference(x, norm.weight, 1e-6), norm(x))
        total, normed = fused.rms_norm(x, norm.weight, 1e-6, residual=res)
    assert torch.equal(total, res + x) and torch.equal(normed, norm(res + x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@torch.no_grad()
def test_rope_latent_reference_is_the_layer_projection(model, dtype):
    """Rope queries and cache entry of one token a row, as
    ``LatentAttention.project`` forms them from the same fused product."""
    cfg = dataclasses.replace(CFG, dtype="bfloat16" if dtype == torch.bfloat16 else "float32")
    attn = model.layers[1].attn.to(dtype)
    try:
        b = 3
        hidden = torch.randn(b, 1, cfg.hidden_size, generator=_gen(2)).to(dtype)
        positions = torch.tensor([[5], [40], [77]])
        q_nope, q_pe, latent = attn.project(hidden, ds.rope_tables(positions, cfg))
        scale = ds.yarn_mscale(cfg.rope_factor, cfg.rope_mscale) / ds.yarn_mscale(cfg.rope_factor,
                                                                                  cfg.rope_mscale_all_dim)
        got_pe, got_latent = fused.mla_rope_latent(attn.qkv_a(hidden[:, 0]), positions[:, 0], ds.yarn_inv_freq(cfg),
                                                   scale, attn.kv_norm.weight, cfg.rms_norm_eps, cfg.num_heads,
                                                   cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank)
    finally:
        attn.float()
    assert torch.equal(got_pe, q_pe[:, 0]) and torch.equal(got_latent, latent[:, 0])


@torch.no_grad()
def test_mla_decode_reference_is_the_absorbed_form(model):
    """One token a row over a cache with invalid rows and a first bound:
    the absorbed form of ``LatentAttention.attend``."""
    cfg, attn = CFG, model.layers[0].attn
    b, length, first = 3, 30, 4
    g = _gen(3)
    cache = model.init_cache(b, positions=40)
    cache.kv.copy_(torch.randn(cache.kv.shape, generator=g))
    cache.valid[:, first:length] = torch.rand(b, length - first, generator=g) > 0.3
    cache.length, cache.first = length, first
    q_nope = torch.randn(b, 1, cfg.num_heads, cfg.qk_nope_head_dim, generator=g)
    q_pe = torch.randn(b, 1, cfg.num_heads, cfg.qk_rope_head_dim, generator=g)
    latent = torch.randn(b, 1, cfg.latent_dim, generator=g)
    eager = cache.rows(0, b)
    blocked = ~ds.attention_mask(eager, torch.zeros(b, 1, dtype=torch.long), None)[:, 0]
    want = attn.attend(q_nope, q_pe, latent, blocked, eager, form="absorbed")
    out = torch.zeros(b, cfg.num_heads * cfg.v_head_dim)
    q = torch.cat([q_nope, q_pe], dim=-1)[:, 0]
    attn.attend_one(q, q_pe[:, 0], latent[:, 0], cache, out)
    torch.testing.assert_close(out, want[:, 0], rtol=0, atol=1e-6)


@pytest.mark.parametrize("real", [None, [True, False, True, True]])
@torch.no_grad()
def test_moe_router_reference_gives_the_route_and_the_tally(model, real):
    mlp = model.layers[1].mlp
    x = torch.randn(4, CFG.hidden_size, generator=_gen(4))
    w, idx = mlp.route(x)
    real_t = None if real is None else torch.tensor(real)
    tally, want_tally = ds._Tally("cpu"), ds._Tally("cpu")
    gates = fused.moe_router(torch.nn.functional.linear(x.float(), mlp.gate.weight.float()), CFG.num_experts_per_tok,
                             CFG.routed_scaling_factor, real_t, tally.device, tally_rows=2)
    want_tally.add_device(idx, real_t, CFG.n_routed_experts, decode=True)
    assert torch.equal(gates, torch.zeros(4, CFG.n_routed_experts).scatter_(1, idx, w))
    assert torch.equal(tally.device, want_tally.device)


@torch.no_grad()
def test_dense_experts_equal_the_grouped_products(model):
    """The dense gates' sum over every expert equals the grouped products
    over the chosen ones, with an expert that gets no token."""
    mlp = model.layers[2].mlp
    x = torch.randn(3, CFG.hidden_size, generator=_gen(5))
    w, idx = mlp.route(x)
    gates = torch.zeros(3, CFG.n_routed_experts).scatter_(1, idx, w)
    assert (gates == 0).all(dim=0).any()
    want, _ = ds.grouped_experts(x, w, idx, mlp.w_gate_up, mlp.w_down, capacity=3)
    torch.testing.assert_close(mlp.dense_experts(x, gates), want, rtol=0, atol=1e-6)


def test_moe_combine_reference_is_a_loop_over_experts():
    g = _gen(6)
    out, gates = torch.randn(5, 3, 8, generator=g), torch.rand(3, 5, generator=g)
    gates[:, 2] = 0
    want = sum(gates[:, e, None] * out[e] for e in range(5))
    torch.testing.assert_close(fused.moe_combine(out, gates), want, rtol=0, atol=1e-6)


def test_splits_fill_the_card_and_keep_a_chunk_each():
    """The grid is ⌊SMs / rows⌋ splits a row, at most one an SM while the
    rows last, and every block of the plan gets at least one chunk."""
    assert fused.mla_decode_splits(32, 2500, 132) == 4 and fused.mla_decode_splits(1, 100, 132) == 4
    assert fused.mla_decode_splits(256, 8192, 132) == 1 and fused.mla_decode_splits(3, 20, 132) == 1
    for rows, positions in [(32, 2500), (1, 100), (3, 20), (2, 10_000), (256, 8192)]:
        plan = fused.mla_decode_plan(rows, positions, 132)
        assert len(plan) <= max(132, rows) and all(hi - lo >= 1 for _, lo, hi in plan)


@pytest.mark.parametrize("sms", [1, 7, 132, 264])
@pytest.mark.parametrize("positions", [1, 20, 32, 33, 2500, 8192])
@pytest.mark.parametrize("rows", [1, 3, 32])
def test_mla_decode_plan_covers_each_chunk_once_in_equal_runs(rows, positions, sms):
    """The kernel's partition, mirrored: every (row, chunk) in exactly one
    block, no block more than one chunk above another, each row's pieces
    contiguous and in order in the combine's range of blocks ``[row·s,
    (row + 1)·s)``."""
    chunks = -(-positions // fused.MLA_CHUNK)
    s = fused.mla_decode_splits(rows, positions, sms)
    plan = fused.mla_decode_plan(rows, positions, sms)
    assert len(plan) == rows * s
    seen = [(row, c) for row, lo, hi in plan for c in range(lo, hi)]
    assert seen == [(row, c) for row in range(rows) for c in range(chunks)]  # once each, in row-major order
    sizes = [hi - lo for _, lo, hi in plan]
    assert max(sizes) - min(sizes) <= 1
    for row in range(rows):
        held = plan[row * s:(row + 1) * s]
        assert all(r == row for r, _, _ in held) and held[0][1] == 0 and held[-1][2] == chunks
        assert all(a[2] == b[1] for a, b in zip(held, held[1:]))  # contiguous, split after split


@pytest.mark.parametrize("heads,rank,rope,takes", [
    (16, 512, 64, True), (128, 512, 64, True),  # V2-Lite, V2
    (4, 32, 16, False), (8, 512, 64, False), (16, 256, 64, False), (16, 512, 32, False),
])
def test_mla_widths_are_checked_before_the_card_runs(heads, rank, rope, takes):
    """The kernel's widths, checked where a model is built on the card:
    heads in tiles of 16, rank 512, rope 64; anything else raises."""
    if takes:
        fused.check_mla_widths(heads, rank, rope)
    else:
        with pytest.raises(ValueError, match="heads in tiles of 16, rank 512 and rope 64"):
            fused.check_mla_widths(heads, rank, rope)


# ---------------- the kernels (card) ----------------


def _card_gen(seed: int) -> torch.Generator:
    return _gen(seed, "cuda")


@needs_card
@pytest.mark.parametrize("residual", [False, True])
def test_rms_norm_kernel_equals_its_plain_version(residual):
    g = _card_gen(11)
    x = torch.randn(32, 2048 + 512, device="cuda", generator=g).bfloat16()[:, 100:2148]  # strided rows
    res = torch.randn(32, 2048, device="cuda", generator=g).bfloat16() if residual else None
    w = (torch.rand(2048, device="cuda", generator=g) + 0.5).bfloat16()
    before = fused.rms_norm.launches.count
    got = fused.rms_norm(x, w, 1e-6, residual=res)
    want = fused.rms_norm_reference(x, w, 1e-6, residual=res)
    assert fused.rms_norm.launches.count == before + 1
    if residual:
        assert torch.equal(got[0], want[0])
        got, want = got[1], want[1]
    assert _rel(got, want) < 2e-3 and (got.float() - want.float()).abs().max() <= 2 ** -7 * want.float().abs().max()


@needs_card
def test_rope_latent_kernel_equals_its_plain_version():
    cfg = ds.DeepseekV2Config.lite()
    g = _card_gen(12)
    width = cfg.num_heads * cfg.q_head_dim + cfg.latent_dim
    qkv = torch.randn(32, width, device="cuda", generator=g).bfloat16()
    positions = torch.randint(0, 8192, (32,), device="cuda", generator=g)
    w = (torch.rand(cfg.kv_lora_rank, device="cuda", generator=g) + 0.5).bfloat16()
    args = (positions, ds.yarn_inv_freq(cfg, "cuda"), 1.0, w, cfg.rms_norm_eps, cfg.num_heads, cfg.qk_nope_head_dim,
            cfg.qk_rope_head_dim, cfg.kv_lora_rank)
    got_pe, got_latent = fused.mla_rope_latent(qkv, *args)
    want_pe, want_latent = fused.mla_rope_latent_reference(qkv, *args)
    r = cfg.kv_lora_rank
    assert torch.equal(got_pe, want_pe) and torch.equal(got_latent[:, r:], want_latent[:, r:])  # rope: same roundings
    assert _rel(got_latent[:, :r], want_latent[:, :r]) < 2e-3  # the norm sums in another order


@needs_card
@pytest.mark.parametrize("batch,heads,first,end", [
    (32, 16, 0, 40), (32, 16, 100, 2600), (32, 16, 4000, 8192),  # the cell's shape and the cache's edge
    (32, 16, 7, 27),  # fewer positions than one chunk
    (32, 16, 0, 8192),  # every position, the edge
    (1, 16, 100, 2600), (1, 16, 3, 8192),  # one row: units fewer than the SMs, then a row over every block
    (4, 128, 100, 2600), (32, 128, 8150, 8192),  # V2's heads: eight tiles a row
])
def test_mla_decode_kernel_equals_its_plain_version(batch, heads, first, end):
    cfg = ds.DeepseekV2Config.lite()
    g = _card_gen(13)
    b, h, r, dr = batch, heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim
    kv = (torch.randn(2, b, 8192, r + dr, device="cuda", generator=g) * 0.5).bfloat16()[1]
    valid = torch.rand(b, 8192, device="cuda", generator=g) > 0.2
    lone = 3 if b > 3 else None  # a row that sees only its own position
    if lone is not None:
        valid[lone] = False
    q_lat = (torch.randn(h, b, r, device="cuda", generator=g) * 0.2).bfloat16()
    q_pe = (torch.randn(b, h, dr, device="cuda", generator=g) * 0.2).bfloat16()
    before = fused.mla_decode.launches.by_variant.get("mma+combine", 0)
    got = fused.mla_decode(q_lat, q_pe, kv, valid, first, end, 0.1147214)
    want = fused.mla_decode_reference(q_lat, q_pe, kv, valid, first, end, 0.1147214)
    assert fused.mla_decode.launches.by_variant["mma+combine"] == before + 1
    assert torch.isfinite(got.float()).all()
    assert _rel(got, want) < 1e-2
    if lone is not None:
        torch.testing.assert_close(got[:, lone], kv[lone, end - 1, :r].expand(h, r), rtol=0, atol=0)


@needs_card
@pytest.mark.parametrize("tokens", [1, 32, 100])
def test_moe_router_kernel_equals_its_plain_version(tokens):
    g = _card_gen(14)
    logits = torch.randn(tokens, 64, device="cuda", generator=g) * 0.3
    real = torch.rand(tokens, device="cuda", generator=g) > 0.25
    tally = torch.zeros((2, 3), dtype=torch.int64, device="cuda")
    want_tally = torch.zeros_like(tally)
    got = fused.moe_router(logits, 6, 1.0, real, tally, tally_rows=2)
    want = fused.moe_router_reference(logits, 6, 1.0, real, want_tally, tally_rows=2)
    assert torch.equal(got != 0, want != 0)
    torch.testing.assert_close(got, want, rtol=2e-6, atol=0)
    assert torch.equal(tally, want_tally)


@needs_card
def test_moe_combine_kernel_equals_its_plain_version():
    g = _card_gen(15)
    out = torch.randn(64, 32, 2048, device="cuda", generator=g).bfloat16()
    gates = torch.zeros(32, 64, device="cuda").scatter_(
        1, torch.randint(0, 64, (32, 6), device="cuda", generator=g), torch.rand(32, 6, device="cuda", generator=g))
    got, want = fused.moe_combine(out, gates), fused.moe_combine_reference(out, gates)
    assert _rel(got, want) < 2e-3 and (got.float() - want.float()).abs().max() <= 2 ** -7 * want.float().abs().max()


@needs_card
@torch.no_grad()
def test_one_token_step_on_card_goes_through_the_kernels():
    """A bf16 tiny model at the attention widths the MLA kernel takes (16
    heads, rank 512, rope 64): its one-token calls launch each fused op, and
    its logits stay finite."""
    cfg = dataclasses.replace(CFG, dtype="bfloat16", num_heads=16, kv_lora_rank=512, qk_rope_head_dim=64)
    card = ds.DeepseekV2LM(cfg, device="cuda").init_random(SEED).eval()
    cache = card.init_cache(2)
    cache.length = 8
    cache.valid[:, :8] = True
    counts = [f.launches.count for f in (fused.rms_norm, fused.mla_rope_latent, fused.mla_decode, fused.moe_router,
                                         fused.moe_combine)]
    logits = card(torch.tensor([[5], [9]], device="cuda"), torch.tensor([[8], [8]], device="cuda"), cache)
    after = [f.launches.count for f in (fused.rms_norm, fused.mla_rope_latent, fused.mla_decode, fused.moe_router,
                                        fused.moe_combine)]
    assert all(a > c for a, c in zip(after, counts)) and torch.isfinite(logits).all()

"""The tensor-parallel decoder of the PyTorch port against the JAX package
on the CPU: the JAX parameters sharded over its virtual CPU devices
(``shard_decoder_params`` under ``jax.set_mesh``, the JAX test's setup)
against the port's ``shard_decoder_params`` over a mesh of ``cpu``
entries, the same weights carried across. Twins of ``test_tp_decoder.py``.

Greedy tokens are held equal (tolerance: none) to JAX's sharded
``make_generate_fn`` and to the port's single device, through ``generate``,
``generate_lookup_speculative`` and ``ContinuousGenerator``; logits to 1e-5
(the shards' partial sums add in another order).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from intool_rag_tpu.models import decoder as jdec
from intool_rag_tpu.models.scheduler import ContinuousGenerator as JGenerator
from intool_rag_tpu.parallel import tp_decoder as jtp
from intool_rag_tpu_torch.models import decoder as tdec
from intool_rag_tpu_torch.models.scheduler import ContinuousGenerator
from intool_rag_tpu_torch.parallel import tp_decoder as ttp
from intool_rag_tpu_torch.parallel.mesh import Mesh

pytestmark = pytest.mark.multichip

torch.set_num_threads(2)
JCFG = jdec.DecoderConfig(vocab_size=257, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
                          intermediate_size=128, max_position=256, dtype="float32")


@pytest.fixture(scope="module")
def params():
    return jdec.init_decoder_params(JCFG)


@pytest.fixture(scope="module")
def model(params) -> tdec.DecoderLM:
    cfg = tdec.DecoderConfig(**dataclasses.asdict(JCFG))
    out = tdec.DecoderLM(cfg, device="cpu").eval()
    out.load_state_dict(tdec.decoder_state_from_flax(jax.tree.map(np.asarray, params)))
    return out


def jax_mesh(tp: int) -> JMesh:
    return JMesh(np.array(jax.devices()[:tp]).reshape(tp), ("model",))


def port_mesh(tp: int) -> Mesh:
    return Mesh(["cpu"] * tp, ("model",))


def test_tp_decode_matches_jax_sharded_and_single_device(params, model, rng):
    prompts = rng.integers(5, 250, size=(2, 16)).astype(np.int32)
    mask = np.ones_like(prompts)
    fn = jdec.make_generate_fn(JCFG, max_new_tokens=12, temperature=0.0)
    key = jax.random.PRNGKey(0)
    mesh = jax_mesh(2)
    with jax.set_mesh(mesh):
        want = np.asarray(fn(jtp.shard_decoder_params(params, mesh), jnp.asarray(prompts), jnp.asarray(mask), key))
    tp = ttp.shard_decoder_params(model, port_mesh(2))
    ids, tmask = torch.from_numpy(prompts).long(), torch.from_numpy(mask)
    got = tdec.generate(tp, ids, tmask, max_new_tokens=12)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), tdec.generate(model, ids, tmask, max_new_tokens=12).numpy())


def test_tp_layout_spot_check_and_replicated_odd_vocab(params, model):
    """The JAX test's spot check: q_proj splits its output (heads), o_proj
    its input, the MLP likewise; the 257-entry lm_head, which 2 does not
    divide, is replicated in both packages."""
    mesh = jax_mesh(2)
    sharded = jtp.shard_decoder_params(params, mesh)
    jq = sharded["params"]["layer_0"]["attn"]["q_proj"]["kernel"]
    assert jq.sharding.spec == jax.sharding.PartitionSpec(None, "model")
    assert sharded["params"]["lm_head"]["kernel"].sharding.spec in (jax.sharding.PartitionSpec(),
                                                                   jax.sharding.PartitionSpec(None, None))
    state = model.state_dict()
    assert ttp.decoder_param_spec("layers.0.attn.q_proj.weight", state["layers.0.attn.q_proj.weight"].shape,
                                  tp=2) == ("model", None)  # the port's [out, in]: the JAX kernel's dim 1
    assert ttp.decoder_param_spec("layers.0.attn.o_proj.weight", (64, 64), tp=2) == (None, "model")
    assert ttp.decoder_param_spec("layers.1.down_proj.weight", (64, 128), tp=2) == (None, "model")
    assert ttp.decoder_param_spec("lm_head.weight", (257, 64), tp=2) == ()
    assert ttp.decoder_param_spec("lm_head.weight", (256, 64), tp=2) == ("model", None)
    assert ttp.decoder_param_spec("embed.weight", (257, 64), tp=2) == ()
    tp = ttp.shard_decoder_params(model, port_mesh(2))
    q = state["layers.0.attn.q_proj.weight"]
    for t in range(2):
        blk = tp.shards[t].layers[0]
        assert torch.equal(blk.attn.q_proj.weight, q[t * 32:(t + 1) * 32])  # query heads 2t, 2t+1
        assert torch.equal(blk.attn.k_proj.weight, state["layers.0.attn.k_proj.weight"][t * 16:(t + 1) * 16])
        assert torch.equal(blk.attn.o_proj.weight, state["layers.0.attn.o_proj.weight"][:, t * 32:(t + 1) * 32])
        assert torch.equal(blk.gate_proj.weight, np.split(state["layers.0.gate_proj.weight"], 2)[t])
        assert (blk.attn.num_heads, blk.attn.num_kv_heads) == (2, 1)
    assert len(tp.lm_head) == 1 and torch.equal(tp.lm_head[0].weight, state["lm_head.weight"])
    gathered = tp.gather_state_dict()
    assert gathered.keys() == state.keys() and all(torch.equal(gathered[k], v) for k, v in state.items())


def test_tp_split_vocab_gathers_logits_in_shard_order(model):
    cfg = dataclasses.replace(model.config, vocab_size=256)
    state = {k: (v[:256] if k in ("embed.weight", "lm_head.weight") else v) for k, v in model.state_dict().items()}
    single = tdec.DecoderLM(cfg, device="cpu").eval()
    single.load_state_dict(state)
    tp = ttp.shard_decoder_params(state, port_mesh(2), config=cfg)
    assert [h.weight.shape[0] for h in tp.lm_head] == [128, 128]
    ids = torch.randint(5, 250, (2, 9), generator=torch.Generator().manual_seed(0))
    pos = torch.arange(9)[None].expand(2, -1)
    with torch.no_grad():
        want = single(ids, pos, single.init_cache(2))
        got = tp(ids, pos, tp.init_cache(2))
    assert got.shape == want.shape == (2, 9, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


def test_tp_cache_holds_each_shards_kv_heads(model):
    tp = ttp.shard_decoder_params(model, port_mesh(2))
    cache = tp.init_cache(3, positions=40)
    assert [k.shape for k in cache.k] == [(2, 3, 40, 1, 16)] * 2 and cache.valid.shape == (3, 40)
    ids = torch.randint(5, 250, (3, 7), generator=torch.Generator().manual_seed(1))
    pos = torch.arange(7)[None].expand(3, -1)
    ref = model.init_cache(3, positions=40)
    with torch.no_grad():
        tp(ids, pos, cache)
        model(ids, pos, ref)
    assert cache.length == ref.length == 7 and torch.equal(cache.valid, ref.valid)
    for t in range(2):  # shard t's cache holds kv head t of the single device's (layer 1 after a psum: 1e-5)
        np.testing.assert_allclose(cache.k[t].numpy(), ref.k[:, :, :, t:t + 1].numpy(), atol=1e-5)
        np.testing.assert_allclose(cache.v[t].numpy(), ref.v[:, :, :, t:t + 1].numpy(), atol=1e-5)


def test_tp_validate_rejects_indivisible():
    config = tdec.DecoderConfig(vocab_size=64, hidden_size=32, num_layers=1, num_heads=3, num_kv_heads=3,
                                intermediate_size=96, max_position=64, dtype="float32")
    jconfig = jdec.DecoderConfig(**dataclasses.asdict(config))
    with pytest.raises(ValueError, match="must divide"):
        jtp.validate_tp(jconfig, jax_mesh(2))
    with pytest.raises(ValueError, match="must divide"):
        ttp.validate_tp(config, port_mesh(2))
    model = tdec.DecoderLM(config, device="cpu").init_random(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="must divide"):
        ttp.shard_decoder_params(model, port_mesh(2))
    odd_mlp = dataclasses.replace(config, num_heads=2, num_kv_heads=2, intermediate_size=97)
    with pytest.raises(ValueError, match="intermediate_size"):
        ttp.validate_tp(odd_mlp, port_mesh(2))
    assert ttp.validate_tp(dataclasses.replace(config, num_heads=4, num_kv_heads=2), port_mesh(2)) == 2


def test_tp_scheduler_serving(params, model, rng):
    """The continuous-batching scheduler takes the TP model unchanged: its
    tokens equal the JAX single-device scheduler's and the port's."""
    prompts = [rng.integers(5, 250, size=8).tolist() for _ in range(4)]
    limits = [10] * 4
    want, _ = JGenerator(JCFG, params, n_slots=2, seg_len=4).generate_many(prompts, limits)
    single, _ = ContinuousGenerator(model, n_slots=2, seg_len=4).generate_many(prompts, limits)
    tp = ttp.shard_decoder_params(model, port_mesh(2))
    got, stats = ContinuousGenerator(tp, n_slots=2, seg_len=4).generate_many(prompts, limits)
    assert got == want == single
    assert stats["total_tokens"] == 40


def test_tp_scheduler_compaction_and_speculative_waves(model, rng):
    """A cache too small for the run (compactions) and prompt-lookup waves:
    the TP model's tokens equal the single device's."""
    cfg = dataclasses.replace(model.config, max_position=48)
    small = tdec.DecoderLM(cfg, device="cpu").eval()
    small.load_state_dict(model.state_dict())
    tp = ttp.shard_decoder_params(small, port_mesh(2))
    base = rng.integers(5, 250, size=6).tolist()
    prompts = [base * 2, rng.integers(5, 250, size=8).tolist(), base + base[:3]]
    for kw in (dict(seg_len=4), dict(seg_len=8, speculative_gamma=4)):
        want, wstats = ContinuousGenerator(small, n_slots=2, **kw).generate_many(prompts, 20)
        got, gstats = ContinuousGenerator(tp, n_slots=2, **kw).generate_many(prompts, 20)
        assert got == want, kw
        assert gstats["compactions"] == wstats["compactions"] > 0


@pytest.mark.parametrize("gamma", [1, 4])
def test_tp_lookup_speculative_equals_single_device(model, gamma):
    prompt = torch.tensor([[0, 0] + [7, 8, 9, 10, 11] * 3], dtype=torch.long)
    mask = (prompt > 0).long()
    tp = ttp.shard_decoder_params(model, port_mesh(2))
    want = tdec.generate_lookup_speculative(model, prompt, mask, max_new_tokens=16, gamma=gamma)
    got = tdec.generate_lookup_speculative(tp, prompt, mask, max_new_tokens=16, gamma=gamma)
    assert torch.equal(got, want)


def test_tp_decoder_repeats_bit_equal_and_tp1_equals_one_device(model):
    ids = torch.randint(5, 250, (2, 12), generator=torch.Generator().manual_seed(2))
    pos = torch.arange(12)[None].expand(2, -1)
    with torch.no_grad():
        one = ttp.shard_decoder_params(model, port_mesh(1))
        assert torch.equal(one(ids, pos, one.init_cache(2)), model(ids, pos, model.init_cache(2)))
        tp = ttp.shard_decoder_params(model, port_mesh(2))
        assert torch.equal(tp(ids, pos, tp.init_cache(2)), tp(ids, pos, tp.init_cache(2)))

"""Sequence parallelism of the PyTorch port against the JAX package on the
CPU: ``ring_attention`` and ``sp_encode_fn`` over the 8 virtual CPU devices
(the JAX test's setup) against the port over a mesh of 8 ``cpu`` entries,
the same weights carried across. Twins of ``test_sequence_parallel.py``.

Tolerances: ring attention 2e-5 absolute on valid query rows (the JAX
test's bar against full attention; the two einsum loops sum in another
order), the encoder 3e-5 on valid positions.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from intool_rag_tpu.models import encoder as jenc
from intool_rag_tpu.parallel import sequence as jseq
from intool_rag_tpu_torch.models.encoder import EncoderConfig, TextEncoder, params_from_jax
from intool_rag_tpu_torch.parallel import sequence as tseq

pytestmark = pytest.mark.multichip

CFG = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128, max_position=68,
           dtype="float32")


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_mesh(n: int = 8):
    return tseq.seq_mesh(["cpu"] * n)


def _port_encoder(params, **overrides) -> TextEncoder:
    model = TextEncoder(EncoderConfig(**{**CFG, **overrides}), device="cpu")
    model.load_state_dict(params_from_jax(_numpy_tree(params)))
    return model.eval()


def _qkv_mask(rng, b=2, h=4, s=64, d=16):
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, s), np.int32)
    mask[0, 40:] = 0  # padded tail on one row
    return q, k, v, mask


def _jax_ring(q, k, v, mask):
    ring = shard_map(
        lambda q, k, v, m: jseq.ring_attention(q, k, v, m, axis_name="seq"),
        mesh=jseq.seq_mesh(),
        in_specs=(P(None, None, "seq", None),) * 3 + (P(None, "seq"),),
        out_specs=P(None, None, "seq", None),
    )
    return np.asarray(ring(*(jnp.asarray(x) for x in (q, k, v, mask))))


def _port_ring(q, k, v, mask, n=8):
    split = [torch.from_numpy(x).chunk(n, dim=2) for x in (q, k, v)]
    masks = torch.from_numpy(mask).chunk(n, dim=1)
    out = tseq.ring_attention(*(list(s) for s in split), list(masks))
    return torch.cat(out, dim=2).numpy()


def test_ring_attention_matches_jax_ring_and_full_attention():
    q, k, v, mask = _qkv_mask(np.random.default_rng(0))
    got = _port_ring(q, k, v, mask)
    want = _jax_ring(q, k, v, mask)
    ref = np.asarray(jax.nn.dot_product_attention(
        *(jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v)),
        mask=jnp.asarray(mask)[:, None, None, :].astype(bool)).transpose(0, 2, 1, 3))
    for bi in range(q.shape[0]):
        rows = mask[bi] > 0
        np.testing.assert_allclose(got[bi][:, rows], want[bi][:, rows], atol=2e-5)
        np.testing.assert_allclose(got[bi][:, rows], ref[bi][:, rows], atol=2e-5)


def test_ring_attention_on_a_wholly_padded_row_gives_zeros_as_jax():
    q, k, v, mask = _qkv_mask(np.random.default_rng(1))
    mask[1] = 0
    got, want = _port_ring(q, k, v, mask), _jax_ring(q, k, v, mask)
    assert np.all(got[1] == 0) and np.all(want[1] == 0)
    np.testing.assert_allclose(got[0][:, mask[0] > 0], want[0][:, mask[0] > 0], atol=2e-5)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_ring_attention_any_shard_count_equals_one_block(n):
    """The ring over n shards equals the ring over one (all keys in one
    block) to rounding: the hops deliver every block once."""
    q, k, v, mask = _qkv_mask(np.random.default_rng(2))
    got = _port_ring(q, k, v, mask, n=n)
    one = _port_ring(q, k, v, mask, n=1)
    for bi in range(q.shape[0]):
        rows = mask[bi] > 0
        np.testing.assert_allclose(got[bi][:, rows], one[bi][:, rows], atol=2e-6)


def test_sp_encoder_matches_jax_and_single_device():
    jcfg = jenc.EncoderConfig(**CFG)
    params = jenc.init_params(jcfg, seed=3)
    rng = np.random.default_rng(1)
    ids = rng.integers(4, 512, (4, 64)).astype(np.int32)
    mask = np.ones((4, 64), np.int32)
    mask[1, 50:] = 0
    mask[3, 17:] = 0

    jsp = jseq.sp_encode_fn(jcfg, jseq.seq_mesh())
    want = np.asarray(jsp(params, jsp.place_batch(jnp.asarray(ids)), jsp.place_batch(jnp.asarray(mask))))
    model = _port_encoder(params)
    tsp = tseq.sp_encode_fn(model.config, port_mesh())
    with torch.no_grad():
        got = tsp(model, tsp.place_batch(torch.from_numpy(ids)), tsp.place_batch(torch.from_numpy(mask))).numpy()
        single = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert got.shape == (4, 64)
    np.testing.assert_allclose(got, want, atol=3e-5)
    np.testing.assert_allclose(got, single, atol=3e-5)


def test_sp_encoder_unpooled_hidden_parity():
    jcfg = jenc.EncoderConfig(**CFG)
    params = jenc.init_params(jcfg, seed=5)
    rng = np.random.default_rng(2)
    ids = rng.integers(4, 512, (2, 32)).astype(np.int32)
    mask = np.ones((2, 32), np.int32)
    mask[0, 20:] = 0

    jsp = jseq.sp_encode_fn(jcfg, jseq.seq_mesh(), pool=False)
    want = np.asarray(jsp(params, jsp.place_batch(jnp.asarray(ids)), jsp.place_batch(jnp.asarray(mask))))
    model = _port_encoder(params)
    tsp = tseq.sp_encode_fn(model.config, port_mesh(), pool=False)
    with torch.no_grad():
        got = tsp(model, torch.from_numpy(ids), torch.from_numpy(mask))  # whole tensors are placed by fn
    assert got.dtype == torch.float32 and got.shape == (2, 32, 64)
    valid = mask > 0
    np.testing.assert_allclose(got.numpy()[valid], want[valid], atol=3e-5)


def test_sp_encoder_at_the_flash_length_equals_the_single_device_flash_route():
    """A config whose rows take the flash route on one device (S 128 =
    flash_min_len, head width 64): the ring gives the same embeddings, to
    rounding."""
    wide = dict(max_position=132, hidden_size=128, num_heads=2)
    params = jenc.init_params(jenc.EncoderConfig(**{**CFG, **wide}), seed=7)
    model = _port_encoder(params, flash_min_len=128, **wide)
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.integers(4, 512, (2, 128)))
    mask = torch.ones((2, 128), dtype=torch.long)
    mask[1, 90:] = 0
    tsp = tseq.sp_encode_fn(model.config, port_mesh(4))
    with torch.no_grad():
        np.testing.assert_allclose(tsp(model, ids, mask).numpy(), model(ids, mask).numpy(), atol=3e-5)


def test_sp_encoder_refuses_an_indivisible_length_and_another_config():
    model = _port_encoder(jenc.init_params(jenc.EncoderConfig(**CFG), seed=0))
    tsp = tseq.sp_encode_fn(model.config, port_mesh())
    with pytest.raises(ValueError, match="multiple"):
        tsp(model, torch.zeros((1, 60), dtype=torch.long), torch.ones((1, 60), dtype=torch.long))
    other = tseq.sp_encode_fn(dataclasses.replace(model.config, num_layers=1), port_mesh())
    with pytest.raises(ValueError, match="config"):
        other(model, torch.zeros((1, 64), dtype=torch.long), torch.ones((1, 64), dtype=torch.long))


def test_sp_encoder_copies_the_model_once_for_each_state_of_its_weights():
    """A shard on another device than the model's (``cpu:0`` beside
    ``cpu``) runs a copy of it: made on the first call, kept while the
    weights stand, made anew after they change; the embeddings follow the
    weights."""
    model = _port_encoder(jenc.init_params(jenc.EncoderConfig(**CFG), seed=4))
    tsp = tseq.sp_encode_fn(model.config, tseq.seq_mesh(["cpu", "cpu:0"]))
    rng = np.random.default_rng(8)
    ids = torch.from_numpy(rng.integers(4, 512, (2, 64)))
    mask = torch.ones((2, 64), dtype=torch.long)
    first = tsp.replicas(model)
    assert first[0] is model and first[1] is not model
    assert all(torch.equal(first[1].state_dict()[k], v) for k, v in model.state_dict().items())
    with torch.no_grad():
        np.testing.assert_allclose(tsp(model, ids, mask).numpy(), model(ids, mask).numpy(), atol=3e-5)
    assert tsp.replicas(model)[1] is first[1]
    with torch.no_grad():
        model.layers[0].attention.query.weight.mul_(2.0)
    again = tsp.replicas(model)
    assert again[1] is not first[1]
    assert torch.equal(again[1].layers[0].attention.query.weight, model.layers[0].attention.query.weight)
    with torch.no_grad():
        np.testing.assert_allclose(tsp(model, ids, mask).numpy(), model(ids, mask).numpy(), atol=3e-5)

"""The encoder built for training (f32 master weights, compute in the
config's dtype) against the serving encoder (weights resident in the
compute dtype), and the checkpoint writer against both packages' readers."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from intool_rag_tpu.models import encoder as jenc
from intool_rag_tpu_torch.models import msgpack
from intool_rag_tpu_torch.models.encoder import (
    EncoderConfig, TextEncoder, load_encoder, load_encoder_checkpoint, load_torch_state_dict, params_from_jax,
    params_to_jax, save_encoder_checkpoint,
)

torch.set_num_threads(2)

BF16_TINY = dataclasses.replace(EncoderConfig.tiny(), dtype="bfloat16")
BF16_FLASH = EncoderConfig(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256,
                           max_position=132, dtype="bfloat16", flash_min_len=128)


def _pair_of_models(cfg, seed: int = 0):
    """(training model with f32 masters, serving model with the same values cast once)."""
    master = TextEncoder(cfg, device="cpu", param_dtype=torch.float32).init_flax(torch.Generator().manual_seed(seed))
    resident = TextEncoder(cfg, device="cpu")
    resident.load_state_dict(master.state_dict())
    return master, resident


def _rows(rng, cfg, b: int, s: int):
    ids = rng.integers(4, cfg.vocab_size, (b, s)).astype(np.int32)
    mask = (np.arange(s)[None] < rng.integers(s // 2, s + 1, size=(b, 1))).astype(np.int32)
    return torch.from_numpy(np.where(mask > 0, ids, 1).astype(np.int32)), torch.from_numpy(mask)


@pytest.mark.parametrize("cfg,s", [(BF16_TINY, 24), (BF16_FLASH, 128)], ids=["key-mask", "flash"])
@pytest.mark.parametrize("pool", [True, False])
def test_f32_masters_compute_what_resident_bf16_weights_compute(cfg, s, pool):
    """Casting each weight at its point of use gives the forward of weights
    cast once, bit for bit."""
    master, resident = _pair_of_models(cfg)
    assert {p.dtype for p in master.parameters()} == {torch.float32}
    assert {p.dtype for p in resident.parameters()} == {torch.bfloat16}
    ids, mask = _rows(np.random.default_rng(s), cfg, 3, s)
    with torch.no_grad():
        a, b = master(ids, mask, pool=pool), resident(ids, mask, pool=pool)
    assert a.dtype == b.dtype == torch.float32 and torch.equal(a, b)
    with torch.no_grad():  # train() and eval() compute the same: there is no dropout
        assert torch.equal(master.train()(ids, mask, pool=pool), a)


def test_f32_masters_equal_resident_weights_on_packed_rows():
    master, resident = _pair_of_models(BF16_FLASH, seed=1)
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(4, 512, (2, 128)).astype(np.int32))
    seg = torch.from_numpy((np.arange(128)[None] // 40 + 1).repeat(2, 0).astype(np.int32))
    seg[:, 120:] = 0
    cls = torch.tensor([[0, 40, 80, 0]] * 2, dtype=torch.int32)
    mask = (seg > 0).to(torch.int32)
    with torch.no_grad():
        a = master(ids, mask, segment_ids=seg, cls_index=cls)
        b = resident(ids, mask, segment_ids=seg, cls_index=cls)
    assert a.shape == (2, 4, 128) and torch.equal(a, b)


def test_gradients_and_state_dict_of_the_training_model_are_f32():
    master, _ = _pair_of_models(BF16_FLASH)
    ids, mask = _rows(np.random.default_rng(3), BF16_FLASH, 2, 128)
    master.train()(ids, mask).square().sum().backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32 for p in master.parameters())
    assert {v.dtype for v in master.state_dict().values()} == {torch.float32}


def test_default_param_dtype_is_the_compute_dtype():
    assert next(TextEncoder(BF16_TINY, device="cpu").parameters()).dtype == torch.bfloat16
    assert next(TextEncoder(EncoderConfig.tiny(), device="cpu").parameters()).dtype == torch.float32


def test_init_flax_scales():
    cfg = EncoderConfig(vocab_size=4096, hidden_size=256, num_layers=1, num_heads=4, intermediate_size=1024,
                        max_position=66, dtype="float32")
    model = TextEncoder(cfg, device="cpu").init_flax(torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert abs(float(sd["word_emb.weight"].std()) - 256 ** -0.5) < 0.02 * 256 ** -0.5
    assert abs(float(sd["layers.0.intermediate.weight"].std()) - 256 ** -0.5) < 0.02 * 256 ** -0.5
    assert abs(float(sd["layers.0.mlp_output.weight"].std()) - 1024 ** -0.5) < 0.02 * 1024 ** -0.5
    assert float(sd["layers.0.attention.query.bias"].abs().max()) == 0.0
    assert torch.equal(sd["emb_ln.weight"], torch.ones(256))


def _numpy_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x), tree)


def test_params_to_jax_inverts_params_from_jax():
    cfg = jenc.EncoderConfig.tiny()
    tree = _numpy_tree(jenc.init_params(cfg, seed=5))
    back = params_to_jax(params_from_jax(tree))
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert b.dtype == np.float32 and b.flags["C_CONTIGUOUS"] and np.array_equal(a, b)


@pytest.mark.parametrize("store_dtype,atol", [("float32", 1e-5), ("float16", 2e-3)])
def test_saved_checkpoint_opens_in_both_packages(tmp_path, store_dtype, atol):
    cfg = EncoderConfig.tiny()
    model = TextEncoder(cfg, device="cpu").init_flax(torch.Generator().manual_seed(6)).eval()
    path = tmp_path / "enc.npz"
    save_encoder_checkpoint(path, model, store_dtype=store_dtype)
    ids, mask = _rows(np.random.default_rng(7), cfg, 4, 20)
    with torch.no_grad():
        want = model(ids, mask).numpy()
    # the port's own reader
    config, tree = load_encoder_checkpoint(path)
    assert config == cfg and tree["params"]["word_emb"]["embedding"].dtype == np.float32
    with torch.no_grad():
        np.testing.assert_allclose(load_encoder(path, device="cpu")(ids, mask).numpy(), want, atol=atol, rtol=0)
    # the JAX package's reader (flax.serialization.from_bytes against its own template)
    jcfg, params = jenc.load_encoder_checkpoint(path)
    assert dataclasses.asdict(jcfg) == {**dataclasses.asdict(cfg), "ring_axis": None}
    got = np.asarray(jenc.TextEncoder(jcfg).apply(params, jnp.asarray(ids.numpy()), jnp.asarray(mask.numpy())))
    np.testing.assert_allclose(got, want, atol=max(atol, 1e-4), rtol=0)
    if store_dtype == "float32":
        for key, val in params_from_jax(_numpy_tree(params)).items():
            assert torch.equal(val, model.state_dict()[key]), key


def test_jax_written_checkpoint_round_trips_through_the_port(tmp_path):
    """JAX writes, the port reads, trains nothing, writes; JAX reads the same values."""
    cfg = jenc.EncoderConfig.tiny()
    params = jenc.init_params(cfg, seed=8)
    first, second = tmp_path / "a.npz", tmp_path / "b.npz"
    jenc.save_encoder_checkpoint(first, cfg, params)
    save_encoder_checkpoint(second, load_encoder(first, device="cpu"))
    _, again = jenc.load_encoder_checkpoint(second)
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(again)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("tree", [
    {"params": {"a": {"kernel": np.arange(12, dtype=np.float32).reshape(3, 4), "bias": np.zeros(70_000, np.float16)}}},
    {"x": np.ones((300, 300), np.float32), "y": {"z": np.array(3, np.int32)}, "empty": {}},
    {f"k{i:02d}": np.full((2,), i, np.int64) for i in range(40)},  # a map past the 15 entries of a fixmap
], ids=["nested", "scalar-leaf", "map16"])
def test_packb_is_restored_by_flax_and_by_unpackb(tree):
    data = msgpack.packb(tree)
    for restored in (serialization.msgpack_restore(data), msgpack.unpackb(data)):
        flat_a = jax.tree_util.tree_leaves_with_path(tree)
        flat_b = jax.tree_util.tree_leaves_with_path(restored)
        assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
        for (_, a), (_, b) in zip(flat_a, flat_b):
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    assert msgpack.unpackb(serialization.to_bytes(tree)).keys() == tree.keys()


@pytest.mark.parametrize("bad", [{1: np.zeros(2)}, {"a": 1.5}, {"a": np.array([object()])}, {"a": None}],
                         ids=["int-key", "float", "object-array", "none"])
def test_packb_refuses_what_a_parameter_tree_does_not_hold(bad):
    with pytest.raises((TypeError, ValueError)):
        msgpack.packb(bad)


def test_load_torch_state_dict_matches_the_jax_mapping():
    """HF ``XLMRobertaModel`` names -> the port's state dict equals HF names
    -> the JAX package's flax tree -> ``params_from_jax``."""
    from test_torch_reranker import _hf_state_dict

    cfg = EncoderConfig.tiny()
    sd = {k[len("roberta."):]: v for k, v in _hf_state_dict(np.random.default_rng(9), cfg).items()
          if k.startswith("roberta.")}
    direct = load_torch_state_dict(cfg, sd)
    via_jax = params_from_jax(_numpy_tree(jenc.load_torch_state_dict(jenc.EncoderConfig.tiny(), sd)))
    assert set(direct) == set(via_jax) == set(TextEncoder(cfg, device="cpu").state_dict())
    for key in direct:
        assert torch.equal(direct[key], via_jax[key]), key

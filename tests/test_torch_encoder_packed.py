"""The port's encoder on packed rows, on the flash-attention route and with
``pool=False``, against the JAX encoder with the same weights and inputs.

On the CPU the JAX encoder takes its pair-mask route at every length; the
port's route depends on the shape and the config alone, so a small
``flash_min_len`` sends it through K5's plain version. On that route a pad
query attends to pad keys only, so only valid positions are compared.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intool_rag_tpu.models import encoder as jenc
from intool_rag_tpu.models.packing import build_packed_arrays, pack_bins
from intool_rag_tpu_torch.models import encoder as tenc
from intool_rag_tpu_torch.ops import flash_attention as tflash

torch.set_num_threads(2)

CKPT = Path(__file__).resolve().parents[1] / "intool_rag_tpu" / "models" / "weights" / "encoder_mid.npz"
ATOL = 1e-4  # f32: the same sums in another order through 2 layers, on unit-norm outputs

# 2 layers, 4 heads of 64 (the head width K5 takes)
WIDE = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4, intermediate_size=512,
            max_position=260, dtype="float32")


def _pair(fields: dict, seed: int, **torch_overrides):
    """(JAX config, JAX params, the port's model with the same weights)."""
    jcfg = jenc.EncoderConfig(**fields)
    params = jenc.init_params(jcfg, seed=seed)
    model = tenc.TextEncoder(tenc.EncoderConfig(**{**fields, **torch_overrides}), device="cpu")
    model.load_state_dict(tenc.params_from_jax(jax.tree.map(np.asarray, params)))
    return jcfg, params, model.eval()


def _packed(rng, vocab: int, lengths: list[int], width: int):
    rows = [[0] + [int(t) for t in rng.integers(4, vocab, size=n - 2)] + [2] for n in lengths]
    bins = pack_bins(lengths, width)
    return rows, bins, build_packed_arrays(rows, bins, width, 1)


def _japply(jcfg, params, ids, mask, **kw):
    kw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    return np.asarray(jenc.TextEncoder(jcfg).apply(params, jnp.asarray(ids), jnp.asarray(mask), **kw))


def _tapply(model, ids, mask, **kw):
    kw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    with torch.no_grad():
        return model(torch.from_numpy(ids), torch.from_numpy(mask), **kw).numpy()


@pytest.mark.parametrize("name", ["tiny", "wide"])
def test_packed_rows_match_jax_and_the_padded_path(name):
    fields = dataclasses.asdict(jenc.EncoderConfig.tiny()) if name == "tiny" else WIDE
    fields = {k: v for k, v in fields.items() if k not in ("flash_min_len", "ring_axis")}
    jcfg, params, model = _pair(fields, seed=5)
    rng = np.random.default_rng(0)
    lengths = [int(x) for x in rng.integers(3, 41, size=17)]
    rows, bins, (ids, seg, cls, idx) = _packed(rng, fields["vocab_size"], lengths, 128)
    mask = (seg > 0).astype(np.int32)
    got = _tapply(model, ids, mask, segment_ids=seg, cls_index=cls)
    want = _japply(jcfg, params, ids, mask, segment_ids=seg, cls_index=cls)
    assert got.shape == want.shape == (len(bins), cls.shape[1], fields["hidden_size"])
    valid = idx >= 0
    np.testing.assert_allclose(got[valid], want[valid], atol=ATOL, rtol=0)
    # the same texts padded, one per row: each text's computation is the same
    ids_p = np.full((len(rows), 40), 1, np.int32)
    mask_p = np.zeros((len(rows), 40), np.int32)
    for i, r in enumerate(rows):
        ids_p[i, : len(r)], mask_p[i, : len(r)] = r, 1
    padded = _tapply(model, ids_p, mask_p)
    np.testing.assert_allclose(got[valid], padded[idx[valid]], atol=ATOL, rtol=0)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "long-unpacked"])
def test_flash_route_matches_jax_at_valid_positions(packed):
    """S 256 >= flash_min_len 128: the port goes through K5 (its plain
    version here), the JAX encoder through its pair mask or key mask."""
    jcfg, params, model = _pair(WIDE, seed=7, flash_min_len=128)
    rng = np.random.default_rng(1)
    tflash.flash_attention_plain.calls.reset()
    if packed:
        lengths = [int(x) for x in rng.integers(5, 120, size=9)]
        _, _, (ids, seg, cls, idx) = _packed(rng, WIDE["vocab_size"], lengths, 256)
        mask = (seg > 0).astype(np.int32)
        kw = dict(segment_ids=seg, cls_index=cls)
        valid_cls = idx >= 0
    else:
        ids = rng.integers(4, WIDE["vocab_size"], size=(3, 256)).astype(np.int32)
        mask = (np.arange(256)[None] < np.array([[256], [131], [7]])).astype(np.int32)
        ids[:, 0], ids[mask == 0] = 0, 1
        kw, valid_cls = {}, np.ones(3, bool)
    got = _tapply(model, ids, mask, **kw)
    assert tflash.flash_attention_plain.calls.count == WIDE["num_layers"]
    np.testing.assert_allclose(got[valid_cls], _japply(jcfg, params, ids, mask, **kw)[valid_cls], atol=ATOL, rtol=0)
    hidden = _tapply(model, ids, mask, pool=False, **{k: v for k, v in kw.items() if k != "cls_index"})
    want = _japply(jcfg, params, ids, mask, pool=False, **{k: v for k, v in kw.items() if k != "cls_index"})
    assert hidden.dtype == np.float32 and hidden.shape == (*ids.shape, WIDE["hidden_size"])
    # unnormalized hidden states of magnitude ~1 after the last LayerNorm
    np.testing.assert_allclose(hidden[mask > 0], want[mask > 0], atol=5e-4, rtol=0)
    # the same model below flash_min_len: the pair-mask / key-mask route, same answer
    model_short = tenc.TextEncoder(dataclasses.replace(model.config, flash_min_len=0), device="cpu")
    model_short.load_state_dict(model.state_dict())
    tflash.flash_attention_plain.calls.reset()
    np.testing.assert_allclose(_tapply(model_short.eval(), ids, mask, **kw)[valid_cls], got[valid_cls], atol=ATOL, rtol=0)
    assert tflash.flash_attention_plain.calls.count == 0


def test_flash_route_does_not_depend_on_the_device():
    """A head width K5 does not take raises on the CPU as it would on the
    card: the route is chosen from the shape and the config alone."""
    cfg = dataclasses.replace(tenc.EncoderConfig.tiny(), flash_min_len=128, max_position=260)
    model = tenc.TextEncoder(cfg, device="cpu").init_random(torch.Generator().manual_seed(0))
    ids = torch.zeros((1, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="head dim"):
        model(ids, torch.ones_like(ids))
    assert model(ids[:, :64], torch.ones_like(ids[:, :64])).shape == (1, 64)  # below flash_min_len


def test_explicit_positions_match_jax():
    fields = {k: v for k, v in dataclasses.asdict(jenc.EncoderConfig.tiny()).items()
              if k not in ("flash_min_len", "ring_axis")}
    jcfg, params, model = _pair(fields, seed=2)
    rng = np.random.default_rng(3)
    ids = rng.integers(4, 1024, size=(2, 16)).astype(np.int32)
    mask = np.ones_like(ids)
    positions = (np.arange(16)[None] + np.array([[40], [90]]) + 2).astype(np.int32)
    got = _tapply(model, ids, mask, positions=positions)
    np.testing.assert_allclose(got, _japply(jcfg, params, ids, mask, positions=positions), atol=ATOL, rtol=0)
    assert np.abs(got - _tapply(model, ids, mask)).max() > 1e-3


def test_bf16_at_bge_m3_width_matches_jax():
    """hidden 1024, 16 heads, 2 layers, bf16 on both sides. The two
    frameworks round to bf16 at different places (flax keeps f32 parameters
    and casts per call, LayerNorm statistics differ), so the bar is the
    cosine of the L2-normalized embeddings: >= 0.999, and max-abs 1e-2
    (bf16 has 8 bits of mantissa; components are ~1/32)."""
    fields = dict(vocab_size=1024, hidden_size=1024, num_layers=2, num_heads=16,
                  intermediate_size=4096, max_position=260, dtype="bfloat16")
    jcfg, params, model = _pair(fields, seed=11, flash_min_len=128)
    rng = np.random.default_rng(4)
    lengths = [int(x) for x in rng.integers(5, 100, size=6)]
    _, _, (ids, seg, cls, idx) = _packed(rng, 1024, lengths, 128)
    mask = (seg > 0).astype(np.int32)
    got = _tapply(model, ids, mask, segment_ids=seg, cls_index=cls)
    want = _japply(jcfg, params, ids, mask, segment_ids=seg, cls_index=cls)
    valid = idx >= 0
    cos = (got[valid] * want[valid]).sum(axis=-1)
    assert cos.min() >= 0.999, cos
    assert np.abs(got[valid] - want[valid]).max() <= 1e-2


def test_flash_min_len_survives_the_checkpoint(tmp_path):
    config, _ = tenc.load_encoder_checkpoint(CKPT)
    assert config.flash_min_len == 0  # encoder_mid never takes K5, in either package
    jcfg = jenc.EncoderConfig(**{**WIDE, "flash_min_len": 128})
    jenc.save_encoder_checkpoint(tmp_path / "wide.npz", jcfg, jenc.init_params(jcfg, seed=0))
    model = tenc.load_encoder(tmp_path / "wide.npz", device="cpu")
    assert model.config.flash_min_len == 128
    assert model.layers[0].attention.flash_min_len == 128
    assert tenc.EncoderConfig().flash_min_len == jenc.EncoderConfig().flash_min_len == 1024

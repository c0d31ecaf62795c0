"""The DP+TP contrastive train step of the PyTorch port against the JAX
package on the CPU: the JAX step over ``train_mesh()`` on its 8 virtual
CPU devices, (data 4, model 2) (the JAX test's setup), against the port's
over ``train_mesh`` of 8 ``cpu`` entries, from the same f32 parameters and
batch. Twins of ``test_parallel.py``'s train-step and layout cases, plus the
collectives' backward in shard order.

Tolerances: one step's loss 1e-5 relative and every gradient 1e-5 of its
tensor's largest entry (the key biases aside: their true gradient is zero,
and both frameworks return rounding noise there); the port's sharded step
against its single-device step 1e-5 relative a step. Of five AdamW steps,
the first three hold 1e-5 relative against JAX and the last two 1e-4, the
bar of the single-device twin in ``test_torch_train_contrastive.py``:
Adam turns the rounding noise of
gradients near 1e-8 into updates of up to the learning rate, and the two
frameworks' losses drift apart by 1.3e-6, 4.0e-6, 1.1e-5 and 2.9e-5 over
steps 2 to 5 (the port's sharded and single-device steps stay within
1e-6 of each other).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from intool_rag_tpu.models import encoder as jenc
from intool_rag_tpu.parallel import mesh as jmesh
from intool_rag_tpu.train import contrastive as jtrain
from intool_rag_tpu_torch.models.encoder import EncoderConfig, TextEncoder, params_from_jax, params_to_jax
from intool_rag_tpu_torch.ops import flash_attention as tflash
from intool_rag_tpu_torch.parallel import collectives
from intool_rag_tpu_torch.parallel.mesh import train_mesh
from intool_rag_tpu_torch.train import contrastive as ttrain

pytestmark = pytest.mark.multichip

torch.set_num_threads(2)
LR = 1e-3


def _numpy_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _batch(rng, vocab: int, b: int = 8, s: int = 16) -> dict:
    return {"q_ids": rng.integers(4, vocab, (b, s)).astype(np.int32), "q_mask": np.ones((b, s), np.int32),
            "p_ids": rng.integers(4, vocab, (b, s)).astype(np.int32), "p_mask": np.ones((b, s), np.int32)}


def port_mesh(dp: int = 4, tp: int = 2):
    return train_mesh(["cpu"] * (dp * tp), model_parallel=tp)


def _port_model(params, cfg: EncoderConfig | None = None) -> TextEncoder:
    model = TextEncoder(cfg or EncoderConfig.tiny(), device="cpu", param_dtype=torch.float32)
    model.load_state_dict(params_from_jax(_numpy_tree(params)))
    return model


def _keep_grads() -> optax.GradientTransformation:
    """Zero updates; the state is the last gradients (what the JAX step
    computed, read back from its optimizer state)."""
    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _compare_trees(got: dict, want: dict, rel: float, path=()) -> None:
    for key, w in want.items():
        if isinstance(w, dict):
            _compare_trees(got[key], w, rel, path + (key,))
        elif not (path[-1:] == ("key",) and key == "bias"):
            scale = max(float(np.abs(w).max()), 1e-12)
            np.testing.assert_allclose(got[key], w, atol=rel * scale, rtol=0, err_msg="/".join(path + (key,)))


def test_sharded_step_loss_and_every_gradient_equal_jax():
    cfg = EncoderConfig.tiny()
    params = jenc.init_params(jenc.EncoderConfig.tiny())
    start = _numpy_tree(params)  # the JAX step donates its state
    batch = _batch(np.random.default_rng(0), cfg.vocab_size)
    mesh = jmesh.train_mesh()
    opt = _keep_grads()
    jstep, jplace = jtrain.make_sharded_train_step(jenc.EncoderConfig.tiny(), opt, mesh)
    sharded = jtrain.shard_params(params, mesh)
    jstate, jloss = jstep(jtrain.TrainState(sharded, opt.init(sharded)), jplace(batch))

    model = ttrain.shard_params(_port_model(start), port_mesh())
    placed = model.place_params()
    q = model.encode(placed, batch["q_ids"], batch["q_mask"])
    p = model.encode(placed, batch["p_ids"], batch["p_mask"])
    loss = ttrain.info_nce_loss(collectives.all_gather(q, "cpu", 0), collectives.all_gather(p, "cpu", 0), 0.05)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    got = params_to_jax(model.gather_state_dict(grads=True))["params"]
    _compare_trees(got, _numpy_tree(jstate.opt_state)["params"], 1e-5)


def test_sharded_train_steps_track_jax_and_one_device():
    """Five steps on train_mesh (4, 2) over a fixed batch: the JAX test's
    setup (AdamW at 1e-3; both packages at weight decay 0.01, the port's
    trainers' setting). The losses fall."""
    cfg = EncoderConfig.tiny()
    params = jenc.init_params(jenc.EncoderConfig.tiny())
    start = _numpy_tree(params)
    batch = _batch(np.random.default_rng(0), cfg.vocab_size)
    mesh = jmesh.train_mesh()
    assert mesh.shape == {"data": 4, "model": 2}
    opt = optax.adamw(LR, weight_decay=0.01)
    jstep, jplace = jtrain.make_sharded_train_step(jenc.EncoderConfig.tiny(), opt, mesh)
    sharded = jtrain.shard_params(params, mesh)
    jstate, jbatch = jtrain.TrainState(sharded, opt.init(sharded)), jplace(batch)

    tmesh = port_mesh()
    assert tmesh.shape == {"data": 4, "model": 2}
    model = ttrain.shard_params(_port_model(start), tmesh)
    state = ttrain.TrainState(model, *ttrain.make_optimizer(model, LR))
    step, place = ttrain.make_sharded_train_step(cfg, tmesh)
    tbatch = place(batch)
    assert [t.shape for t in tbatch["q_ids"]] == [(2, 16)] * 4
    single = _port_model(start)
    sstate = ttrain.TrainState(single, *ttrain.make_optimizer(single, LR))
    sstep = ttrain.make_train_step(cfg)
    sbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    losses = []
    for i in range(5):
        jstate, jloss = jstep(jstate, jbatch)
        state, loss = step(state, tbatch)
        _, sloss = sstep(sstate, sbatch)
        assert not loss.requires_grad
        np.testing.assert_allclose(float(loss), float(sloss), rtol=1e-5, err_msg=f"step {i} against one device")
        # 1e-5 while the drift allows it (steps 1-3; module docstring), the single-device twin's 1e-4 after
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5 if i < 3 else 1e-4,
                                   err_msg=f"step {i} against JAX")
        losses.append(float(loss))
    assert state.step == 5 and int(jstate.step) == 5
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    got = model.gather_state_dict()
    for name, want in single.state_dict().items():  # the key biases' noise aside, as in the single-device twin
        if not name.endswith("attention.key.bias"):
            np.testing.assert_allclose(got[name].numpy(), want.numpy(), atol=1e-4, rtol=0, err_msg=name)


def _grads(step, model, batch, gather) -> dict:
    """One step's gradients at ``model``'s weights (an optimizer that takes
    no step; ``apply_update``'s ``zero_grad`` then frees nothing)."""
    keep = torch.optim.SGD(model.parameters(), lr=0.0)
    keep.zero_grad = lambda set_to_none=True: None
    step(ttrain.TrainState(model, keep), batch)
    return gather(model)


def _distance(got: dict, want: dict) -> dict:
    return {n: float(torch.linalg.vector_norm(got[n] - w) / torch.linalg.vector_norm(w).clamp_min(1e-30))
            for n, w in want.items()}


def test_sharded_bf16_gradient_is_as_close_to_f32_as_one_devices():
    """In bf16 compute, the sharded step's first gradient, leaf by leaf, lies
    no further from the f32 step's than 2.5 times one device's bf16
    gradient does (the bar of ``chip_smoke.py`` phase 14 (c)): the shards'
    partial products round differently from one device's, not worse."""
    cfg32 = EncoderConfig.tiny()
    cfg = dataclasses.replace(cfg32, dtype="bfloat16")
    start = _numpy_tree(jenc.init_params(jenc.EncoderConfig.tiny(), seed=3))
    batch = {k: torch.from_numpy(v) for k, v in _batch(np.random.default_rng(3), cfg.vocab_size).items()}
    by_name = lambda m: {n: p.grad for n, p in m.named_parameters()}  # noqa: E731
    want = _grads(ttrain.make_train_step(cfg32), _port_model(start, cfg32), batch, by_name)
    single = _distance(_grads(ttrain.make_train_step(cfg), _port_model(start, cfg), batch, by_name), want)
    mesh = port_mesh(2, 2)
    sharded = ttrain.shard_params(_port_model(start, cfg), mesh)
    got = _distance(_grads(ttrain.make_sharded_train_step(cfg, mesh)[0], sharded, batch,
                           lambda m: m.gather_state_dict(grads=True)), want)
    assert 1e-3 < min(single.values()) and max(single.values()) < 1e5  # bf16 rounding, not f32's
    ratio = {n: got[n] / single[n] for n in want}
    assert max(ratio.values()) <= 2.5, sorted(ratio.items(), key=lambda kv: -kv[1])[:4]


def test_sharded_step_repeats_bit_equal():
    cfg = EncoderConfig.tiny()
    start = _numpy_tree(jenc.init_params(jenc.EncoderConfig.tiny(), seed=1))
    batch = _batch(np.random.default_rng(1), cfg.vocab_size)
    runs = []
    for _ in range(2):
        model = ttrain.shard_params(_port_model(start), port_mesh(2, 2))
        state = ttrain.TrainState(model, *ttrain.make_optimizer(model, LR))
        step, _ = ttrain.make_sharded_train_step(cfg, port_mesh(2, 2))
        losses = [step(state, batch)[1] for _ in range(3)]
        runs.append((torch.stack(losses), model.gather_state_dict()))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(runs[0][1][k], runs[1][1][k]) for k in runs[0][1])


def test_tp_param_layout():
    """``test_parallel.py::test_tp_param_layout``: the column-parallel query
    kernel splits its output dim, mlp_output its input dim, embeddings
    replicate. The port's weights are ``[out, in]``: its specs are the JAX
    kernels' transposed. The column-parallel biases, which the JAX spec
    replicates (GSPMD slices them in the computation), split here."""
    cfg = EncoderConfig.tiny()
    params = jenc.init_params(jenc.EncoderConfig.tiny())
    jparams = jtrain.shard_params(params, jmesh.train_mesh())["params"]
    assert tuple(jparams["layer_0"]["attention"]["query"]["kernel"].sharding.spec) == (None, "model")
    assert tuple(jparams["layer_0"]["mlp_output"]["kernel"].sharding.spec) == ("model", None)
    model = _port_model(params)
    specs = ttrain.param_shardings(model, port_mesh())
    assert specs["layers.0.attention.query.weight"] == ("model", None)
    assert specs["layers.0.mlp_output.weight"] == (None, "model")
    assert specs["layers.0.attention.query.bias"] == ("model",)
    assert specs["layers.0.mlp_output.bias"] == () and specs["word_emb.weight"] == ()
    sharded = ttrain.shard_params(model, port_mesh())
    q = model.state_dict()["layers.0.attention.query.weight"]
    for t, part in enumerate(q.chunk(2)):
        assert torch.equal(sharded.slices[t]["layers__0__attention__query__weight"], part)
    assert sharded.slices[0]["layers__0__mlp_output__weight"].shape == (64, 64)
    assert sharded.replicated["word_emb__weight"].shape == (cfg.vocab_size, 64)
    gathered = sharded.gather_state_dict()
    assert all(torch.equal(gathered[k], v) for k, v in model.state_dict().items())
    # the masters are copies of their own, contiguous (the fused optimizer on the card needs a
    # parameter's strides to match its gradient's), and training them leaves the model alone
    assert all(p.is_contiguous() and p.dtype == torch.float32 for p in sharded.parameters())
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        for p in sharded.parameters():
            p.add_(1.0)
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())


@pytest.mark.parametrize("dp,tp", [(1, 1), (2, 2), (1, 4), (4, 2)])
def test_sharded_forward_equals_one_device(dp, tp):
    cfg = EncoderConfig.tiny()
    model = _port_model(_numpy_tree(jenc.init_params(jenc.EncoderConfig.tiny(), seed=2)))
    rng = np.random.default_rng(4)
    ids = torch.from_numpy(rng.integers(4, cfg.vocab_size, (8, 24)))
    mask = torch.ones((8, 24), dtype=torch.long)
    mask[3, 10:] = 0
    sharded = ttrain.shard_params(model, port_mesh(dp, tp))
    with torch.no_grad():
        np.testing.assert_allclose(sharded(ids, mask).numpy(), model(ids, mask).numpy(), atol=1e-5)
        hidden = sharded(ids, mask, pool=False).numpy()
        np.testing.assert_allclose(hidden[mask.bool().numpy()], model(ids, mask, pool=False).numpy()[mask.bool().numpy()],
                                   atol=1e-5)


def test_sharded_step_on_the_flash_route_counts_a_call_a_layer_a_shard_a_group():
    """Passages of S 128 at flash_min_len 128 (head width 64): each TP
    shard's attention takes the flash route over its H/tp heads, forward
    and backward, once a layer a shard a DP group; the step equals the
    single-device step."""
    cfg = EncoderConfig(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4, intermediate_size=256,
                        max_position=132, dtype="float32", flash_min_len=128)
    model = TextEncoder(cfg, device="cpu", param_dtype=torch.float32).init_flax(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    batch = _batch(rng, cfg.vocab_size, b=4, s=16)
    batch["p_ids"] = rng.integers(4, cfg.vocab_size, (4, 128)).astype(np.int32)
    batch["p_mask"] = (np.arange(128)[None] < np.array([[128], [100], [80], [64]])).astype(np.int32)
    single = TextEncoder(cfg, device="cpu", param_dtype=torch.float32)
    single.load_state_dict(model.state_dict())
    sstate = ttrain.TrainState(single, *ttrain.make_optimizer(single, LR))
    mesh = port_mesh(2, 2)
    sharded = ttrain.shard_params(model, mesh)
    state = ttrain.TrainState(sharded, *ttrain.make_optimizer(sharded, LR))
    step, _ = ttrain.make_sharded_train_step(cfg, mesh)
    tflash.flash_attention_plain.calls.reset()
    tflash.flash_attention_backward_plain.calls.reset()
    _, loss = step(state, batch)
    assert tflash.flash_attention_plain.calls.count == cfg.num_layers * 2 * 2
    assert tflash.flash_attention_backward_plain.calls.count == cfg.num_layers * 2 * 2
    _, sloss = ttrain.make_train_step(cfg)(sstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(sloss), rtol=1e-5)


def test_sharded_step_refuses_indivisible_tp_and_another_config():
    cfg = EncoderConfig.tiny()
    model = _port_model(_numpy_tree(jenc.init_params(jenc.EncoderConfig.tiny())))
    with pytest.raises(ValueError, match="must divide"):
        ttrain.shard_params(model, train_mesh(["cpu"] * 8, model_parallel=8))
    with pytest.raises(ValueError, match="must divide"):
        ttrain.param_shardings(model, train_mesh(["cpu"] * 8, model_parallel=8))
    with pytest.raises(ValueError, match="multiple"):
        ttrain.make_sharded_train_step(cfg, port_mesh())[1]({"q_ids": np.zeros((6, 4), np.int32)})
    state = ttrain.TrainState(ttrain.shard_params(model, port_mesh()), torch.optim.SGD([torch.zeros(1)], lr=0.1))
    step, _ = ttrain.make_sharded_train_step(dataclasses.replace(cfg, num_layers=1), port_mesh())
    with pytest.raises(ValueError, match="another config"):
        step(state, _batch(np.random.default_rng(0), cfg.vocab_size))


def test_collectives_backward_sums_in_shard_order_and_repeats_bit_equal():
    """``broadcast``'s gradient is the copies' gradients summed in shard
    order, ``reduce``'s the output's copied to each input: both equal the
    order written out by hand, bit for bit, on every repeat."""
    rng = np.random.default_rng(6)
    x0 = torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32))
    ws = [torch.from_numpy(rng.standard_normal((7, 7)).astype(np.float32) * 10 ** i) for i in range(-3, 4)]
    grads = []
    for _ in range(3):
        x = x0.clone().requires_grad_()
        copies = collectives.broadcast(x, ["cpu"] * len(ws))
        assert all(c.data_ptr() == x.data_ptr() for c in copies)  # a view on the same device, not a copy
        out = collectives.reduce([c @ w for c, w in zip(copies, ws)], "cpu")
        out.pow(2).sum().backward()
        grads.append(x.grad)
    per_copy = [(2 * out.detach()) @ w.T for w in ws]
    by_hand = per_copy[0].clone()
    for g in per_copy[1:]:
        by_hand += g
    assert all(torch.equal(g, by_hand) for g in grads)
    total = sum(c @ w for c, w in zip([x0] * len(ws), ws))
    np.testing.assert_allclose(out.detach().numpy(), total.numpy(), rtol=1e-6)

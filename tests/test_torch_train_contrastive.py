"""Contrastive training: the port's ``train/contrastive.py`` against the
JAX package's on the same seeded inputs. Loss and gradient, the learning
rate schedule against optax's, ``tokenize_pairs``, five AdamW steps of
``make_train_step`` from the same f32 parameters and batch against
``optax.adamw`` (a short-row config, and a 2-layer config whose rows of
S 128 reach the flash-attention Function on the port's side), and the
cached-pool trainer against the JAX trainer on one pool."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from intool_rag_tpu.eval.synthetic import make_relevance_task as jax_make_relevance_task
from intool_rag_tpu.models import encoder as jenc
from intool_rag_tpu.models.tokenizer import SimpleTokenizer as JaxTokenizer
from intool_rag_tpu.train import contrastive as jtrain
from intool_rag_tpu_torch.models.encoder import EncoderConfig, TextEncoder, params_from_jax, params_to_jax
from intool_rag_tpu_torch.models.tokenizer import SimpleTokenizer
from intool_rag_tpu_torch.ops import flash_attention as tflash
from intool_rag_tpu_torch.train import contrastive as ttrain

torch.set_num_threads(2)


def _numpy_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _unit(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("b,temperature", [(4, 0.05), (16, 0.05), (7, 1.0)])
def test_info_nce_loss_value_and_gradient(b, temperature):
    rng = np.random.default_rng(b)
    q, p = _unit(rng, (b, 32)), _unit(rng, (b, 32))
    want, (gq, gp) = jax.value_and_grad(jtrain.info_nce_loss, argnums=(0, 1))(
        jnp.asarray(q), jnp.asarray(p), temperature)
    tq, tp = torch.from_numpy(q).requires_grad_(), torch.from_numpy(p).requires_grad_()
    loss = ttrain.info_nce_loss(tq, tp, temperature)
    loss.backward()
    assert abs(float(loss.detach()) - float(want)) <= 1e-6
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(gq), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(gp), atol=1e-6, rtol=0)


@pytest.mark.parametrize("steps", [21, 100, 800, 1200, 4000])
def test_schedule_matches_optax(steps):
    """lr(count) / lr against ``optax.warmup_cosine_decay_schedule`` at ten
    step counts, the first update's zero rate and the flat tail included."""
    lr = 1e-3
    want = optax.warmup_cosine_decay_schedule(
        0.0, lr, warmup_steps=max(20, steps // 20), decay_steps=steps, end_value=lr * 0.05)
    factor = ttrain.warmup_cosine_factor(steps)
    warmup = max(20, steps // 20)
    for count in (0, 1, warmup - 1, warmup, warmup + 1, (warmup + steps) // 2, steps - 1, steps, steps + 1, 2 * steps):
        # optax computes the rate in f32: 2e-7 of the peak rate covers its rounding
        assert abs(factor(count) - float(want(count)) / lr) <= 2e-7, (steps, count)
    assert factor(0) == 0.0 and abs(factor(3 * steps) - 0.05) <= 1e-12


def test_schedule_needs_more_steps_than_its_warmup():
    with pytest.raises(ValueError):  # optax refuses the same: no decay steps are left
        ttrain.warmup_cosine_factor(20)


def test_lambda_lr_follows_the_schedule_one_step_behind_like_optax():
    """optax evaluates the schedule at the number of updates already made;
    so does ``LambdaLR`` when it is stepped after the optimizer."""
    model = torch.nn.Linear(2, 2)
    optimizer, scheduler = ttrain.make_optimizer(model, 1e-3, steps=100)
    factor = ttrain.warmup_cosine_factor(100)
    seen = []
    for _ in range(30):
        seen.append(optimizer.param_groups[0]["lr"])
        optimizer.step()
        scheduler.step()
    np.testing.assert_allclose(seen, [1e-3 * factor(c) for c in range(30)], rtol=1e-12)
    assert len(optimizer.param_groups) == 1 and optimizer.param_groups[0]["weight_decay"] == 0.01
    assert optimizer.param_groups[0]["betas"] == (0.9, 0.999) and optimizer.param_groups[0]["eps"] == 1e-8


def test_tokenize_pairs_equal_arrays():
    queries = ["qtop3 ctx1", "annual report figure", "x"]
    passages = ["dtop3 ctx1 report annual figure section page table", "note value", "entry item record " * 20]
    for max_len in (8, 32):
        want = jtrain.tokenize_pairs(JaxTokenizer(vocab_size=1024, max_length=24), queries, passages, max_len=max_len)
        got = ttrain.tokenize_pairs(SimpleTokenizer(vocab_size=1024, max_length=24), queries, passages, max_len=max_len)
        assert set(got) == set(want) == {"q_ids", "q_mask", "p_ids", "p_mask"}
        for key in want:
            assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key]), key


def _batch(rng, vocab: int, b: int, s: int) -> dict:
    def rows():
        ids = rng.integers(4, vocab, (b, s)).astype(np.int32)
        lengths = rng.integers(s // 2, s + 1, size=(b, 1))
        lengths[0] = s
        mask = (np.arange(s)[None] < lengths).astype(np.int32)
        ids = np.where(mask > 0, ids, 1).astype(np.int32)
        ids[:, 0] = 0
        return ids, mask

    q_ids, q_mask = rows()
    p_ids, p_mask = rows()
    return {"q_ids": q_ids, "q_mask": q_mask, "p_ids": p_ids, "p_mask": p_mask}


FLASH_CONFIG = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256,
                    max_position=132, dtype="float32", flash_min_len=128)


@pytest.mark.parametrize("name,s", [("tiny", 16), ("flash", 128)])
def test_five_adamw_steps_match_optax(name, s):
    """Same f32 parameters, same batch, five steps under the warm-up of the
    trainers' schedule (peak rate 2e-3). Found: the losses agree to 2e-6
    relative at every step, and after five steps that move the parameters
    by 1.0e-3 all but a few values agree to 7e-6; the largest difference,
    2.4e-5, sits where a gradient is itself rounding noise and Adam's
    division by its root turns the noise into a step (bounds: rtol 1e-4,
    atol 1e-4). The key biases are left out of the
    parameter comparison: a softmax does not see a constant added to every
    logit of a row, so their true gradient is zero, what either framework
    computes there is rounding noise, and Adam normalises noise to full-size
    steps; they do not move the function."""
    kw = dict(FLASH_CONFIG) if name == "flash" else dataclasses.asdict(EncoderConfig.tiny())
    jcfg = jenc.EncoderConfig(**kw)
    tcfg = EncoderConfig(**kw)
    steps, lr = 100, 2e-3
    params = jenc.init_params(jcfg, seed=3)
    batch = _batch(np.random.default_rng(s), jcfg.vocab_size, 4, s)

    schedule = optax.warmup_cosine_decay_schedule(0.0, lr, warmup_steps=20, decay_steps=steps, end_value=lr * 0.05)
    optimizer = optax.adamw(schedule, weight_decay=0.01)
    jstate = jtrain.TrainState(params, optimizer.init(params))
    jstep = jax.jit(jtrain.make_train_step(jcfg, optimizer))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    model = TextEncoder(tcfg, device="cpu", param_dtype=torch.float32)
    model.load_state_dict(params_from_jax(_numpy_tree(params)))
    tstate = ttrain.TrainState(model.train(), *ttrain.make_optimizer(model, lr, steps))
    tstep = ttrain.make_train_step(tcfg)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tflash.flash_attention_backward_plain.calls.reset()

    for i in range(5):
        jstate, jloss = jstep(jstate, jbatch)
        tstate, tloss = tstep(tstate, tbatch)
        assert not tloss.requires_grad
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4, err_msg=f"step {i}")
    assert tstate.step == 5 and int(jstate.step) == 5
    # the flash config's passages and queries (S 128 = flash_min_len) went through the Function's backward
    assert tflash.flash_attention_backward_plain.calls.count == (2 * 2 * 5 if name == "flash" else 0)

    got = params_to_jax(model.state_dict())["params"]
    want = _numpy_tree(jstate.params)["params"]
    start = _numpy_tree(params)["params"]
    moved = 0.0

    def compare(g, w, s0, path):
        nonlocal moved
        for key in w:
            if isinstance(w[key], dict):
                compare(g[key], w[key], s0[key], path + (key,))
            elif path[-1:] == ("key",) and key == "bias":
                continue
            else:
                moved = max(moved, float(np.abs(w[key] - s0[key]).max()))
                np.testing.assert_allclose(g[key], w[key], atol=1e-4, rtol=0, err_msg="/".join(path + (key,)))

    compare(got, want, start, ())
    assert moved > 9e-4  # the steps did move the parameters, ten times the tolerance


def test_train_step_refuses_another_config():
    cfg = EncoderConfig.tiny()
    model = TextEncoder(dataclasses.replace(cfg, num_layers=1), device="cpu", param_dtype=torch.float32)
    state = ttrain.TrainState(model, *ttrain.make_optimizer(model, 1e-3))
    with pytest.raises(ValueError):
        ttrain.make_train_step(cfg)(state, {})


def _jax_path(name: str) -> list[str]:
    """A :class:`TextEncoder` state-dict name as its JAX params path."""
    *path, leaf = name.split(".")
    if path[0] == "layers":
        path = [f"layer_{path[1]}", *path[2:]]
    if leaf == "weight":
        leaf = "embedding" if path[-1].endswith("_emb") else "scale" if path[-1].endswith("_ln") else "kernel"
    return [*path, leaf]


@pytest.mark.parametrize("name", ["param_shardings", "shard_params", "make_sharded_train_step"])
def test_sharded_step_is_not_ported(name):
    """The three names of the DP+TP step against the JAX package's, on
    ``train_mesh`` (data 4, model 2) over 8 devices (JAX's virtual CPUs, 8
    ``cpu`` entries for the port), from the same parameters: the split of
    every parameter (the port's ``[out, in]`` weights split the other dim;
    the column-parallel biases split where the JAX spec replicates them and
    GSPMD slices them), the sharded forward (1e-5), and one step's loss
    (1e-5 relative) and updated parameters (1e-4, the key biases aside, as
    in the five-step case above). ``test_torch_parallel_train.py`` holds the
    rest."""
    from intool_rag_tpu.parallel.mesh import train_mesh as jax_train_mesh
    from intool_rag_tpu_torch.parallel.mesh import train_mesh

    cfg = EncoderConfig.tiny()
    jcfg = jenc.EncoderConfig.tiny()
    params = jenc.init_params(jcfg, seed=4)
    start = _numpy_tree(params)
    model = TextEncoder(cfg, device="cpu", param_dtype=torch.float32)
    model.load_state_dict(params_from_jax(start))
    jmesh, tmesh = jax_train_mesh(), train_mesh(["cpu"] * 8)
    batch = _batch(np.random.default_rng(9), cfg.vocab_size, 8, 16)
    if name == "param_shardings":
        want = jtrain.param_shardings(params, jmesh)
        got = ttrain.param_shardings(model, tmesh)
        assert len(got) == len(jax.tree.leaves(want))
        for tname, spec in got.items():
            node = want["params"]
            for key in _jax_path(tname):
                node = node[key]
            jspec = tuple(node.spec)
            if tname.endswith(".weight") and len(jspec) == 2:  # a kernel: the port's [out, in] is its transpose
                assert spec == jspec[::-1], (tname, spec, jspec)
            elif tname.split(".")[-2] in ("query", "key", "value", "intermediate"):  # a column-parallel bias
                assert jspec == () and spec == ("model",), tname
            else:
                assert jspec == () and spec == (), tname
    elif name == "shard_params":
        jsharded = jtrain.shard_params(params, jmesh)
        want = np.asarray(jax.jit(jenc.TextEncoder(jcfg).apply)(jsharded, batch["p_ids"], batch["p_mask"]))
        sharded = ttrain.shard_params(model, tmesh)
        assert isinstance(sharded, ttrain.ShardedEncoder) and (sharded.dp, sharded.tp) == (4, 2)
        with torch.no_grad():
            got = sharded(torch.from_numpy(batch["p_ids"]), torch.from_numpy(batch["p_mask"]))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
        assert all(torch.equal(v, model.state_dict()[k]) for k, v in sharded.gather_state_dict().items())
    else:
        optimizer = optax.adamw(1e-3, weight_decay=0.01)
        jstep, jplace = jtrain.make_sharded_train_step(jcfg, optimizer, jmesh)
        jsharded = jtrain.shard_params(params, jmesh)
        jstate, jloss = jstep(jtrain.TrainState(jsharded, optimizer.init(jsharded)), jplace(batch))
        sharded = ttrain.shard_params(model, tmesh)
        tstate = ttrain.TrainState(sharded, *ttrain.make_optimizer(sharded, 1e-3))
        step, place = ttrain.make_sharded_train_step(cfg, tmesh)
        tstate, tloss = step(tstate, place(batch))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        got = params_to_jax(sharded.gather_state_dict())["params"]
        want_tree = _numpy_tree(jstate.params)["params"]

        def compare(g, w, path):
            for key in w:
                if isinstance(w[key], dict):
                    compare(g[key], w[key], path + (key,))
                elif not (path[-1:] == ("key",) and key == "bias"):
                    np.testing.assert_allclose(g[key], w[key], atol=1e-4, rtol=0, err_msg="/".join(path + (key,)))

        compare(got, want_tree, ())


def test_cached_trainer_falls_into_the_jax_trainers_band():
    """~100 steps on one pool from the same initial parameters; the two draw
    other batches (``torch.Generator`` against ``jax.random``). Found over
    three seeds each: the JAX trainer's last mean is 0.26-0.31, the port's
    0.27-0.30, from 2.06 at the start; band: within 35 % of the JAX
    trainer's last mean, and under half of the first mean on both sides."""
    cfg_kw = dict(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
                  max_position=40, dtype="float32")
    task = jax_make_relevance_task(np.random.default_rng(5), n_train_queries=120)
    keep = task.train_labels > 0
    queries = [q for q, k in zip(task.train_queries, keep) if k]
    passages = [p for p, k in zip(task.train_passages, keep) if k]
    pool = ttrain.tokenize_pairs(SimpleTokenizer(vocab_size=1024, max_length=32), queries, passages, max_len=24)
    jcfg = jenc.EncoderConfig(**cfg_kw)
    init = jenc.init_params(jcfg, seed=0)
    kw = dict(steps=100, batch=32, lr=1e-3, steps_per_launch=25)
    _, jmeans = jtrain.train_encoder_cached(jcfg, pool, init=init, **kw)
    model, tmeans = ttrain.train_encoder_cached(
        EncoderConfig(**cfg_kw), pool, init=params_from_jax(_numpy_tree(init)), device="cpu", **kw)
    assert tmeans.shape == jmeans.shape == (4,)
    assert tmeans[-1] < 0.5 * tmeans[0] and jmeans[-1] < 0.5 * jmeans[0], (tmeans, jmeans)
    assert abs(tmeans[-1] - jmeans[-1]) <= 0.35 * jmeans[-1], (tmeans, jmeans)
    assert next(model.parameters()).dtype == torch.float32 and not model.training


def test_cached_trainer_is_repeatable_from_its_seed():
    cfg = EncoderConfig.tiny()
    rng = np.random.default_rng(0)
    ids = rng.integers(4, cfg.vocab_size, (64, 12)).astype(np.int32)
    pool = {"q_ids": ids, "q_mask": np.ones_like(ids), "p_ids": ids[:, ::-1].copy(), "p_mask": np.ones_like(ids)}
    runs = [ttrain.train_encoder_cached(cfg, pool, steps=22, batch=8, steps_per_launch=11, seed=4, device="cpu")[1]
            for _ in range(2)]
    assert runs[0].shape == (2,) and np.array_equal(runs[0], runs[1])
    other = ttrain.train_encoder_cached(cfg, pool, steps=22, batch=8, steps_per_launch=11, seed=5, device="cpu")[1]
    assert not np.array_equal(runs[0], other)

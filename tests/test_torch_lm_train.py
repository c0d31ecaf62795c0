"""models/lm_train.py of the PyTorch port against the JAX package's.

The JAX weights come across with ``decoder_state_from_flax``; gradients
are held against ``jax.value_and_grad`` of the JAX package's own train
step (an optax transformation that keeps the gradients as its state), the
optimizer pieces against optax. The port runs with device="cpu"."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from intool_rag_tpu.models import decoder as jdec
from intool_rag_tpu.models import lm_train as jlm
from intool_rag_tpu_torch.models import decoder as tdec
from intool_rag_tpu_torch.models import lm_train as tlm
from intool_rag_tpu_torch.train.contrastive import TrainState, clip_by_global_norm_

torch.set_num_threads(2)
JCFG = jdec.DecoderConfig.tiny()
TCFG = tdec.DecoderConfig.tiny()


def _state(tree) -> dict[str, torch.Tensor]:
    return tdec.decoder_state_from_flax(jax.tree.map(lambda x: np.asarray(x, np.float32), tree))


def _capture_grads():
    """An optax transformation whose update is zero and whose state is the
    gradient it was given: the JAX step then returns its exact gradients."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads),
    )


@pytest.mark.parametrize("seed,b,s", [(0, 4, 24), (1, 3, 17)])
def test_one_step_loss_and_every_gradient_match_jax(seed, b, s):
    """Through the serving forward (its in-place KV cache included): loss
    and each parameter's gradient within rtol 1e-5 of ``jax.value_and_grad``."""
    params = jdec.init_decoder_params(JCFG, seed=seed)
    batch = jlm.copy_task_batch(np.random.default_rng(seed), b, s, JCFG.vocab_size)
    step = jlm.make_train_step(JCFG, _capture_grads())
    _, grads, loss = step(params, _capture_grads().init(params), jnp.asarray(batch))
    want = _state(grads)

    model = tdec.DecoderLM(TCFG, device="cpu", param_dtype=torch.float32)
    model.load_state_dict(_state(params))
    got_loss = tlm.lm_loss(model, torch.as_tensor(batch))
    got_loss.backward()
    assert float(got_loss.detach()) == pytest.approx(float(loss), rel=1e-5)
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        scale = float(np.abs(want[name].numpy()).max())
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=name)


def _five_steps(warmup, clip):
    params = jdec.init_decoder_params(JCFG, seed=4)
    batches = [jlm.copy_task_batch(np.random.default_rng(i), 4, 20, JCFG.vocab_size) for i in range(5)]
    jparams, jlosses = jlm.train_lm(JCFG, batches, lr=3e-3, init_params=params, warmup=warmup, clip=clip)
    model, losses = tlm.train_lm(TCFG, batches, lr=3e-3, init_params=_state(params), warmup=warmup, clip=clip,
                                 device="cpu")
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5, atol=0)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    return params, batches, model.state_dict(), _state(jparams)


@pytest.mark.parametrize("warmup,clip", [(2, 0.5), (3, 50.0)])
def test_five_steps_with_warmup_and_clip_track_jax(warmup, clip):
    """``train_lm`` from the JAX initial weights on the same batches: every
    loss within 1e-5, every parameter within 1e-5 after five steps (clip
    0.5 clips every step here, 50 none)."""
    _, _, got, want = _five_steps(warmup, clip)
    for name, p in got.items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-5, rtol=0, err_msg=name)


def test_five_steps_without_warmup_track_jax_but_adam_amplified_noise():
    """Without warm-up the first update runs at the full rate, and Adam
    scales it by ``g / (|g| + eps)``: where the first gradient is ~1e-8,
    its rounding noise (up to 20 % of it, two frameworks summing in
    another order) becomes a step difference of up to ``lr`` · 0.02. Every
    loss holds 1e-5 and every parameter whose first gradient is 0 or above
    1e-6 holds 1e-5; the few others hold ``lr`` · 0.05."""
    params, batches, got, want = _five_steps(0, None)
    _, grads, _ = jlm.make_train_step(JCFG, _capture_grads())(
        params, _capture_grads().init(params), jnp.asarray(batches[0]))
    first = _state(grads)
    noisy = 0
    for name, p in got.items():
        g0 = np.abs(first[name].numpy())
        quiet = (g0 > 0) & (g0 < 1e-6)  # exact zeros (embedding rows no token used) stay exact
        noisy += int(quiet.sum())
        diff = np.abs(p.numpy() - want[name].numpy())
        assert diff[~quiet].max(initial=0.0) <= 1e-5, name
        assert diff[quiet].max(initial=0.0) <= 0.05 * 3e-3, name
    assert noisy < 100  # a handful of ~40,000 weights


@pytest.mark.parametrize("lr,warmup", [(3e-3, 4), (1e-2, 1), (2e-3, 0)])
def test_warmup_rate_matches_optax_linear_schedule(lr, warmup):
    """The rate of every update (stepped after the optimizer) equals
    ``optax.linear_schedule(0, lr, warmup)`` at the updates already made."""
    model = tdec.DecoderLM(TCFG, device="cpu", param_dtype=torch.float32)
    optimizer, scheduler = tlm.make_optimizer(model, lr, warmup)
    want = optax.linear_schedule(0.0, lr, warmup) if warmup else (lambda count: lr)
    assert (scheduler is None) == (warmup == 0)
    for count in range(warmup + 3):
        assert optimizer.param_groups[0]["lr"] == pytest.approx(float(want(count)), rel=1e-6, abs=1e-12)
        optimizer.step()
        if scheduler is not None:
            scheduler.step()


@pytest.mark.parametrize("max_norm", [0.1, 3.0, 1e3])
def test_clip_matches_optax_clip_by_global_norm(max_norm):
    rng = np.random.default_rng(int(max_norm * 10))
    grads = [rng.standard_normal(shape).astype(np.float32) for shape in [(5, 3), (7,), (2, 2, 2)]]
    want = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], optax.EmptyState())[0]
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    norm = clip_by_global_norm_(params, max_norm)
    assert float(norm) == pytest.approx(float(optax.global_norm([jnp.asarray(g) for g in grads])), rel=1e-6)
    for p, w in zip(params, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6, atol=0)
    # not clip_grad_norm_'s max_norm / (norm + 1e-6)
    if max_norm < float(norm):
        assert float(torch.stack([q.grad.norm() for q in params]).norm()) == pytest.approx(max_norm, rel=1e-6)


@pytest.mark.parametrize("seed", [0, 5])
def test_batches_and_prompts_equal(seed):
    for fn, args, kw in [
        ("copy_task_batch", (6, 40, 64), {}),
        ("copy_task_batch", (3, 9, 20), {"sep_id": 2, "lo": 3}),
        ("rag_qa_batch", (5, 56, 96), {"n_fields": 3, "val_len": 7}),
        ("rag_qa_batch", (2, 30, 50), {}),
    ]:
        want = getattr(jlm, fn)(np.random.default_rng(seed), *args, **kw)
        got = getattr(tlm, fn)(np.random.default_rng(seed), *args, **kw)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    want = jlm.rag_qa_prompts(np.random.default_rng(seed), 8, 96, n_fields=3, val_len=7)
    got = tlm.rag_qa_prompts(np.random.default_rng(seed), 8, 96, n_fields=3, val_len=7)
    assert got == want


def test_bf16_step_runs_with_f32_master_weights():
    """A bf16 config trains with f32 master weights: finite loss, f32
    gradients, and the loss falls on a repeated batch."""
    cfg = dataclasses.replace(TCFG, dtype="bfloat16")
    model = tdec.DecoderLM(cfg, device="cpu", param_dtype=torch.float32)
    model.init_random(torch.Generator().manual_seed(0))
    state = TrainState(model, *tlm.make_optimizer(model, 3e-3))
    step = tlm.make_train_step(cfg, clip=1.0)
    batch = torch.as_tensor(tlm.copy_task_batch(np.random.default_rng(0), 4, 32, cfg.vocab_size))
    losses = [float(step(state, batch)) for _ in range(6)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(p.dtype == torch.float32 for p in model.parameters()) and state.step == 6
    with pytest.raises(ValueError, match="config"):
        tlm.make_train_step(TCFG)(state, batch)


def test_train_lm_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tlm.train_copy_lm(TCFG, steps=1)


# ---------------- slow twins of tests/test_scheduler.py's acceptance tests ----------------

SPEC_CONFIG = dict(hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2, intermediate_size=128,
                   max_position=512, dtype="float32")
SPEC_VOCAB = {"copy": 64, "rag_qa": 96}


def write_spec_init(path=tlm.SPEC_INIT) -> None:
    """The JAX acceptance tests' initial weights (``init_decoder_params(...,
    seed=0)`` of both configs) in the port's names, as float32 npz."""
    arrays = {}
    for task, vocab in SPEC_VOCAB.items():
        params = jdec.init_decoder_params(jdec.DecoderConfig(vocab_size=vocab, **SPEC_CONFIG), seed=0)
        arrays.update({f"{task}/{k}": v.numpy() for k, v in _state(params).items()})
    np.savez_compressed(path, **arrays)


def test_spec_init_fixture_equals_its_builder(tmp_path):
    """The committed initial weights are the JAX package's seed-0 draws."""
    write_spec_init(tmp_path / "spec.npz")
    for task in SPEC_VOCAB:
        want = tlm.spec_init(task, path=tmp_path / "spec.npz")
        got = tlm.spec_init(task)
        assert set(got) == set(want)
        for name in want:
            assert torch.equal(got[name], want[name]), name
        tdec.DecoderLM(tdec.DecoderConfig(vocab_size=SPEC_VOCAB[task], **SPEC_CONFIG), device="cpu",
                       param_dtype=torch.float32).load_state_dict(got)


@pytest.mark.slow
def test_speculative_speedup_on_copy_model():
    """The port's twin of ``test_speculative_speedup_on_copy_model``: a
    2-layer copy model trained by ``train_copy_lm`` from the JAX test's
    initial weights quotes its prompt, and prompt-lookup waves through the
    scheduler accept ≥ 2 tokens a wave with the plain waves' tokens."""
    from intool_rag_tpu_torch.models.scheduler import ContinuousGenerator

    config = tdec.DecoderConfig(vocab_size=64, **SPEC_CONFIG)
    model, losses = tlm.train_copy_lm(config, steps=700, batch=32, seq=48, seed=0, init_params=tlm.spec_init("copy"),
                                      device="cpu")
    assert losses[-1] < 0.35 * losses[0], losses[-1]
    seqs = tlm.copy_task_batch(np.random.default_rng(42), 6, 40, config.vocab_size)
    prompts = [row.tolist() for row in seqs]
    limits = [24] * len(prompts)
    want, _ = ContinuousGenerator(model, n_slots=3, seg_len=4).generate_many(prompts, limits)
    hit = np.mean([np.isin(np.asarray(w), np.asarray(p)).mean() for w, p in zip(want, prompts)])
    assert hit >= 0.9, f"copy model does not quote: {hit}"
    spec = ContinuousGenerator(model, n_slots=3, seg_len=4, speculative_gamma=4, lookup_window=64)
    got, stats = spec.generate_many(prompts, limits)
    assert got == want
    assert stats["tokens_per_wave"] >= 2.0, stats


@pytest.mark.slow
def test_speculative_acceptance_on_rag_qa():
    """The port's twin of ``test_speculative_acceptance_on_rag_qa``, from
    the JAX test's initial weights (the bar of 1.5 tokens a wave depends on
    the draw: the JAX trainer reads 1.89, 1.13 and 1.76 from its seeds 0, 1
    and 2 on the CPU)."""
    from intool_rag_tpu_torch.models.scheduler import ContinuousGenerator

    config = tdec.DecoderConfig(vocab_size=96, **SPEC_CONFIG)
    val_len = 7
    model, losses = tlm.train_rag_qa_lm(config, steps=800, batch=32, seq=56, seed=0, n_fields=3,
                                        val_len=val_len, init_params=tlm.spec_init("rag_qa"), device="cpu")
    assert losses[-1] < 0.75 * losses[0], (losses[0], losses[-1])
    prompts, answers = tlm.rag_qa_prompts(np.random.default_rng(123), 8, 96, n_fields=3, val_len=val_len)
    limits = [val_len + 3] * len(prompts)
    want, _ = ContinuousGenerator(model, n_slots=4, seg_len=4).generate_many(prompts, limits)
    quote_frac = np.mean([np.isin(np.asarray(w), np.asarray(p)).mean() for w, p in zip(want, prompts)])
    assert quote_frac >= 0.8, (quote_frac, want[:2], answers[:2])
    spec = ContinuousGenerator(model, n_slots=4, seg_len=4, speculative_gamma=4, lookup_window=64)
    got, stats = spec.generate_many(prompts, limits)
    assert got == want
    assert stats["tokens_per_wave"] >= 1.5, stats


if __name__ == "__main__":
    # rebuild the committed initial weights:
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_lm_train.py
    write_spec_init()
    print(f"wrote {tlm.SPEC_INIT}")

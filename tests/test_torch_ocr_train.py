"""ocr/train.py of the PyTorch port against the JAX package's.

Losses and gradients: the port's three losses through the port's models
against the same losses through the JAX package's flax models (the CTC and
the classifier's cross-entropy are optax's own functions; the detector's
balanced BCE + dice is the JAX trainer's formula) with the weights carried
across, in float64 (JAX under ``jax.enable_x64``), to 1e-9. The JAX
trainers themselves then run one step on their own rendered data and the
port's render + step stages reproduce their first loss from the same
initial weights in float32. Schedules are held against optax step by step.
The cached trainers' augmentations draw from a torch generator (the JAX
package draws ``jax.random`` keys), so they are held to their ranges. The
port runs with device="cpu".
"""

from __future__ import annotations

import functools
import io
import lzma

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from intool_rag_tpu.ocr import models as jmodels
from intool_rag_tpu.ocr import train as jtrain
from intool_rag_tpu_torch.ocr import models as tmodels
from intool_rag_tpu_torch.ocr import train as ttrain
from intool_rag_tpu_torch.ocr.synth import build_charset
from intool_rag_tpu_torch.train.contrastive import warmup_cosine_factor

torch.set_num_threads(2)
F64_TOL = 1e-9


@functools.lru_cache(maxsize=1)
def fixture():
    return ttrain.load_train_fixture()


def _carried(jmodel, params, tmodel):
    tmodel.load_state_dict(tmodels.ocr_state_from_flax(jax.tree.map(np.asarray, params), tmodel))
    return tmodel


def _jax_det_loss(prob, pos):
    """The JAX detector trainer's loss (``ocr/train.py:83-96``), as written there."""
    prob = jnp.clip(prob, 1e-6, 1 - 1e-6)
    n_pos = jnp.maximum(pos.sum(), 1.0)
    n_neg = jnp.maximum((1 - pos).sum(), 1.0)
    w_pos = n_neg / n_pos
    bce = -(w_pos * pos * jnp.log(prob) + (1 - pos) * jnp.log(1 - prob))
    bce = bce.sum() / (w_pos * n_pos + n_neg)
    inter = (prob * pos).sum()
    return bce + 1.0 - 2.0 * inter / (prob.sum() + pos.sum() + 1.0)


def _det_case(rng):
    x = rng.random((2, 64, 64, 3)).astype(np.float32)
    maps = np.zeros((2, 32, 32), np.float32)
    maps[0, 4:10, 3:28] = 1.0
    maps[1, 20:26, 8:30] = 1.0
    return jmodels.DBDetector(4), tmodels.DBDetector(4), (x, maps), (1, 64, 64, 3)


def _cls_case(rng):
    x = rng.random((5, 32, 64, 3)).astype(np.float32)
    return jmodels.OrientationClassifier(4), tmodels.OrientationClassifier(4), (x, np.array([0, 1, 1, 0, 1])), (
        1, 32, 64, 3)


def _rec_case(rng, arch="conv"):
    x, lab, pad = fixture()["digit_batches"][0]
    return (jmodels.make_recognizer(arch, 10, 8, col_stride=2), tmodels.make_recognizer(arch, 10, 8, col_stride=2),
            (x[:4, :, :96], lab[:4], pad[:4]), (1, 32, 64, 3))


def _jax_loss(kind, model, p, batch):
    if kind == "det":
        return _jax_det_loss(model.apply(p, batch[0]), batch[1])
    if kind == "cls":
        return optax.softmax_cross_entropy_with_integer_labels(model.apply(p, batch[0]), batch[1]).mean()
    logits = model.apply(p, batch[0])
    return optax.ctc_loss(logits, jnp.zeros(logits.shape[:2], logits.dtype), batch[1], batch[2],
                          blank_id=logits.shape[-1] - 1).mean()


def _torch_loss(kind, model, batch):
    if kind == "det":
        return ttrain.detector_loss(model(batch[0]), batch[1])
    if kind == "cls":
        return ttrain.classifier_loss(model(batch[0]), batch[1])
    logits = model(batch[0])
    return ttrain.ctc_loss(logits, batch[1], batch[2], blank=logits.shape[-1] - 1)


@pytest.mark.parametrize("kind,arch", [("det", None), ("cls", None), ("rec", "conv"), ("rec", "svtr"), ("rec", "crnn")])
def test_loss_and_every_gradient_match_jax_in_f64(kind, arch):
    rng = np.random.default_rng(3)
    cases = {"det": _det_case, "cls": _cls_case}
    jmodel, tmodel, batch, init_shape = cases[kind](rng) if kind in cases else _rec_case(rng, arch)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(1), jnp.zeros(init_shape))
    _carried(jmodel, params, tmodel).double()
    f64 = [np.asarray(b, np.float64) if np.asarray(b).dtype.kind == "f" else np.asarray(b) for b in batch]
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
        loss, grads = jax.value_and_grad(lambda p: _jax_loss(kind, jmodel, p, [jnp.asarray(b) for b in f64]))(p64)
        loss, grads = float(loss), jax.tree.map(np.asarray, grads)
    got = _torch_loss(kind, tmodel, [torch.from_numpy(b) for b in f64])
    got.backward()
    assert abs(float(got.detach()) - loss) <= F64_TOL * max(1.0, abs(loss))
    want = tmodels.ocr_state_from_flax(grads, tmodel)  # the gradient tree in the port's names and layouts
    for name, p in tmodel.named_parameters():
        w = want[name].numpy()
        assert np.abs(p.grad.numpy() - w).max() <= F64_TOL * max(1.0, np.abs(w).max()), name


def test_ctc_impossible_alignment_costs_zero_where_optax_is_finite():
    """A label longer than the frames: optax returns a large finite loss,
    torch's CTC inf; the port takes ``zero_infinity`` (0, no gradient)."""
    logits = np.random.default_rng(0).standard_normal((2, 3, 5)).astype(np.float32)
    labels = np.array([[0, 1, 2, 3], [1, 1, 0, 0]], np.int32)
    pad = np.array([[0, 0, 0, 0], [0, 0, 1, 1]], np.float32)  # row 0: 4 labels in 3 frames
    want = np.asarray(optax.ctc_loss(jnp.asarray(logits), jnp.zeros((2, 3)), labels, pad, blank_id=4))
    assert np.isfinite(want).all() and want[0] > 1e3
    t = torch.from_numpy(logits).requires_grad_()
    loss = ttrain.ctc_loss(t, torch.from_numpy(labels), torch.from_numpy(pad), blank=4)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(want[1] / 2, rel=1e-5)  # row 1 alone, row 0 zero
    assert torch.isfinite(t.grad).all() and (t.grad[0] == 0).all()


def _first_losses_match(jlosses, tlosses):
    assert len(tlosses) == len(jlosses)
    np.testing.assert_allclose(tlosses[0], jlosses[0], rtol=2e-4)  # float32 models: ~1e-4 apart


def test_detector_trainer_first_loss_matches_jax():
    """The JAX trainer renders its own pages; the port's render stage draws
    the same pages from the same seed and its step stage gives the same
    first loss from the same weights."""
    model = jmodels.DBDetector(4)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 96, 96, 3)))
    _, _, jl = jtrain.train_synthetic_detector("0123456789abc", steps=2, batch=2, page_size=96, width=4,
                                               init_params=params)
    tm, tl = ttrain.train_synthetic_detector("0123456789abc", steps=2, batch=2, page_size=96, width=4,
                                             init_params=_carried(model, params, tmodels.DBDetector(4)).state_dict(),
                                             device="cpu")
    _first_losses_match(jl, tl)
    assert not tm.training


def test_classifier_trainer_first_loss_matches_jax():
    charset = "0123456789abcdefghijklmnop"
    _, _, jl = jtrain.train_synthetic_classifier(charset, steps=1, batch=6, width=4, seed=2)
    model = jmodels.OrientationClassifier(4)
    params = jax.jit(model.init)(jax.random.PRNGKey(2), jnp.zeros((1, 32, 64, 3)))  # the trainer's own init
    tmodel = _carried(model, params, tmodels.OrientationClassifier(4))
    rng = np.random.default_rng(2)
    tl = ttrain.classifier_steps(tmodel, [ttrain.render_classifier_batch(rng, charset, 6)])
    _first_losses_match(jl, tl)


@pytest.mark.parametrize("augment", [False, True])
def test_recognizer_trainer_first_loss_matches_jax(augment):
    model = jmodels.make_recognizer("conv", 10, 8)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 64, 3)))
    _, _, _, jl = jtrain.train_synthetic_recognizer(steps=2, batch=4, width=8, augment=augment, init_params=params)
    state = _carried(model, params, tmodels.make_recognizer("conv", 10, 8)).state_dict()
    _, charset, tl = ttrain.train_synthetic_recognizer(steps=2, batch=4, width=8, augment=augment,
                                                       init_params=state, device="cpu")
    assert charset == "0123456789"
    _first_losses_match(jl, tl)


@pytest.mark.parametrize("steps", [120, 200, 2600, 40_000])
def test_cached_schedule_matches_optax(steps):
    """The cached trainers' rate: warm-up ``max(50, steps // 50)``, cosine to
    0.02·lr; the per-step trainer's past 2,000 steps: ``max(20, steps // 20)``,
    to 0.01·lr. Every count of the run and past its end."""
    lr = 1.5e-3
    cases = [(max(50, steps // 50), 0.02)] + ([(max(20, steps // 20), 0.01)] if steps >= 2000 else [])
    for warmup, alpha in cases:
        want = optax.warmup_cosine_decay_schedule(0.0, lr, warmup_steps=warmup, decay_steps=steps,
                                                  end_value=lr * alpha)
        factor = warmup_cosine_factor(steps, warmup=warmup, alpha=alpha)
        counts = np.unique(np.r_[np.arange(0, steps + 3, max(1, steps // 300)), warmup - 1, warmup, steps])
        got = np.array([factor(int(c)) for c in counts])
        np.testing.assert_allclose(got * lr, np.asarray(jax.vmap(want)(jnp.asarray(counts))), rtol=2e-6, atol=1e-12)
        assert factor(0) == 0.0


def test_schedule_needs_more_steps_than_its_warmup():
    """optax refuses the same: no decay steps are left (why a cached run
    takes more than 50 steps)."""
    with pytest.raises(ValueError):
        warmup_cosine_factor(50, warmup=50, alpha=0.02)


def test_render_text_image_and_pad_batch_equal():
    images = [ttrain.render_text_image(t) for t in ("0123", "90210", "777", "Total due 1250")]
    want = [jtrain.render_text_image(t) for t in ("0123", "90210", "777", "Total due 1250")]
    for a, b in zip(images, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ttrain._pad_batch(images), jtrain._pad_batch(want))
    np.testing.assert_array_equal(ttrain.render_text_image("Invoice", height=48),
                                  jtrain.render_text_image("Invoice", height=48))
    np.testing.assert_array_equal(ttrain._pad_batch(images, 16), jtrain._pad_batch(want, 16))


def test_augmentation_draws_stay_in_their_ranges():
    pool = torch.from_numpy(fixture()["rec_images"][:64])
    gen = torch.Generator().manual_seed(0)
    idx = torch.randint(0, pool.shape[0], (32,), generator=gen)
    assert 0 <= int(idx.min()) and int(idx.max()) < pool.shape[0]
    batch = ttrain.pool_batch(pool, idx)
    assert tuple(batch.shape) == (32, 32, 320, 3) and float(batch.max()) <= 1.0
    torch.testing.assert_close(batch[..., 0], pool[idx].float() / 255.0)
    out, d = ttrain.augment_batch(batch, gen)
    assert tuple(out.shape) == tuple(batch.shape) and 0.0 <= float(out.min()) and float(out.max()) <= 1.0
    for name, lo, hi in (("contrast", 0.8, 1.15), ("bright", -0.08, 0.08), ("blur", 0.0, 0.85), ("scale", 0.78, 1.0)):
        v = d[name]
        assert float(v.min()) >= lo and float(v.max()) < hi, name
        assert float(v.max() - v.min()) > 0.3 * (hi - lo), name  # the draws spread over the range
    assert abs(float(d["noise"].std()) - 0.02) < 2e-3 and abs(float(d["noise"].mean())) < 1e-3
    assert 0 <= int(d["src"].min()) and int(d["src"].max()) <= 319
    assert (d["src"][:, 0] == 0).all()  # compression only: column 0 stays, text never leaves the canvas
    assert 0.2 < float(d["use"].float().mean()) < 0.8
    # one seed, one draw
    a, _ = ttrain.augment_batch(batch, torch.Generator().manual_seed(7))
    b, _ = ttrain.augment_batch(batch, torch.Generator().manual_seed(7))
    assert torch.equal(a, b) and not torch.equal(a, out)


def test_pool_steps_train_on_the_fixture():
    """The cached step stages on the committed pools: finite losses, one a
    step, the classifier's falling."""
    fx = fixture()
    rec = tmodels.make_recognizer("conv", len(fx["charset"]), 8)
    losses = ttrain.recognizer_pool_steps(rec, fx["rec_images"][:64], fx["rec_labels"][:64],
                                          fx["rec_label_pad"][:64], blank=len(fx["charset"]), steps=60, batch=8,
                                          steps_per_launch=30)
    assert len(losses) == 60 and np.isfinite(losses).all() and not rec.training
    cls = tmodels.OrientationClassifier(4)
    losses = ttrain.classifier_pool_steps(cls, fx["cls_images"], fx["cls_labels"], steps=120, batch=16,
                                          steps_per_launch=40, lr=5e-3)
    assert len(losses) == 120 and np.mean(losses[-20:]) < np.mean(losses[:20])


def test_fixture_equals_its_builder():
    """The committed training data is what ``build_train_fixture`` renders
    (PIL and the DejaVu faces, here)."""
    built = ttrain.build_train_fixture()
    with np.load(io.BytesIO(lzma.decompress(ttrain.TRAIN_FIXTURE.read_bytes()))) as z:
        assert set(z.files) == set(built)
        for name, want in built.items():
            np.testing.assert_array_equal(z[name], want, err_msg=name)
    fx = fixture()
    assert fx["charset"] == build_charset()
    assert fx["det_images"].shape == (16, 448, 448) and fx["det_maps"].shape == (16, 224, 224)
    assert len(fx["digit_batches"]) == 250 and ttrain.TRAIN_FIXTURE.stat().st_size < 3e6


def test_digit_batches_are_the_jax_digits_run():
    """The fixture's digit batches are the JAX digits test's own batches
    (its trainer's render from seed 0), to 1/510 of uint8."""
    rng = np.random.default_rng(0)
    from intool_rag_tpu.ocr.synth import random_text

    for i, (x, lab, pad) in enumerate(fixture()["digit_batches"][:3]):
        texts = [random_text(rng, "0123456789", 3, 6) for _ in range(16)]
        want = jtrain._pad_batch([jtrain.render_text_image(t, font_size=22) for t in texts])
        assert x.shape == want.shape, i
        assert np.abs(x - want).max() <= 0.5 / 255 + 1e-6
        want_lab, want_pad = ttrain.encode_labels(texts, ttrain.DIGITS, 6)
        np.testing.assert_array_equal(lab, want_lab)
        np.testing.assert_array_equal(pad, want_pad)


def test_a_bundle_trained_by_the_port_loads_in_jax(tmp_path):
    """A few steps of each step stage on the fixture, saved by the port,
    read by the JAX package's ``OCRModelBundle.load``: equal forwards."""
    from intool_rag_tpu.ocr.models import OCRModelBundle as JBundle

    fx = fixture()
    det, cls_model = tmodels.DBDetector(4), tmodels.OrientationClassifier(4)
    rec = tmodels.make_recognizer("conv", 10, 8)
    ttrain.detector_steps(det, [(np.repeat(fx["det_images"][:2, :128, :128, None] / np.float32(255), 3, 3),
                                 fx["det_maps"][:2, :64, :64])] * 2)
    ttrain.classifier_steps(cls_model, [(np.repeat(fx["cls_images"][:8, :, :, None] / np.float32(255), 3, 3),
                                         fx["cls_labels"][:8])] * 2)
    ttrain.recognizer_steps(rec, fx["digit_batches"][:3], blank=10)
    bundle = tmodels.OCRModelBundle(det, cls_model, rec, "0123456789")
    bundle.save(tmp_path / "trained.npz")
    loaded = JBundle.load(tmp_path / "trained.npz")
    x = fx["digit_batches"][5][0]
    want = np.asarray(loaded.rec.apply(loaded.rec_params, x))
    with torch.no_grad():
        got = rec(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * max(1.0, float(np.abs(want).max()))
    assert loaded.charset == "0123456789"


def test_step_stages_run_without_pil(tmp_path):
    """The card's machine has neither PIL nor the fonts: ``ocr.train``
    imports, the fixture loads and every step stage runs; only the
    renderers need PIL."""
    import subprocess
    import sys
    from pathlib import Path

    code = """
import sys
sys.modules["PIL"] = None
import numpy as np
from intool_rag_tpu_torch.ocr import models, train
fx = train.load_train_fixture()
rec = models.make_recognizer("conv", 10, 8).to("cpu")
assert len(train.recognizer_steps(rec, fx["digit_batches"][:2], blank=10)) == 2
cls = models.OrientationClassifier(4)
assert len(train.classifier_pool_steps(cls, fx["cls_images"][:32], fx["cls_labels"][:32], steps=51, batch=4,
                                       steps_per_launch=51)) == 51
try:
    train.render_text_image("x")
except ImportError:
    print("ok")
"""
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-2000:]


def test_trainers_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.train_synthetic_recognizer(steps=1)


# ---------------- slow twins of tests/test_ocr.py's training cases ----------------


def _reads_digits(model, charset):
    from intool_rag_tpu_torch.ocr.postprocess import ctc_greedy_decode

    images = ttrain._pad_batch([ttrain.render_text_image(t) for t in ttrain.DIGIT_TESTS])
    with torch.no_grad():
        logits = model(torch.from_numpy(images)).numpy()
    decoded = ctc_greedy_decode(logits, charset)
    return sum(got == want for (got, _), want in zip(decoded, ttrain.DIGIT_TESTS)), decoded


@pytest.mark.slow
@pytest.mark.parametrize("arch,steps", [("conv", 250), ("svtr", 300), ("crnn", 300)])
def test_train_and_read_synthetic_digits(arch, steps):
    """The twins of ``test_train_and_read_synthetic_digits`` (conv),
    ``test_svtr_recognizer_trains_and_reads`` and
    ``test_crnn_recognizer_trains_and_reads``: the CTC loss falls below
    a fifth of its first value and 2 of 3 clean test strings read."""
    model, charset, losses = ttrain.train_synthetic_recognizer(steps=steps, batch=16, seed=0, augment=False,
                                                               arch=arch, device="cpu")
    assert type(model).__name__ == {"conv": "CTCRecognizer", "svtr": "SVTRRecognizer", "crnn": "CRNNRecognizer"}[arch]
    assert losses[-1] < losses[0] * 0.2, f"CTC loss did not converge: {losses[-1]}"
    correct, decoded = _reads_digits(model, charset)
    assert correct >= 2, f"decoded {decoded} vs {ttrain.DIGIT_TESTS}"

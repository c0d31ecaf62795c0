"""The OCR models of the port against the JAX package's flax modules, on the
shipped weights (both packages read ``intool_rag_tpu/ocr/weights/default.npz``).

Tolerances. In float64 (JAX under ``jax.enable_x64``, the port's modules
in ``double()``) every forward agrees to 1e-9: the layouts, the "SAME"
padding, the norms' ε, the attention and the parameter mapping are the
same arithmetic. In float32, the serving precision, det prob maps and cls
logits agree to 1e-4. rec logits agree to 1e-4 of the largest |logit|:
on white-background crops the JAX package's own float32 rec is ~3e-3 from
its float64 value (flax GroupNorm's E[x²] − E[x]² on activations with a
large mean), so no float32 summation order does better than that.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

F64_TOL = 1e-9
F32_TOL = 1e-4

torch.set_num_threads(2)


@functools.lru_cache(maxsize=1)
def jax_bundle():
    """The JAX package's shipped bundle, its parameter trees read with
    ``flax.serialization.msgpack_restore`` (the same leaves
    ``OCRModelBundle.load`` restores, without its 20 s of flax init)."""
    import json

    import flax.serialization as ser

    from intool_rag_tpu.ocr.models import DBDetector, OCRModelBundle, OrientationClassifier, make_recognizer
    from intool_rag_tpu.ocr.pipeline import DEFAULT_WEIGHTS

    with np.load(DEFAULT_WEIGHTS) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode("utf-8"))
        trees = {k: jax.device_put(ser.msgpack_restore(z[k].tobytes())) for k in ("det", "cls", "rec")}
    rec = make_recognizer(meta.get("rec_arch", "conv"), len(meta["charset"]), meta["rec_width"],
                          col_stride=meta["rec_stride"])
    return OCRModelBundle(DBDetector(meta["width"]), trees["det"], OrientationClassifier(meta["width"]),
                          trees["cls"], rec, trees["rec"], meta["charset"], meta.get("rec_h", 32))


@functools.lru_cache(maxsize=1)
def torch_bundle():
    from intool_rag_tpu_torch.ocr.models import OCRModelBundle
    from intool_rag_tpu_torch.ocr.pipeline import DEFAULT_WEIGHTS

    return OCRModelBundle.load(DEFAULT_WEIGHTS)


def _inputs(kind: str) -> np.ndarray:
    """Seeded inputs of the pipeline's own kinds: a rendered page for det,
    a batch of rendered lines as ``_batch_crops`` pads them for cls / rec,
    and uniform noise."""
    from intool_rag_tpu_torch.ocr.pipeline import OCREngine
    from intool_rag_tpu_torch.ocr.synth import DEFAULT_FONTS, business_text, render_line, render_page

    rng = np.random.default_rng(5)
    if kind == "page":
        img, _ = render_page(rng, torch_bundle().charset, size=320)
        return img[None].astype(np.float32)
    if kind == "noise":
        return rng.random((2, 32, 96, 3), dtype=np.float32)
    crops = []
    for i in range(6):
        ink = render_line(business_text(rng, torch_bundle().charset), font_path=DEFAULT_FONTS[i],
                          font_size=int(rng.integers(16, 30)))
        crops.append(np.repeat((1.0 - ink)[:, :, None], 3, axis=2))
    engine = OCREngine.__new__(OCREngine)  # _batch_crops reads no engine state
    return engine._batch_crops(crops, target_h=32)


def _models(name: str):
    jb, tb = jax_bundle(), torch_bundle()
    return {"det": (jb.det, jb.det_params, tb.det), "cls": (jb.cls, jb.cls_params, tb.cls),
            "rec": (jb.rec, jb.rec_params, tb.rec)}[name]


def _run_both(jmodel, jparams, tmodel, x: np.ndarray, f64: bool) -> tuple[np.ndarray, np.ndarray]:
    if f64:
        with jax.enable_x64(True):
            p64 = jax.tree.map(lambda a: np.asarray(a, np.float64), jparams)
            want = np.asarray(jax.jit(jmodel.apply)(p64, x.astype(np.float64)))
        assert want.dtype == np.float64
        with torch.no_grad():
            got = tmodel.double()(torch.from_numpy(x.astype(np.float64))).numpy()
        tmodel.float()
        return got, want
    want = np.asarray(jax.jit(jmodel.apply)(jparams, x))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    return got, want


CASES = [("det", "page"), ("det", "noise"), ("cls", "crops"), ("cls", "noise"), ("rec", "crops"), ("rec", "noise")]


@pytest.mark.parametrize("model,inputs", CASES)
def test_forward_f64_matches_jax(model, inputs):
    got, want = _run_both(*_models(model), _inputs(inputs), f64=True)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= F64_TOL


@pytest.mark.parametrize("model,inputs", CASES)
def test_forward_f32_matches_jax(model, inputs):
    got, want = _run_both(*_models(model), _inputs(inputs), f64=False)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    tol = F32_TOL * max(1.0, float(np.abs(want).max())) if model == "rec" else F32_TOL
    assert np.abs(got - want).max() <= tol


def test_shapes_follow_the_jax_contract():
    """det [B, H, W, 3] → [B, H/2, W/2] (odd sizes too), rec
    [B, 32, W, 3] → [B, W/2, 205] at col_stride 1."""
    tb = torch_bundle()
    with torch.no_grad():
        assert tuple(tb.det(torch.ones(1, 70, 45, 3)).shape) == (1, 35, 23)
        assert tuple(tb.cls(torch.zeros(3, 32, 72, 3)).shape) == (3, 2)
        assert tuple(tb.rec(torch.zeros(2, 32, 96, 3)).shape) == (2, 48, len(tb.charset) + 1)
    jb = jax_bundle()
    assert jax.eval_shape(jb.det.apply, jb.det_params, np.ones((1, 70, 45, 3), np.float32)).shape == (1, 35, 23)


@pytest.mark.parametrize("part,leaves", [("det", 37), ("cls", 13), ("rec", 25)])
def test_every_flax_leaf_lands_on_one_parameter(part, leaves):
    from intool_rag_tpu_torch.ocr.models import _leaves, ocr_state_from_flax

    tree = getattr(jax_bundle(), f"{part}_params")
    module = getattr(torch_bundle(), part)
    assert len(list(_leaves(tree))) == len(module.state_dict()) == leaves
    state = ocr_state_from_flax(jax.tree.map(np.asarray, tree), module)
    assert set(state) == set(module.state_dict())


@pytest.mark.parametrize("change", ["missing", "extra", "shape"])
def test_state_from_flax_refuses_a_tree_that_does_not_fit(change):
    from intool_rag_tpu_torch.ocr.models import ocr_state_from_flax

    tree = jax.tree.map(np.asarray, jax_bundle().cls_params)
    params = {k: dict(v) for k, v in tree["params"].items()}
    if change == "missing":
        del params["Dense_1"]
    elif change == "extra":
        params["Dense_2"] = {"kernel": np.zeros((2, 2), np.float32), "bias": np.zeros(2, np.float32)}
    else:
        params["Dense_1"]["kernel"] = np.zeros((64, 3), np.float32)
    with pytest.raises(ValueError):
        ocr_state_from_flax({"params": params}, torch_bundle().cls)


def jax_bundle_created(charset: str, *, width: int, rec_width: int, rec_arch: str, rec_h: int, seed: int = 0):
    """``OCRModelBundle.create`` of the JAX package with each model's
    ``init`` jitted (the same parameter trees; eager flax init takes ~30 s
    here)."""
    import jax.numpy as jnp

    from intool_rag_tpu.ocr.models import DBDetector, OCRModelBundle, OrientationClassifier, make_recognizer

    rng = jax.random.PRNGKey(seed)
    det, cls_model = DBDetector(width), OrientationClassifier(width)
    rec = make_recognizer(rec_arch, len(charset), rec_width, col_stride=1)
    return OCRModelBundle(
        det, jax.jit(det.init)(rng, jnp.zeros((1, 64, 64, 3))),
        cls_model, jax.jit(cls_model.init)(rng, jnp.zeros((1, 32, 64, 3))),
        rec, jax.jit(rec.init)(rng, jnp.zeros((1, rec_h, 64, 3))), charset, rec_h)


@pytest.mark.parametrize("arch", ["svtr", "crnn"])
def test_recognizer_zoo_matches_jax_with_weights_carried_across(arch):
    """The JAX package's recognizer from ``make_recognizer`` with its own
    initial values, the weights carried into the port's."""
    import jax.numpy as jnp

    from intool_rag_tpu.ocr.models import make_recognizer as jmake
    from intool_rag_tpu_torch.ocr.models import make_recognizer, ocr_state_from_flax

    charset = "0123456789abcdefghij :."
    jrec = jmake(arch, len(charset), 40, col_stride=1)  # rounded up to 48
    params = jax.jit(jrec.init)(jax.random.PRNGKey(3), jnp.zeros((1, 32, 64, 3)))
    rec = make_recognizer(arch, len(charset), 40, col_stride=1)
    assert type(rec).__name__ == type(jrec).__name__ and rec.width == jrec.width == 48
    rec.load_state_dict(ocr_state_from_flax(jax.tree.map(np.asarray, params), rec))
    rec.eval()
    x = _inputs("crops")[:, :, :160]
    got, want = _run_both(jrec, params, rec, x, f64=True)
    assert np.abs(got - want).max() <= F64_TOL
    got, want = _run_both(jrec, params, rec, x, f64=False)
    assert np.abs(got - want).max() <= F32_TOL * max(1.0, float(np.abs(want).max()))


def test_bundle_saved_by_the_port_loads_in_jax(tmp_path):
    from intool_rag_tpu.ocr.models import OCRModelBundle as JBundle

    path = tmp_path / "port.npz"
    torch_bundle().save(path)
    loaded = JBundle.load(path)
    jb = jax_bundle()
    assert loaded.charset == jb.charset and loaded.rec_h == jb.rec_h
    assert (loaded.rec.width, loaded.rec.col_stride, loaded.det.width) == (jb.rec.width, jb.rec.col_stride, 16)
    for part in ("det", "cls", "rec"):  # the same leaves, bit for bit
        a = jax.tree.map(np.asarray, getattr(loaded, f"{part}_params"))
        b = jax.tree.map(np.asarray, getattr(jb, f"{part}_params"))
        assert jax.tree.structure(a) == jax.tree.structure(b)
        assert all(np.array_equal(x, y) for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))
    x = _inputs("crops")
    apply = jax.jit(jb.rec.apply)
    np.testing.assert_array_equal(np.asarray(apply(loaded.rec_params, x)), np.asarray(apply(jb.rec_params, x)))


def test_bundle_saved_by_jax_loads_in_the_port(tmp_path):
    from intool_rag_tpu_torch.ocr.models import OCRModelBundle

    charset = "abcdefghijklmnop 0123"
    jb = jax_bundle_created(charset, width=8, rec_width=32, rec_arch="conv", rec_h=48, seed=1)
    jb.save(tmp_path / "jax.npz")
    tb = OCRModelBundle.load(tmp_path / "jax.npz")
    assert (tb.charset, tb.rec_h, tb.det.width, tb.rec.width, tb.rec.col_stride) == (charset, 48, 8, 32, 1)
    x = np.random.default_rng(2).random((2, 48, 64, 3), dtype=np.float32)
    for part in ("det", "cls", "rec"):
        xi = x[:, :32] if part == "cls" else x
        got, want = _run_both(getattr(jb, part), getattr(jb, f"{part}_params"), getattr(tb, part), xi, f64=True)
        assert np.abs(got - want).max() <= F64_TOL, part


@pytest.mark.parametrize("arch", ["svtr", "crnn"])
def test_port_bundle_round_trips(tmp_path, arch):
    """save → load in the port keeps the architecture, the meta and every
    parameter bit for bit."""
    from intool_rag_tpu_torch.ocr.models import OCRModelBundle

    tb = OCRModelBundle.create("xyz 01", seed=4, width=8, rec_width=40, rec_col_stride=1, rec_arch=arch, rec_h=48)
    tb.save(tmp_path / "b.npz")
    back = OCRModelBundle.load(tmp_path / "b.npz")
    assert (back.charset, back.rec_h, type(back.rec), back.rec.width) == ("xyz 01", 48, type(tb.rec), 48)
    for part in ("det", "cls", "rec"):
        a, b = getattr(tb, part).state_dict(), getattr(back, part).state_dict()
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)

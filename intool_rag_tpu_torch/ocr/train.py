"""OCR training: synthetic pages → trained det / cls / rec models (port of
``intool_rag_tpu/ocr/train.py``).

The DB detector trains on rendered pages (balanced BCE + dice on the
shrunk-quad probability map), the orientation classifier on 0°/180° crops
and the CTC recognizer on rendered strings. ``train_full_ocr`` returns a
complete :class:`~.models.OCRModelBundle`, which ``bundle.save`` writes in
the format both packages read (``python -m intool_rag_tpu_torch.ocr.train
[out]``).

Every trainer is a RENDER stage on the host (PIL and the DejaVu faces,
imported inside the renderers, as ``synth`` does) and a STEP stage on the
models' device (default CUDA). The public functions keep the JAX
signatures and compose the two; the step stages also run alone on data
rendered elsewhere (the committed fixture of ``TRAIN_FIXTURE``, for a
machine with neither PIL nor the fonts). Render stages draw from the same
``numpy`` generator as the JAX package's, so where PIL exists they render
the same data. The optimizer is ``torch.optim.Adam`` with optax's
``adam`` defaults, and the cached trainers' warm-up + cosine rate is
``optax.warmup_cosine_decay_schedule`` (``train.contrastive.warmup_cosine_factor``).
The cached trainers' augmentations draw from a ``torch.Generator`` on the
device, where the JAX package draws ``jax.random`` keys: same ranges, other
draws. Returned models are the trained modules (they hold their
parameters) in eval mode: ``(model, losses)`` where the JAX functions
return ``(model, params, losses)``.

Differences (``ROADMAP.md`` Queue C): an impossible CTC alignment (a label
longer than the frames allow) costs 0 here, with no gradient
(``zero_infinity``), where optax returns a large finite value;
``train_classifier_cached`` builds its pool at height 32 (the JAX function
names an undefined ``rec_h`` there and raises).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Callable, Iterable

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..train.contrastive import ADAM, TrainState, apply_update, warmup_cosine_factor
from .models import OCRModelBundle, DBDetector, OrientationClassifier, make_recognizer

logger = logging.getLogger(__name__)

TRAIN_FIXTURE = Path(__file__).parent / "fixtures" / "ocr_train.npz.xz"  # an npz, xz-compressed
DIGITS = "0123456789"
DIGIT_TESTS = ("0123", "90210", "777")
# the JAX package's font mix for the cached pools: serif upweighted
FONT_PROBS = np.array([0.15, 0.13, 0.25, 0.13, 0.21, 0.13])


# ---------------- host rendering ----------------


def render_text_image(text: str, *, height: int = 32, font_size: int = 22) -> np.ndarray:
    """Render text to an RGB float crop [height, W, 3] in [0, 1], white
    background / dark ink: the polarity page crops have after
    ``crop_quad``."""
    from .postprocess import resize_norm_crop
    from .synth import render_line

    ink = render_line(text, font_size=font_size)
    crop = np.repeat((1.0 - ink)[:, :, None], 3, axis=2)
    return resize_norm_crop(crop, target_h=height, max_w=4096)[
        :, : max(8, int(round(ink.shape[1] * height / ink.shape[0])))
    ]


def _pad_batch(images: list[np.ndarray], width_mult: int = 32) -> np.ndarray:
    h = images[0].shape[0]
    max_w = max(im.shape[1] for im in images)
    max_w = -(-max_w // width_mult) * width_mult
    out = np.zeros((len(images), h, max_w, 3), np.float32)
    for i, im in enumerate(images):
        out[i, :, : im.shape[1]] = im[:, :max_w]
    return out


def _jitter_pad(rng: np.random.Generator, ink: np.ndarray) -> np.ndarray:
    """Mild framing jitter: serving crops are ink-tightened with ~8 %
    margin, so train on that geometry."""
    h0 = ink.shape[0]
    return np.pad(ink, (
        (int(rng.integers(0, max(1, int(0.12 * h0)))), int(rng.integers(0, max(1, int(0.12 * h0))))),
        (int(rng.integers(0, max(1, int(0.06 * h0)))), int(rng.integers(0, max(1, int(0.06 * h0))))),
    ))


def render_detector_batch(rng: np.random.Generator, charset: str, batch: int = 4, *, page_size: int = 448,
                          max_rotation: float = 15.0, rot90_frac: float = 0.15):
    """One detector batch: pages, upright or rotated (uniform ±max_rotation
    and occasional 90°), degraded, with their ground-truth maps. Returns
    ``(images [B, S, S, 3], maps [B, S/2, S/2])`` f32."""
    from .synth import degrade_page, gt_prob_map, render_page

    imgs, maps = [], []
    for _ in range(batch):
        r = rng.random()
        if r < 1.0 - rot90_frac - 0.40:
            rot = 0.0
        elif r < 1.0 - rot90_frac:
            rot = float(rng.uniform(-max_rotation, max_rotation))
        else:
            rot = float(rng.choice([90.0, -90.0]))
        img, gt = render_page(rng, charset, size=page_size, rotation=rot, per_line_jitter=1.0,
                              font_sizes=(14, 48))
        imgs.append(degrade_page(rng, img, p_blur=0.3, p_jpeg=0.3))
        maps.append(gt_prob_map(gt, page_size))
    return np.stack(imgs), np.stack(maps)


def render_classifier_batch(rng: np.random.Generator, charset: str, batch: int = 32):
    """One classifier batch of rendered line crops, half of them turned
    180° (label 1). Returns ``(images [B, 32, 160, 3] f32, labels [B] i32)``."""
    from .postprocess import resize_norm_crop
    from .synth import DEFAULT_FONTS, random_text, render_line

    images = np.zeros((batch, 32, 160, 3), np.float32)
    labels = np.zeros(batch, np.int32)
    for i in range(batch):
        text = random_text(rng, charset, 4, 10)
        fs = int(rng.integers(16, 32))
        font = DEFAULT_FONTS[int(rng.integers(0, len(DEFAULT_FONTS)))]
        ink = _jitter_pad(rng, render_line(text, font_path=font, font_size=fs))
        crop = 1.0 - ink * float(rng.uniform(0.6, 1.0))
        crop = np.clip(crop + rng.normal(0, 0.04, crop.shape).astype(np.float32), 0, 1)
        crop3 = np.repeat(crop[:, :, None], 3, axis=2)
        flip = int(rng.random() < 0.5)
        if flip:
            crop3 = np.rot90(crop3, 2).copy()
        images[i] = resize_norm_crop(crop3, target_h=32, max_w=160)
        labels[i] = flip
    return images, labels


def render_recognizer_crop(rng: np.random.Generator, text: str, augment: bool = True) -> np.ndarray:
    """One recognizer crop [32, W, 3]: clean at font 22 (``augment=False``),
    else a random face and size, framing jitter, darkness and noise."""
    from .postprocess import resize_norm_crop
    from .synth import DEFAULT_FONTS, render_line

    if not augment:
        ink = render_line(text, font_size=22)
        crop = 1.0 - ink
    else:
        fs = int(rng.integers(16, 30))
        font = DEFAULT_FONTS[int(rng.integers(0, len(DEFAULT_FONTS)))]
        ink = _jitter_pad(rng, render_line(text, font_path=font, font_size=fs))
        crop = 1.0 - ink * float(rng.uniform(0.6, 1.0))
        crop = np.clip(crop + rng.normal(0, 0.04, crop.shape).astype(np.float32), 0, 1)
    crop3 = np.repeat(crop[:, :, None], 3, axis=2)
    w = max(8, int(round(crop.shape[1] * 32 / crop.shape[0])))
    return resize_norm_crop(crop3, target_h=32, max_w=4096)[:, :w]


def encode_labels(texts: list[str], charset: str, max_len: int | None = None):
    """``(labels [B, L] i32, label_pad [B, L] f32)``: class ids, padding 1.0
    past each text (optax's ``label_paddings``)."""
    max_l = max_len or max(len(t) for t in texts)
    labels = np.zeros((len(texts), max_l), np.int32)
    label_pad = np.ones((len(texts), max_l), np.float32)
    for i, t in enumerate(texts):
        labels[i, : len(t)] = [charset.index(c) for c in t]
        label_pad[i, : len(t)] = 0.0
    return labels, label_pad


def render_recognizer_batch(rng: np.random.Generator, charset: str, batch: int = 16, *, min_len: int = 3,
                            max_len: int = 6, augment: bool = True):
    """One recognizer batch of random strings: ``(images [B, 32, W, 3],
    labels, label_pad)``, W padded to a multiple of 32."""
    from .synth import random_text

    texts = [random_text(rng, charset, min_len, max_len) for _ in range(batch)]
    images = _pad_batch([render_recognizer_crop(rng, t, augment) for t in texts])
    return (images, *encode_labels(texts, charset))


def render_recognizer_pool(charset: str, *, pool_size: int = 16384, crop_w: int = 320, max_len: int = 12,
                           min_len: int = 3, seed: int = 0, text_sampler=None, font_probs=None,
                           rec_h: int = 32):
    """The cached recognizer's pool, made by the SERVING crop path: full
    pages (upright, tilted, 90°) of word-like and random lines, each
    ground-truth quad through ``crop_quad`` + ``tighten_crop``. Returns
    ``(pool [N, rec_h, crop_w] f32 gray, black past each crop; labels [N,
    max_len] i32; label_pad [N, max_len] f32)``."""
    from .postprocess import QuadBox, crop_quad, tighten_crop
    from .synth import DEFAULT_FONTS, degrade_page, random_text, render_page, wordlike_text

    rng = np.random.default_rng(seed)
    font_probs = FONT_PROBS[: len(DEFAULT_FONTS)] if font_probs is None else font_probs
    font_probs = np.asarray(font_probs, np.float64)
    font_probs = font_probs / font_probs.sum()
    pool = np.zeros((pool_size, rec_h, crop_w), np.float32)
    labels = np.zeros((pool_size, max_len), np.int32)
    label_pad = np.ones((pool_size, max_len), np.float32)

    def gen_texts(n):
        out = []
        for _ in range(n):
            if text_sampler is not None:
                t = text_sampler(rng)
                if t is not None:
                    out.append(str(t)[:max_len])
                    continue
            if rng.random() < 0.5:
                out.append(wordlike_text(rng, charset, max_len))
            else:
                out.append(random_text(rng, charset, min_len, max_len)[:max_len])
        return out

    i = 0
    while i < pool_size:
        texts = gen_texts(int(rng.integers(4, 8)))
        r = rng.random()
        rot = 0.0
        if r > 0.85:
            rot = float(rng.choice([90.0, -90.0]))
        elif r > 0.45:
            rot = float(rng.uniform(-15.0, 15.0))
        page, gt = render_page(rng, charset, size=448, texts=texts, rotation=rot, font_sizes=(14, 44),
                               noise=float(rng.uniform(0.0, 0.03)), font_probs=font_probs)
        page = degrade_page(rng, page, p_blur=0.35, p_jpeg=0.35)
        for quad_pts, text in gt:
            if i >= pool_size or not text:
                continue
            crop = tighten_crop(crop_quad(page, QuadBox(quad_pts, 1.0), target_h=rec_h), target_h=rec_h)
            if crop.ndim != 3 or crop.shape[0] != rec_h or crop.size == 0:
                continue
            if crop.shape[1] > crop_w:  # truncating would corrupt labels
                continue
            pool[i, :, : crop.shape[1]] = crop[:, :, 0]
            labels[i, : len(text)] = [charset.index(c) for c in text]
            label_pad[i, : len(text)] = 0.0
            i += 1
            if i % 4096 == 0:
                logger.info("pool render %d/%d", i, pool_size)
    return pool, labels, label_pad


def render_classifier_pool(charset: str, *, pool_size: int = 16384, crop_w: int = 192, seed: int = 0):
    """The cached classifier's pool: word-like and random lines, half of
    them turned 180° (label 1). Returns ``(pool [N, 32, crop_w] f32 gray,
    labels [N] i32)``."""
    from .postprocess import resize_norm_crop
    from .synth import DEFAULT_FONTS, random_text, render_line, wordlike_text

    rng = np.random.default_rng(seed)
    font_probs = FONT_PROBS[: len(DEFAULT_FONTS)]
    font_probs = font_probs / font_probs.sum()
    pool = np.zeros((pool_size, 32, crop_w), np.float32)
    labels = np.zeros(pool_size, np.int32)
    for i in range(pool_size):
        if rng.random() < 0.5:
            text = wordlike_text(rng, charset, 10)
        else:
            text = random_text(rng, charset, 3, 10)[:10]
        fs = int(rng.integers(16, 30))
        font = DEFAULT_FONTS[int(rng.choice(len(DEFAULT_FONTS), p=font_probs))]
        ink = _jitter_pad(rng, render_line(text, font_path=font, font_size=fs))
        crop = 1.0 - ink * float(rng.uniform(0.6, 1.0))
        crop3 = np.repeat(crop[:, :, None], 3, axis=2)
        flip = int(rng.random() < 0.5)
        if flip:
            crop3 = np.rot90(crop3, 2).copy()
        w = max(8, min(crop_w, int(round(crop3.shape[1] * 32 / crop3.shape[0]))))
        r = resize_norm_crop(crop3, target_h=32, max_w=crop_w)[:, :w]
        pool[i, :, : r.shape[1]] = r[:, :, 0]
        labels[i] = flip
        if i % 4096 == 0:
            logger.info("cls pool render %d/%d", i, pool_size)
    return pool, labels


# ---------------- losses ----------------


def detector_loss(prob: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Balanced BCE (text pixels are ~5-15 % of a page) plus dice, on the
    prob map ``[B, H/2, W/2]``."""
    prob = prob.clamp(1e-6, 1 - 1e-6)
    pos = targets
    n_pos = pos.sum().clamp_min(1.0)
    n_neg = (1 - pos).sum().clamp_min(1.0)
    w_pos = n_neg / n_pos
    bce = -(w_pos * pos * torch.log(prob) + (1 - pos) * torch.log(1 - prob))
    bce = bce.sum() / (w_pos * n_pos + n_neg)
    dice = 1.0 - 2.0 * (prob * pos).sum() / (prob.sum() + pos.sum() + 1.0)
    return bce + dice


def classifier_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``optax.softmax_cross_entropy_with_integer_labels(...).mean()``."""
    return F.cross_entropy(logits, labels.long())


def ctc_loss(logits: torch.Tensor, labels: torch.Tensor, label_pad: torch.Tensor, blank: int) -> torch.Tensor:
    """Mean over the batch of each sequence's CTC NLL (``optax.ctc_loss``
    with no frame padding): ``logits [B, T, K]``, ``labels [B, L]`` with
    ``label_pad`` 1.0 past each label. An impossible alignment costs 0."""
    logp = torch.log_softmax(logits, dim=-1).transpose(0, 1)  # [T, B, K]
    b, t = logits.shape[:2]
    target_lengths = (label_pad < 0.5).sum(dim=1)
    input_lengths = torch.full((b,), t, dtype=torch.long, device=logits.device)
    per_seq = F.ctc_loss(logp, labels.long(), input_lengths, target_lengths, blank=blank, reduction="none",
                         zero_infinity=True)
    return per_seq.mean()


# ---------------- device steps ----------------


def _fit(model: torch.nn.Module, lr: float, loss_of: Callable, schedule: Callable[[int], float] | None = None):
    """``step(*batch) -> loss`` (on the device): Adam with optax's defaults,
    the rate of ``schedule(count)`` (optax's count: 0 for the first update)."""
    params = list(model.parameters())
    optimizer = torch.optim.Adam(params, lr=lr, fused=all(p.is_cuda for p in params), **ADAM)
    scheduler = None if schedule is None else torch.optim.lr_scheduler.LambdaLR(optimizer, schedule)
    state = TrainState(model.train(), optimizer, scheduler)

    def step(*batch) -> torch.Tensor:
        loss = loss_of(model, *batch)
        apply_update(state, loss)
        return loss.detach()

    return step


def _on(device: torch.device, *arrays):
    return [torch.as_tensor(np.asarray(a), device=device) for a in arrays]


def _model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _losses(losses: list[torch.Tensor]) -> list[float]:
    return torch.stack(losses).float().cpu().tolist() if losses else []


def detector_steps(model: DBDetector, batches: Iterable, *, lr: float = 1.5e-3) -> list[float]:
    """The detector's step stage over ``(images, maps)`` batches, on the
    model's device; returns every step's loss."""
    dev = _model_device(model)
    step = _fit(model, lr, lambda m, x, y: detector_loss(m(x), y))
    losses = [step(*_on(dev, x, y)) for x, y in batches]
    model.eval()
    return _losses(losses)


def classifier_steps(model: OrientationClassifier, batches: Iterable, *, lr: float = 2e-3) -> list[float]:
    """The classifier's step stage over ``(images, labels)`` batches."""
    dev = _model_device(model)
    step = _fit(model, lr, lambda m, x, y: classifier_loss(m(x), y))
    losses = [step(*_on(dev, x, y)) for x, y in batches]
    model.eval()
    return _losses(losses)


def recognizer_steps(model: torch.nn.Module, batches: Iterable, *, blank: int, lr: float = 2e-3,
                     schedule: Callable[[int], float] | None = None) -> list[float]:
    """The recognizer's step stage over ``(images, labels, label_pad)``
    batches (CTC)."""
    dev = _model_device(model)
    step = _fit(model, lr, lambda m, x, lab, pad: ctc_loss(m(x), lab, pad, blank), schedule)
    losses = [step(*_on(dev, x, lab, pad)) for x, lab, pad in batches]
    model.eval()
    return _losses(losses)


# ---------------- device-side augmentation (the cached trainers) ----------------


def pool_batch(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gray pool rows ``idx`` as RGB f32 ``[B, H, W, 3]`` in [0, 1] (a uint8
    pool is scaled by 1/255)."""
    x = pool[idx].float()
    if pool.dtype == torch.uint8:
        x = x / 255.0
    return x[..., None].expand(*x.shape, 3)


def augment_batch(images: torch.Tensor, generator: torch.Generator) -> tuple[torch.Tensor, dict]:
    """The JAX cached trainers' augmentation on ``images [B, H, W, 3]``:
    contrast in [0.8, 1.15), brightness in [−0.08, 0.08), noise σ 0.02,
    a 3×3 tent blur at a random strength in [0, 0.85), and for half the
    crops a horizontal compression by a scale in [0.78, 1.0) (it never
    moves text off the canvas, so labels stay valid). Returns the images
    and the draws."""
    b, _, w, _ = images.shape
    dev = images.device

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator, device=dev)

    contrast = uniform((b, 1, 1, 1), 0.8, 1.15)
    bright = uniform((b, 1, 1, 1), -0.08, 0.08)
    noise = 0.02 * torch.randn(images.shape, generator=generator, device=dev)
    x = ((images - 1.0) * contrast + 1.0 + bright + noise).clamp(0.0, 1.0)
    r = torch.roll
    blurred = (4.0 * x + 2.0 * (r(x, 1, 1) + r(x, -1, 1) + r(x, 1, 2) + r(x, -1, 2))
               + (r(r(x, 1, 1), 1, 2) + r(r(x, 1, 1), -1, 2) + r(r(x, -1, 1), 1, 2) + r(r(x, -1, 1), -1, 2))) / 16.0
    blur = uniform((b, 1, 1, 1), 0.0, 0.85)
    x = (1.0 - blur) * x + blur * blurred
    scale = uniform((b, 1), 0.78, 1.0)
    src = (torch.arange(w, dtype=torch.float32, device=dev)[None, :] / scale).long().clamp(0, w - 1)
    stretched = torch.gather(x, 2, src[:, None, :, None].expand_as(x))
    use = uniform((b, 1, 1, 1), 0.0, 1.0) < 0.5
    x = torch.where(use, stretched, x)
    return x, {"contrast": contrast, "bright": bright, "noise": noise, "blur": blur, "scale": scale,
               "src": src, "use": use}


def _pool_steps(model, loss_of, pool, targets, *, steps, batch, lr, steps_per_launch, generator):
    """``ceil(steps / steps_per_launch) · steps_per_launch`` steps, each on
    a random augmented batch of the device-resident pool; the rate is
    optax's warm-up (``max(50, steps // 50)``) + cosine to 0.02·lr."""
    dev = _model_device(model)
    pool = torch.as_tensor(pool, device=dev)
    targets = [torch.as_tensor(np.asarray(t), device=dev) for t in targets]
    step = _fit(model, lr, loss_of, warmup_cosine_factor(steps, warmup=max(50, steps // 50), alpha=0.02))
    losses = []
    n = pool.shape[0]
    for launch in range(-(-steps // steps_per_launch)):
        for _ in range(steps_per_launch):
            idx = torch.randint(0, n, (batch,), generator=generator, device=dev)
            images, _ = augment_batch(pool_batch(pool, idx), generator)
            losses.append(step(images, *(t[idx] for t in targets)))
        if launch % 20 == 0:
            logger.info("cached launch %d mean loss %.4f", launch,
                        float(torch.stack(losses[-steps_per_launch:]).mean()))
    model.eval()
    return _losses(losses)


def recognizer_pool_steps(model, pool, labels, label_pad, *, blank: int, steps: int = 40_000, batch: int = 32,
                          lr: float = 1.5e-3, steps_per_launch: int = 100, seed: int = 0,
                          generator: torch.Generator | None = None) -> list[float]:
    """The cached recognizer's step stage over a rendered pool (``pool [N,
    H, W]`` gray, f32 or uint8)."""
    gen = generator or torch.Generator(device=_model_device(model)).manual_seed(seed * 7919)
    return _pool_steps(model, lambda m, x, lab, pad: ctc_loss(m(x), lab, pad, blank), pool, (labels, label_pad),
                       steps=steps, batch=batch, lr=lr, steps_per_launch=steps_per_launch, generator=gen)


def classifier_pool_steps(model, pool, labels, *, steps: int = 12_000, batch: int = 64, lr: float = 1.5e-3,
                          steps_per_launch: int = 100, seed: int = 0,
                          generator: torch.Generator | None = None) -> list[float]:
    """The cached classifier's step stage over a rendered pool."""
    gen = generator or torch.Generator(device=_model_device(model)).manual_seed(seed * 6311)
    return _pool_steps(model, lambda m, x, lab: classifier_loss(m(x), lab), pool, (labels,),
                       steps=steps, batch=batch, lr=lr, steps_per_launch=steps_per_launch, generator=gen)


# ---------------- the trainers (render + step) ----------------


def _seeded(module_fn, seed: int, device: torch.device):
    """A model built with torch's initialisation from ``seed`` (not the
    JAX package's initial values), on ``device``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = module_fn()
    return model.to(device)


def _start(model: torch.nn.Module, init_params: dict | None) -> torch.nn.Module:
    if init_params is not None:
        model.load_state_dict(init_params)
    return model


def train_synthetic_detector(charset: str, *, steps: int = 400, batch: int = 4, page_size: int = 448,
                             width: int = 16, seed: int = 0, lr: float = 1.5e-3, max_rotation: float = 15.0,
                             rot90_frac: float = 0.15, init_params: dict | None = None,
                             device: str | torch.device | None = None):
    """Train ``DBDetector`` on synthetic pages (a mix of upright, tilted and
    90° pages). ``init_params``: a state dict to continue from. Returns
    ``(model, losses)``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    model = _start(_seeded(lambda: DBDetector(width), seed, dev), init_params)
    batches = (render_detector_batch(rng, charset, batch, page_size=page_size, max_rotation=max_rotation,
                                     rot90_frac=rot90_frac) for _ in range(steps))
    return model, detector_steps(model, batches, lr=lr)


def train_synthetic_classifier(charset: str, *, steps: int = 200, batch: int = 32, width: int = 16, seed: int = 0,
                               lr: float = 2e-3, device: str | torch.device | None = None):
    """Train the 0°/180° ``OrientationClassifier`` on rendered line crops.
    Returns ``(model, losses)``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    model = _seeded(lambda: OrientationClassifier(width), seed, dev)
    batches = (render_classifier_batch(rng, charset, batch) for _ in range(steps))
    return model, classifier_steps(model, batches, lr=lr)


def train_synthetic_recognizer(charset: str = DIGITS, *, steps: int = 300, batch: int = 16, min_len: int = 3,
                               max_len: int = 6, width: int = 32, seed: int = 0, lr: float = 2e-3,
                               init_params: dict | None = None, augment: bool = True, arch: str = "conv",
                               device: str | torch.device | None = None):
    """Train a recognizer (``arch``: conv | svtr | crnn) on rendered random
    strings of ``charset``; ``augment=False`` renders clean fixed-font
    crops. Runs of 2,000 steps or more take the warm-up + cosine rate
    (warm-up ``max(20, steps // 20)``, to 0.01·lr); shorter ones a constant
    rate (CTC must leave the all-blank saddle before the rate decays).
    Returns ``(model, charset, losses)``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    model = _start(_seeded(lambda: make_recognizer(arch, len(charset), width), seed, dev), init_params)
    schedule = warmup_cosine_factor(steps, alpha=0.01) if steps >= 2000 else None
    batches = (render_recognizer_batch(rng, charset, batch, min_len=min_len, max_len=max_len, augment=augment)
               for _ in range(steps))
    return model, charset, recognizer_steps(model, batches, blank=len(charset), lr=lr, schedule=schedule)


def train_recognizer_cached(charset: str, *, pool_size: int = 16384, steps: int = 40_000, batch: int = 32,
                            crop_w: int = 320, max_len: int = 12, min_len: int = 3, width: int = 32, seed: int = 0,
                            lr: float = 1.5e-3, init_params: dict | None = None, steps_per_launch: int = 100,
                            col_stride: int = 2, text_sampler=None, font_probs=None, arch: str = "conv",
                            rec_h: int = 32, device: str | torch.device | None = None):
    """Render an augmented crop pool ONCE through the serving crop path,
    keep it on the device, and train on random augmented batches from it
    (``recognizer_pool_steps``). Returns ``(model, charset, losses)``."""
    dev = resolve_device(device)
    model = _start(_seeded(lambda: make_recognizer(arch, len(charset), width, col_stride=col_stride, rec_h=rec_h),
                           seed, dev), init_params)
    pool, labels, label_pad = render_recognizer_pool(
        charset, pool_size=pool_size, crop_w=crop_w, max_len=max_len, min_len=min_len, seed=seed,
        text_sampler=text_sampler, font_probs=font_probs, rec_h=rec_h)
    losses = recognizer_pool_steps(model, pool, labels, label_pad, blank=len(charset), steps=steps, batch=batch,
                                   lr=lr, steps_per_launch=steps_per_launch, seed=seed)
    return model, charset, losses


def train_classifier_cached(charset: str, *, pool_size: int = 16384, steps: int = 12_000, batch: int = 64,
                            crop_w: int = 192, width: int = 16, seed: int = 0, lr: float = 1.5e-3,
                            steps_per_launch: int = 100, device: str | torch.device | None = None):
    """The cached-pool trainer of the ``OrientationClassifier``, with the
    recognizer's augmentation. Returns ``(model, losses)``."""
    dev = resolve_device(device)
    model = _seeded(lambda: OrientationClassifier(width), seed, dev)
    pool, labels = render_classifier_pool(charset, pool_size=pool_size, crop_w=crop_w, seed=seed)
    return model, classifier_pool_steps(model, pool, labels, steps=steps, batch=batch, lr=lr,
                                        steps_per_launch=steps_per_launch, seed=seed)


def train_full_ocr(charset: str | None = None, *, det_steps: int = 500, cls_steps: int = 800,
                   rec_steps: int = 8000, width: int = 16, seed: int = 0,
                   device: str | torch.device | None = None) -> OCRModelBundle:
    """Train all three stages; returns a complete bundle on the CPU (save
    it with ``bundle.save(path)``)."""
    from .synth import build_charset

    charset = charset or build_charset()
    logger.info("training OCR: charset=%d classes", len(charset))
    det, det_losses = train_synthetic_detector(charset, steps=det_steps, width=width, seed=seed, device=device)
    logger.info("det final loss %.4f", det_losses[-1])
    cls_model, cls_losses = train_synthetic_classifier(charset, steps=cls_steps, width=width, seed=seed,
                                                       device=device)
    logger.info("cls final loss %.4f", cls_losses[-1])
    rec, _, rec_losses = train_synthetic_recognizer(charset, steps=rec_steps, width=width * 2, seed=seed,
                                                    min_len=3, max_len=12, batch=32, device=device)
    logger.info("rec final loss %.4f", rec_losses[-1])
    return OCRModelBundle(det.eval(), cls_model.eval(), rec.eval(), charset).to("cpu")


# ---------------- the committed training fixture ----------------

FIXTURE_SEED = 0
FIXTURE_DIGIT_STEPS, FIXTURE_DIGIT_BATCH = 250, 16  # the JAX digits test's run
FIXTURE_REC_POOL, FIXTURE_CLS_POOL, FIXTURE_DET_PAGES = 256, 256, 16


def _u8(x: np.ndarray) -> np.ndarray:
    return np.round(np.clip(x, 0.0, 1.0) * 255.0).astype(np.uint8)


def build_train_fixture() -> dict[str, np.ndarray]:
    """The OCR training data for a machine without PIL or the fonts, gray
    uint8 (``x / 255`` gives the rendered values to within 1/510):

    - ``digit_*``: the JAX digits test's 250 clean batches of 16 (charset
      ``0123456789``, lengths 3-6, seed 0), every crop padded to the widest
      batch, with each batch's own padded width (``digit_width``);
    - ``digit_test``: its three test images ("0123", "90210", "777") as
      ``_pad_batch`` pads them;
    - ``rec_*``: a pool of word-like and random crops at height 32 × 320
      from the serving crop path (``render_recognizer_pool``, the shipped
      charset ``synth.build_charset()``);
    - ``det_*``: 16 detector pages of 448 × 448 and their maps (bit-packed);
    - ``cls_*``: a classifier pool at 32 × 192 (``render_classifier_pool``).
    """
    from .synth import build_charset

    rng = np.random.default_rng(FIXTURE_SEED)
    batches = [render_recognizer_batch(rng, DIGITS, FIXTURE_DIGIT_BATCH, augment=False)
               for _ in range(FIXTURE_DIGIT_STEPS)]
    width = max(b[0].shape[2] for b in batches)
    digits = np.zeros((FIXTURE_DIGIT_STEPS * FIXTURE_DIGIT_BATCH, 32, width), np.uint8)
    labels = np.zeros((len(digits), 6), np.int32)
    label_pad = np.ones((len(digits), 6), np.float32)
    for i, (x, lab, pad) in enumerate(batches):
        rows = slice(i * FIXTURE_DIGIT_BATCH, (i + 1) * FIXTURE_DIGIT_BATCH)
        digits[rows, :, : x.shape[2]] = _u8(x[..., 0])
        labels[rows, : lab.shape[1]] = lab
        label_pad[rows, : pad.shape[1]] = pad
    charset = build_charset()
    rec, rec_labels, rec_pad = render_recognizer_pool(charset, pool_size=FIXTURE_REC_POOL, seed=FIXTURE_SEED)
    cls, cls_labels = render_classifier_pool(charset, pool_size=FIXTURE_CLS_POOL, seed=FIXTURE_SEED)
    det_rng = np.random.default_rng(FIXTURE_SEED)
    pages, maps = zip(*(render_detector_batch(det_rng, charset, 4) for _ in range(FIXTURE_DET_PAGES // 4)))
    pages, maps = np.concatenate(pages), np.concatenate(maps)
    return {
        "digit_images": digits, "digit_labels": labels, "digit_label_pad": label_pad,
        "digit_width": np.array([b[0].shape[2] for b in batches], np.int32),
        "digit_test": _u8(_pad_batch([render_text_image(t) for t in DIGIT_TESTS])[..., 0]),
        "rec_images": _u8(rec), "rec_labels": rec_labels, "rec_label_pad": rec_pad,
        "det_images": _u8(pages[..., 0]), "det_maps": np.packbits(maps > 0.5, axis=-1),
        "cls_images": _u8(cls), "cls_labels": cls_labels,
        "charset": np.frombuffer(charset.encode("utf-8"), np.uint8),
    }


def write_train_fixture(path: Path = TRAIN_FIXTURE) -> None:
    """:func:`build_train_fixture` as an npz in an xz stream (the 4,000
    digit crops repeat the same glyphs: xz stores them in a thirtieth of
    what the npz's own deflate does)."""
    import io
    import lzma

    buf = io.BytesIO()
    np.savez(buf, **build_train_fixture())
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(lzma.compress(buf.getvalue(), preset=9 | lzma.PRESET_EXTREME))


def load_train_fixture(path: Path = TRAIN_FIXTURE) -> dict:
    """The committed fixture: arrays as stored, plus ``charset`` (str),
    ``det_maps`` unpacked to f32 ``[16, 224, 224]`` and ``digit_batches``
    (the 250 batches of the digits run: ``(images [16, 32, W, 3] f32,
    labels, label_pad)`` at each batch's own width)."""
    import io
    import lzma

    with np.load(io.BytesIO(lzma.decompress(path.read_bytes()))) as z:
        out = {k: z[k] for k in z.files}
    out["charset"] = out["charset"].tobytes().decode("utf-8")
    side = out["det_images"].shape[1] // 2
    out["det_maps"] = np.unpackbits(out["det_maps"], axis=-1)[..., :side].astype(np.float32)
    b = FIXTURE_DIGIT_BATCH
    out["digit_batches"] = [
        (np.repeat(out["digit_images"][i * b : (i + 1) * b, :, :w, None] / np.float32(255.0), 3, axis=3),
         out["digit_labels"][i * b : (i + 1) * b], out["digit_label_pad"][i * b : (i + 1) * b])
        for i, w in enumerate(out["digit_width"])
    ]
    return out


if __name__ == "__main__":
    # python -m intool_rag_tpu_torch.ocr.train [out.npz]: train and save a bundle (on the card)
    # python -m intool_rag_tpu_torch.ocr.train --fixture: rebuild the committed training fixture
    import sys

    logging.basicConfig(level=logging.INFO)
    if sys.argv[1:] == ["--fixture"]:
        write_train_fixture()
        print(f"wrote {TRAIN_FIXTURE} ({TRAIN_FIXTURE.stat().st_size / 1e6:.2f} MB)")
    else:
        out = Path(sys.argv[1]) if len(sys.argv) > 1 else Path("ocr_bundle.npz")
        out.parent.mkdir(parents=True, exist_ok=True)
        train_full_ocr().save(out)
        print(f"saved {out} ({out.stat().st_size / 1e6:.2f} MB)")

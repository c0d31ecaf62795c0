"""OCR model zoo as ``torch.nn`` modules (port of
``intool_rag_tpu/ocr/models.py``; reference: rag/ingest/ocr/networks/ —
SURVEY.md §2.7 #45).

- :class:`DBDetector` — DBNet-style text segmentation: conv backbone with
  stride-2 stages, FPN-lite top-down fusion, differentiable-binarization
  head emitting a probability map at 1/2 input resolution.
- :class:`OrientationClassifier` — small convnet, 2 classes (0°/180°).
- Recognizer zoo (``make_recognizer``): :class:`CTCRecognizer` (conv +
  attention column mixer, the shipped default), :class:`SVTRRecognizer`
  (transformer mixer) and :class:`CRNNRecognizer` (bidirectional gated
  linear recurrence).

The modules take and return the JAX package's layouts (images and crops
``[B, H, W, C]``) and compute as flax does, which differs from torch's
defaults in four places: ``"SAME"`` padding (at stride 2 on an even size
the one pad row goes after, :func:`_same_pad`), ε = 1e-6 in GroupNorm and
LayerNorm, the tanh GELU, and the height folded into the channels as
index ``h·C + c``. Submodules carry flax's names (``Conv_0``,
``GroupNorm_0``, ``column_attn.query`` …), so :func:`ocr_state_from_flax`
maps a flax parameter tree onto a ``state_dict`` leaf by leaf and
:func:`flax_tree_from_state` maps it back.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_EPS = 1e-6  # flax GroupNorm / LayerNorm


def _same_pad(x: torch.Tensor, kernel: int, stride: tuple[int, int]) -> torch.Tensor:
    """flax ``padding="SAME"`` on NCHW: out = ceil(n / s) per axis, the
    total pad split with the smaller half before (lax.padtype_to_pads)."""
    pads = []
    for n, s in zip((x.shape[3], x.shape[2]), (stride[1], stride[0])):  # F.pad lists the last axis first
        total = max((-(-n // s) - 1) * s + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class _Conv(nn.Conv2d):
    """``nn.Conv(features, (k, k), strides, padding="SAME")``."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride=(1, 1), bias: bool = True) -> None:
        super().__init__(cin, cout, kernel, stride=stride, padding=0, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(_same_pad(x, self.kernel_size[0], self.stride))


def _downsample(n: int, times: int) -> int:
    for _ in range(times):
        n = -(-n // 2)
    return n


def _add_conv_bn_act(owner: nn.Module, specs: list[tuple[int, int, int]]) -> int:
    """flax ``_conv_bn_act`` is a function, so its layers take the caller's
    auto-names: registers ``Conv_{i}`` (3×3, "SAME", no bias) and
    ``GroupNorm_{i}`` on ``owner`` for each (cin, cout, stride); returns
    how many."""
    for i, (cin, cout, stride) in enumerate(specs):
        owner.add_module(f"Conv_{i}", _Conv(cin, cout, 3, (stride, stride), bias=False))
        owner.add_module(f"GroupNorm_{i}", nn.GroupNorm(min(8, cout), cout, eps=_EPS))
    return len(specs)


def _conv_bn_act(owner: nn.Module, i: int, x: torch.Tensor) -> torch.Tensor:
    return F.relu(getattr(owner, f"GroupNorm_{i}")(getattr(owner, f"Conv_{i}")(x)))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _columns(x: torch.Tensor) -> torch.Tensor:
    """NCHW → [B, W, H·C] with index h·C + c (flax: NHWC
    ``transpose(0, 2, 1, 3).reshape(b, w, h * c)``)."""
    b, c, h, w = x.shape
    return x.permute(0, 3, 2, 1).reshape(b, w, h * c)


class _Backbone(nn.Module):
    """4-stage conv backbone; returns feature maps at 1/2..1/16."""

    def __init__(self, width: int = 16) -> None:
        super().__init__()
        specs, cin = [], 3
        for stage in range(4):
            w = width * 2**stage
            specs += [(cin, w, 2), (w, w, 1)]
            cin = w
        self._n_conv = _add_conv_bn_act(self, specs)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats = []
        for i in range(self._n_conv):
            x = _conv_bn_act(self, i, x)
            if i % 2:
                feats.append(x)
        return feats


def _resize_nearest(y: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(..., "nearest")`` on NCHW: output i samples input
    floor((i + 0.5) · n_in / n_out) (i // 2 at an exact 2×)."""
    for axis, n_out in ((2, size[0]), (3, size[1])):
        n_in = y.shape[axis]
        if n_in != n_out:
            idx = ((torch.arange(n_out, dtype=torch.float32) + 0.5) * (n_in / n_out)).floor().long()
            y = y.index_select(axis, idx.clamp_(max=n_in - 1).to(y.device))
    return y


class DBDetector(nn.Module):
    """Text-region probability map (reference det: DBNet, ch_ppocr_det —
    SURVEY.md §2.7 #40)."""

    def __init__(self, width: int = 16) -> None:
        super().__init__()
        self.width = width
        self.backbone = _Backbone(width)
        fpn_w = width * 2
        for i in range(4):
            self.add_module(f"lateral_{i}", _Conv(width * 2**i, fpn_w, 1))
        _add_conv_bn_act(self, [(fpn_w, fpn_w, 1)])
        self.db_head = _Conv(fpn_w, 1, 3)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, C] in [0,1] → prob map [B, H/2, W/2]."""
        feats = self.backbone(_nchw(images))
        laterals = [getattr(self, f"lateral_{i}")(f) for i, f in enumerate(feats)]
        y = laterals[-1]
        for lat in laterals[-2::-1]:
            y = _resize_nearest(y, lat.shape[2:]) + lat
        y = _conv_bn_act(self, 0, y)
        return torch.sigmoid(self.db_head(y)[:, 0])


class OrientationClassifier(nn.Module):
    """0°/180° crop classifier (reference cls: ch_ppocr_cls — §2.7 #41).
    Pools over width only: the vertical ink profile is the 0-vs-180 signal.
    ``height`` is the crop height it is built for (the pipeline's 32)."""

    def __init__(self, width: int = 16, height: int = 32) -> None:
        super().__init__()
        self.width = width
        self._n_conv = _add_conv_bn_act(self, [(3, width, 2), (width, 2 * width, 2), (2 * width, 4 * width, 2)])
        self.Dense_0 = nn.Linear(_downsample(height, 3) * 4 * width, 64)
        self.Dense_1 = nn.Linear(64, 2)

    def forward(self, crops: torch.Tensor) -> torch.Tensor:
        """crops [B, H, W, C] → logits [B, 2]."""
        x = _nchw(crops)
        for i in range(self._n_conv):
            x = _conv_bn_act(self, i, x)
        x = x.mean(dim=3).permute(0, 2, 1)  # [B, H/8, C]: keep the vertical profile
        x = x.reshape(x.shape[0], -1)
        return self.Dense_1(F.relu(self.Dense_0(x)))


class _MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` over one input, no mask: q, k,
    v and out projections with bias, q scaled by 1/√head_dim, softmax over
    the keys, written as two products (the JAX package runs it in XLA)."""

    def __init__(self, features: int, heads: int, qkv_features: int) -> None:
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(features, qkv_features)
        self.key = nn.Linear(features, qkv_features)
        self.value = nn.Linear(features, qkv_features)
        self.out = nn.Linear(qkv_features, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape

        def split(proj: nn.Linear) -> torch.Tensor:
            return proj(x).view(b, t, self.heads, -1).transpose(1, 2)

        q, k, v = split(self.query), split(self.key), split(self.value)
        q = q / math.sqrt(q.shape[-1])
        weights = torch.softmax(torch.matmul(q, k.transpose(-1, -2)), dim=-1)
        return self.out(torch.matmul(weights, v).transpose(1, 2).reshape(b, t, -1))


class CTCRecognizer(nn.Module):
    """Sequence recognizer with CTC output (reference rec: ch_ppocr_rec CTC
    head — §2.7 #42). Input height ``rec_h``; width maps to sequence columns
    at 1/(2·col_stride) downsampling. ``col_stride=1`` gives narrow glyphs
    (i, l, :) at least 3 frames each; the attention mixer has no positional
    encoding, so longer sequences extrapolate freely."""

    def __init__(self, vocab_size: int, width: int = 32, col_stride: int = 2, rec_h: int = 32) -> None:
        super().__init__()
        self.vocab_size, self.width, self.col_stride = vocab_size, width, col_stride
        self._n_conv = _add_conv_bn_act(self, [(3, width, 1), (width, width, 2), (width, 2 * width, 1)])
        self.Conv_3 = _Conv(2 * width, 2 * width, 3, (2, col_stride))
        self.Dense_0 = nn.Linear(_downsample(rec_h, 2) * 2 * width, 4 * width)
        self.column_attn = _MultiHeadAttention(4 * width, 4, 4 * width)
        self.LayerNorm_0 = nn.LayerNorm(4 * width, eps=_EPS)
        self.ctc_head = nn.Linear(4 * width, vocab_size + 1)

    def forward(self, crops: torch.Tensor) -> torch.Tensor:
        """crops [B, H, W, C] → logits [B, W/(2·col_stride), vocab+1]."""
        x = _nchw(crops)
        for i in range(self._n_conv):
            x = _conv_bn_act(self, i, x)
        x = F.relu(self.Conv_3(x))  # H/4, W/(2·col_stride)
        x = F.relu(self.Dense_0(_columns(x)))
        x = self.LayerNorm_0(x + self.column_attn(x))
        return self.ctc_head(x)


class SVTRRecognizer(nn.Module):
    """SVTR-style recognizer (Du et al. 2022): a conv patch stem to H/4
    columns, height folded into channels, ``depth`` pre-norm transformer
    blocks (MHSA over the columns + tanh-GELU MLP). Same I/O contract as
    :class:`CTCRecognizer`."""

    def __init__(self, vocab_size: int, width: int = 64, depth: int = 3, heads: int = 4,
                 col_stride: int = 2, rec_h: int = 32) -> None:
        super().__init__()
        self.vocab_size, self.width, self.depth, self.col_stride = vocab_size, width, depth, col_stride
        _add_conv_bn_act(self, [(3, width // 2, 2)])
        self.Conv_1 = _Conv(width // 2, width, 3, (2, col_stride))
        self.Dense_0 = nn.Linear(_downsample(rec_h, 2) * width, width)
        for i in range(depth):
            self.add_module(f"ln_attn_{i}", nn.LayerNorm(width, eps=_EPS))
            self.add_module(f"mixer_{i}", _MultiHeadAttention(width, heads, width))
            self.add_module(f"ln_mlp_{i}", nn.LayerNorm(width, eps=_EPS))
            self.add_module(f"mlp_up_{i}", nn.Linear(width, 4 * width))
            self.add_module(f"mlp_down_{i}", nn.Linear(4 * width, width))
        self.ln_out = nn.LayerNorm(width, eps=_EPS)
        self.ctc_head = nn.Linear(width, vocab_size + 1)

    def forward(self, crops: torch.Tensor) -> torch.Tensor:
        x = _conv_bn_act(self, 0, _nchw(crops))  # H/2, W/2
        x = F.relu(self.Conv_1(x))  # H/4, W/(2·col_stride)
        x = self.Dense_0(_columns(x))
        for i in range(self.depth):
            block = {n: getattr(self, f"{n}_{i}") for n in ("ln_attn", "mixer", "ln_mlp", "mlp_up", "mlp_down")}
            x = x + block["mixer"](block["ln_attn"](x))
            y = F.gelu(block["mlp_up"](block["ln_mlp"](x)), approximate="tanh")
            x = x + block["mlp_down"](y)
        return self.ctc_head(self.ln_out(x))


class _LinearRecurrence(nn.Module):
    """Gated linear recurrence over the column axis: h_t = a_t⊙h_{t−1} +
    (1−a_t)⊙v_t with a_t = σ(gate(x_t)+1), run as an inclusive scan of the
    associative composition (a₂,b₂)∘(a₁,b₁) = (a₂·a₁, a₂·b₁+b₂) in
    ⌈log₂ W⌉ doubling steps, as ``lax.associative_scan`` runs it in
    O(log W) depth."""

    def __init__(self, features: int) -> None:
        super().__init__()
        self.gate = nn.Linear(features, features)
        self.value = nn.Linear(features, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = torch.sigmoid(self.gate(x) + 1.0)
        b = (1.0 - a) * self.value(x)
        step = 1
        while step < x.shape[1]:
            b = torch.cat([b[:, :step], a[:, step:] * b[:, :-step] + b[:, step:]], dim=1)
            a = torch.cat([a[:, :step], a[:, step:] * a[:, :-step]], dim=1)
            step *= 2
        return b


class _BiRecurrence(nn.Module):
    """Forward + reversed linear recurrences, concatenated and mixed (the
    stand-in for the CRNN family's BiLSTM neck)."""

    def __init__(self, features: int) -> None:
        super().__init__()
        self.fwd = _LinearRecurrence(features)
        self.bwd = _LinearRecurrence(features)
        self.mix = nn.Linear(2 * features, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fwd = self.fwd(x)
        bwd = self.bwd(x.flip(1)).flip(1)
        return self.mix(torch.cat([fwd, bwd], dim=-1))


class CRNNRecognizer(nn.Module):
    """CRNN-family recognizer (conv features → bidirectional gated linear
    recurrence → CTC). Same I/O contract as :class:`CTCRecognizer`."""

    def __init__(self, vocab_size: int, width: int = 64, depth: int = 2, col_stride: int = 2,
                 rec_h: int = 32) -> None:
        super().__init__()
        self.vocab_size, self.width, self.depth, self.col_stride = vocab_size, width, depth, col_stride
        self._n_conv = _add_conv_bn_act(self, [(3, width // 2, 1), (width // 2, width // 2, 2)])
        self.Conv_2 = _Conv(width // 2, width, 3, (2, col_stride))
        self.Dense_0 = nn.Linear(_downsample(rec_h, 2) * width, width)
        for i in range(depth):
            self.add_module(f"birnn_{i}", _BiRecurrence(width))
            self.add_module(f"ln_{i}", nn.LayerNorm(width, eps=_EPS))
        self.ctc_head = nn.Linear(width, vocab_size + 1)

    def forward(self, crops: torch.Tensor) -> torch.Tensor:
        x = _nchw(crops)
        for i in range(self._n_conv):
            x = _conv_bn_act(self, i, x)
        x = F.relu(self.Conv_2(x))
        x = self.Dense_0(_columns(x))
        for i in range(self.depth):
            x = getattr(self, f"ln_{i}")(x + getattr(self, f"birnn_{i}")(x))
        return self.ctc_head(x)


def make_recognizer(arch: str, vocab_size: int, width: int, col_stride: int = 2, rec_h: int = 32):
    """Recognizer zoo dispatch: ``conv`` (CTCRecognizer — the shipped
    default), ``svtr`` (SVTRRecognizer) or ``crnn`` (CRNNRecognizer)."""
    if arch == "conv":
        return CTCRecognizer(vocab_size, width, col_stride, rec_h)
    if arch in ("svtr", "crnn"):
        # the stem's GroupNorm needs width/2 divisible by its 8 groups and
        # MHSA width divisible by 4 heads: a multiple of 16, at least 32
        w = -(-max(width, 32) // 16) * 16
        if arch == "svtr":
            return SVTRRecognizer(vocab_size, w, col_stride=col_stride, rec_h=rec_h)
        return CRNNRecognizer(vocab_size, w, col_stride=col_stride, rec_h=rec_h)
    raise ValueError(f"unknown recognizer arch {arch!r} (conv | svtr | crnn)")


def _rec_arch(rec: nn.Module) -> str:
    return "svtr" if isinstance(rec, SVTRRecognizer) else "crnn" if isinstance(rec, CRNNRecognizer) else "conv"


# ---------------- flax parameter trees ----------------


def _leaves(tree: dict, prefix: tuple = ()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def ocr_state_from_flax(tree: dict, module: nn.Module) -> dict[str, torch.Tensor]:
    """The ``state_dict`` of ``module`` from a flax parameter tree (numpy
    leaves; with or without its ``"params"`` root). Conv kernels go HWIO →
    OIHW, Dense kernels [in, out] → [out, in], attention kernels
    [in, heads, head_dim] / [heads, head_dim, out] → [heads·head_dim, in] /
    [out, heads·head_dim], norm ``scale`` → ``weight``. Raises unless every
    leaf lands on a parameter of ``module`` of its shape and every
    parameter is set."""
    tree = tree.get("params", tree)
    want = module.state_dict()
    state: dict[str, torch.Tensor] = {}
    for path, value in _leaves(tree):
        *scope, leaf = path
        name = ".".join([*scope, "weight" if leaf in ("kernel", "scale") else leaf])
        if leaf == "kernel" and value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
        elif leaf == "kernel" and value.ndim == 3 and scope[-1] == "out":
            value = value.reshape(-1, value.shape[-1]).T
        elif leaf == "kernel":
            value = value.reshape(value.shape[0], -1).T
        elif leaf == "bias":
            value = value.reshape(-1)
        if name not in want or tuple(want[name].shape) != value.shape:
            raise ValueError(f"flax leaf {'/'.join(path)} {value.shape} has no parameter {name} in "
                             f"{type(module).__name__}")
        state[name] = torch.from_numpy(np.array(value, dtype=np.float32))
    if set(state) != set(want):
        raise ValueError(f"{type(module).__name__}: parameters without a flax leaf: {sorted(set(want) - set(state))}")
    return state


def flax_tree_from_state(module: nn.Module) -> dict:
    """The inverse of :func:`ocr_state_from_flax`: ``{"params": …}`` with
    flax's names, layouts and float32 numpy leaves."""
    heads = {name: m.heads for name, m in module.named_modules() if isinstance(m, _MultiHeadAttention)}
    params: dict = {}
    for name, sub in module.named_modules():
        leaves = {k: v.detach().cpu().numpy().astype(np.float32) for k, v in sub.named_parameters(recurse=False)}
        if not leaves:
            continue
        *parent, last = name.split(".")
        h = heads.get(".".join(parent))
        w = leaves["weight"]
        if isinstance(sub, nn.Conv2d):
            out = {"kernel": w.transpose(2, 3, 1, 0)}
        elif isinstance(sub, (nn.GroupNorm, nn.LayerNorm)):
            out = {"scale": w}
        elif h and last == "out":
            out = {"kernel": w.T.reshape(h, -1, w.shape[0])}
        elif h:
            out = {"kernel": w.T.reshape(w.shape[1], h, -1)}
        else:
            out = {"kernel": w.T}
        if "bias" in leaves:
            out["bias"] = leaves["bias"].reshape(h, -1) if h and last != "out" else leaves["bias"]
        node = params
        for key in name.split("."):
            node = node.setdefault(key, {})
        node.update({k: np.ascontiguousarray(v) for k, v in out.items()})
    return {"params": params}


def _load_flax(module: nn.Module, tree: dict) -> nn.Module:
    module.load_state_dict(ocr_state_from_flax(tree, module), strict=True)
    return module.eval()


@dataclasses.dataclass
class OCRModelBundle:
    """The three models (eval mode, on one device) and the recognizer's
    vocabulary. ``rec_h`` is the recognizer crop height: crops are sampled
    from the source image at this height; the classifier always sees 32."""

    det: DBDetector
    cls: OrientationClassifier
    rec: nn.Module
    charset: str  # rec vocab, index = class id
    rec_h: int = 32

    @classmethod
    def create(cls, charset: str, seed: int = 0, width: int = 16, rec_width: int | None = None,
               rec_col_stride: int = 2, rec_arch: str = "conv", rec_h: int = 32) -> "OCRModelBundle":
        """Models on the CPU with torch's initialisation from ``seed`` (not
        the JAX package's initial values)."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            det = DBDetector(width)
            cls_model = OrientationClassifier(width)
            rec = make_recognizer(rec_arch, len(charset), rec_width or width * 2, rec_col_stride, rec_h)
        return cls(det.eval(), cls_model.eval(), rec.eval(), charset, rec_h)

    def to(self, device: str | torch.device) -> "OCRModelBundle":
        for model in (self.det, self.cls, self.rec):
            model.to(device)
        return self

    # ---------------- artifact persistence ----------------

    def save(self, path) -> None:
        """One ``.npz`` artifact in the JAX package's format: a JSON
        ``meta`` and each model's flax msgpack bytes, which the JAX
        package's ``OCRModelBundle.load`` reads."""
        import json

        from ..models.msgpack import packb

        meta = json.dumps({
            "charset": self.charset, "width": self.det.width, "rec_width": self.rec.width,
            "rec_stride": self.rec.col_stride, "rec_arch": _rec_arch(self.rec), "rec_h": self.rec_h,
        })
        np.savez_compressed(
            path,
            meta=np.frombuffer(meta.encode("utf-8"), np.uint8),
            **{name: np.frombuffer(packb(flax_tree_from_state(model)), np.uint8)
               for name, model in (("det", self.det), ("cls", self.cls), ("rec", self.rec))},
        )

    @classmethod
    def load(cls, path) -> "OCRModelBundle":
        """An artifact written by either package's ``save``, on the CPU."""
        import json

        from ..models.msgpack import unpackb

        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"].tobytes()).decode("utf-8"))
            trees = {name: unpackb(z[name].tobytes()) for name in ("det", "cls", "rec")}
        rec_h = meta.get("rec_h", 32)
        det = _load_flax(DBDetector(meta["width"]), trees["det"])
        cls_model = _load_flax(OrientationClassifier(meta["width"]), trees["cls"])
        rec = _load_flax(make_recognizer(meta.get("rec_arch", "conv"), len(meta["charset"]),
                                         meta.get("rec_width", meta["width"] * 2), meta.get("rec_stride", 2), rec_h),
                         trees["rec"])
        return cls(det, cls_model, rec, meta["charset"], rec_h)

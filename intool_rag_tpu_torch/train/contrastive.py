"""Contrastive fine-tuning of the text encoder (InfoNCE, in-batch
negatives; port of ``intool_rag_tpu/train/contrastive.py``).

The model trains with f32 master weights and the config's compute dtype
(``TextEncoder(..., param_dtype=torch.float32)``), under
``torch.optim.AdamW`` as the JAX trainers' ``optax.adamw(...,
weight_decay=0.01)`` (betas 0.9 / 0.999, eps 1e-8, the decay on every
parameter, biases and LayerNorm scales included: one parameter group)
and the warm-up + cosine schedule of :func:`warmup_cosine_factor`. Rows of ``S >= flash_min_len`` go through the
flash-attention kernels in both directions (``ops/flash_attention.py``).

Sharding (Megatron-style TP + DP over a ``(data, model)`` mesh,
``parallel/mesh.py::train_mesh``), one process driving every shard:

- the batch splits over ``data``: each DP group encodes its rows, and the
  InfoNCE logits take the passage embeddings of the whole batch, gathered
  from every group, so the loss and every gradient are the single
  device's up to summation order;
- attention q/k/v and the FFN-in kernels split their output dim over
  ``model`` (their biases too: the JAX package replicates them and GSPMD
  slices them implicitly), so each TP shard attends over ``H/tp`` heads
  (through the flash-attention kernels where the row length takes that
  route); attention-out and FFN-out split their input dim, and their
  shards' partial sums meet in one all-reduce a block, summed in f32 in
  shard order, with the bias added once after it;
- embeddings, LayerNorms and the row-parallel biases are replicated.

The f32 master weights live once: each TP shard's slices on the first DP
group's device for that shard, the replicated ones on the mesh's first
device. Every step carries them to each DP group with
:func:`..parallel.collectives.broadcast`, whose backward sums the groups'
gradients in shard order (the DP all-reduce), so repeats are bit-equal.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device
from ..models.encoder import EncoderConfig, EncoderLayer, TextEncoder, l2_normalize, roberta_positions
from ..parallel.collectives import all_gather, broadcast, reduce
from ..parallel.mesh import Mesh, on_device, train_mesh

# optax.adamw's betas and eps, at the JAX trainers' weight_decay=0.01 (optax's own default is 1e-4)
ADAMW = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
ADAM = dict(betas=(0.9, 0.999), eps=1e-8)  # optax.adam's defaults (eps outside the square root, as torch's)


@dataclasses.dataclass
class TrainState:
    """What one training run carries from step to step. The optimizer is
    bound to the model's parameters, so it lives here and not beside the
    step function; ``scheduler`` (optional) moves the learning rate once per
    step."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler | None = None
    step: int = 0


# ---------------- sharding rules ----------------

_COL_PARALLEL = ("query", "key", "value", "intermediate")  # split weight dim 0 (output) and the bias
_ROW_PARALLEL = ("output", "mlp_output")  # split weight dim 1 (input); the bias is replicated


def _spec_for(name: str) -> tuple:
    """The split of one :class:`~..models.encoder.TextEncoder` state-dict
    entry: the axis name at the split dim, None elsewhere (``()`` =
    replicated). The port's weights are ``[out, in]``, so the JAX spec
    ``P(None, "model")`` of a column-parallel ``[in, out]`` kernel is
    ``("model", None)`` here."""
    *_, module, leaf = ("", *name.split("."))
    if module in _COL_PARALLEL:
        return ("model", None) if leaf == "weight" else ("model",)
    if module in _ROW_PARALLEL and leaf == "weight":
        return (None, "model")
    return ()  # embeddings, LayerNorms, row-parallel biases


def _validate(config: EncoderConfig, mesh: Mesh) -> tuple[int, int]:
    """``(dp, tp)`` of a ``(data, model)`` mesh; raises unless tp divides
    the heads and the FFN width."""
    if mesh.axis_names != ("data", "model"):
        raise ValueError(f"a (data, model) mesh is needed, got axes {mesh.axis_names}")
    tp = mesh.shape["model"]
    if config.num_heads % tp or config.intermediate_size % tp:
        raise ValueError(f"tp={tp} must divide num_heads={config.num_heads} and "
                         f"intermediate_size={config.intermediate_size}")
    return mesh.shape["data"], tp


def param_shardings(model: TextEncoder, mesh: Mesh | None = None) -> dict[str, tuple]:
    """Each parameter's split over ``mesh`` (default: :func:`train_mesh`),
    by :class:`~..models.encoder.TextEncoder` state-dict name."""
    _validate(model.config, mesh if mesh is not None else train_mesh())
    return {name: _spec_for(name) for name, _ in model.named_parameters()}


def _key(name: str) -> str:  # a state-dict name as a ParameterDict key
    return name.replace(".", "__")


class _Call(torch.nn.Module):
    """``forward(method, *args)`` is ``module.<method>(*args)``: through
    :func:`torch.func.functional_call`, which calls ``forward`` only, any
    method of ``module`` runs on weights given from outside."""

    def __init__(self, module: torch.nn.Module) -> None:
        super().__init__()
        self.module = module

    def forward(self, method: str, *args):
        return getattr(self.module, method)(*args)


def _run(template: _Call, weights: dict[str, torch.Tensor], method: str, *args):
    """``template.module.<method>(*args)`` on ``weights`` (names relative to
    the module) in place of its own meta parameters."""
    return torch.func.functional_call(template, {f"module.{k}": v for k, v in weights.items()}, (method, *args))


class _Embeddings(TextEncoder):
    """The encoder's embeddings with the type row added by broadcast, not
    looked up: the same sum, but its gradient is a reduction in a fixed
    order, where CUDA's embedding backward adds thousands of equal ids in
    no fixed order, and two runs of the sharded step must be bit-equal."""

    def type_rows(self, input_ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return self.type_emb.weight[0].to(dtype)


class _ShardLayer(EncoderLayer):
    """A TP shard's share of one encoder layer: an
    :class:`~..models.encoder.EncoderLayer` of ``H/tp`` heads and ``I/tp``
    hidden units, whose row-parallel products leave out their bias (the
    shards' partial sums; the bias is added once, after their sum)."""

    def __init__(self, config: EncoderConfig, tp: int) -> None:
        super().__init__(config, config.num_heads // tp, config.intermediate_size // tp)

    def attention_partial(self, hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return self.attention.output.partial(self.attention.context(hidden, mask))

    def mlp_partial(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.mlp_output.partial(self.up(hidden))


@dataclasses.dataclass
class _Placed:
    """One step's parameters on every DP group: ``rep[name][g]`` (replicated,
    on group ``g``'s first device) and ``split[name][t][g]`` (TP shard
    ``t``'s slice, on group ``g``'s device for shard ``t``)."""

    rep: dict
    split: dict


def _place_rows(x, leads: list[torch.device]) -> list[torch.Tensor]:
    """A ``[B, ...]`` tensor's rows split over the DP groups, each part on
    its group's first device (``P("data", None)``); a list passes as placed."""
    if isinstance(x, list):
        return x
    x = torch.as_tensor(x)
    if x.shape[0] % len(leads):
        raise ValueError(f"batch {x.shape[0]} must be a multiple of the data axis size {len(leads)}")
    return [part.to(d, non_blocking=True) for part, d in zip(x.chunk(len(leads)), leads)]


class ShardedEncoder(torch.nn.Module):
    """A :class:`~..models.encoder.TextEncoder` split over a ``(data,
    model)`` mesh with f32 master weights (module docstring). Build it with
    :func:`shard_params`; :meth:`gather_state_dict` gives the single-device
    state dict back. The forward is the encoder's own code: its
    :meth:`~..models.encoder.TextEncoder.embed` (:class:`_Embeddings`) and
    one :class:`_ShardLayer` a shard a layer, run on the placed weights."""

    def __init__(self, config: EncoderConfig, mesh: Mesh, state: dict[str, torch.Tensor]) -> None:
        super().__init__()
        self.config, self.mesh = config, mesh
        self.dp, self.tp = _validate(config, mesh)
        self.grid = [[torch.device(d) for d in row] for row in mesh.devices]
        self.specs = {name: _spec_for(name) for name in state}
        first = self.grid[0]

        def master(x, device) -> torch.nn.Parameter:
            """An f32 copy of its own, contiguous (the fused optimizer wants a
            parameter's strides to be its gradient's)."""
            return torch.nn.Parameter(torch.as_tensor(x).detach().to(device, torch.float32, copy=True).contiguous())

        self.replicated = torch.nn.ParameterDict({
            _key(n): master(state[n], first[0]) for n, spec in self.specs.items() if not spec})
        self.slices = torch.nn.ModuleList(torch.nn.ParameterDict({
            _key(n): master(torch.as_tensor(state[n]).chunk(self.tp, spec.index("model"))[t], first[t])
            for n, spec in self.specs.items() if spec}) for t in range(self.tp))
        # the code the forward runs, on meta weights (a tuple: not submodules, so not parameters)
        self._templates = (_Call(_Embeddings(config, device="meta")), _Call(_ShardLayer(config, self.tp)))
        self._layer_names = [[(n[len(f"layers.{i}."):], n) for n in self.specs if n.startswith(f"layers.{i}.")]
                             for i in range(config.num_layers)]

    @property
    def out_device(self) -> torch.device:
        return self.grid[0][0]

    @torch.no_grad()
    def gather_state_dict(self, device=None, *, grads: bool = False) -> dict[str, torch.Tensor]:
        """The full f32 :class:`~..models.encoder.TextEncoder` state dict (or,
        with ``grads``, the parameters' gradients), the slices concatenated
        in shard order on ``device`` (default: the mesh's first)."""
        device = self.out_device if device is None else device

        def value(p):
            return p.grad if grads else p.detach()

        out = {}
        for name, spec in self.specs.items():
            if spec:
                out[name] = all_gather([value(s[_key(name)]) for s in self.slices], device, dim=spec.index("model"))
            else:
                out[name] = value(self.replicated[_key(name)]).to(device)
        return out

    def place_params(self) -> _Placed:
        """The master weights on every DP group, through :func:`broadcast`:
        call once a step, so each parameter's gradient sums the groups' in
        shard order."""
        leads = [row[0] for row in self.grid]
        rep = {name: broadcast(self.replicated[_key(name)], leads) for name, spec in self.specs.items() if not spec}
        split = {name: [broadcast(s[_key(name)], [row[t] for row in self.grid]) for t, s in enumerate(self.slices)]
                 for name, spec in self.specs.items() if spec}
        return _Placed(rep, split)

    def encode(self, placed: _Placed, input_ids, attention_mask, *, pool: bool = True) -> list[torch.Tensor]:
        """Each DP group's ``[B/dp, H]`` L2-normalized CLS embeddings (or
        last hidden states ``[B/dp, S, H]`` f32 with ``pool=False``), on the
        group's first device."""
        leads = [row[0] for row in self.grid]
        return [self._encode_group(placed, g, ids, mask, pool)
                for g, (ids, mask) in enumerate(zip(_place_rows(input_ids, leads), _place_rows(attention_mask, leads)))]

    def forward(self, input_ids, attention_mask, *, pool: bool = True) -> torch.Tensor:
        """:meth:`encode` over the whole batch, gathered on the mesh's first
        device: what :class:`~..models.encoder.TextEncoder` returns."""
        return all_gather(self.encode(self.place_params(), input_ids, attention_mask, pool=pool),
                          self.out_device, dim=0)

    def _encode_group(self, placed: _Placed, g: int, ids, mask, pool: bool) -> torch.Tensor:
        cfg, devs = self.config, self.grid[g]
        encoder, layer = self._templates
        rep = {name: copies[g] for name, copies in placed.rep.items()}

        def row_parallel(weights, method, x, bias, *per_shard):
            """Every shard's partial of a row-parallel block on its
            ``weights``, then the all-reduce (in f32, in shard order) and the
            bias once."""
            partials = []
            for t, (x_t, d) in enumerate(zip(broadcast(x, devs), devs)):
                with on_device(d):
                    partials.append(_run(layer, weights[t], method, x_t, *(a[t] for a in per_shard)))
            return (reduce([p.float() for p in partials], devs[0]) + bias.to(x.dtype)).to(x.dtype)

        mask = mask.long()
        hidden = _run(encoder, rep, "embed", ids, roberta_positions(mask, cfg.pad_token_id))
        masks = [mask.to(d, non_blocking=True) for d in devs]
        for names in self._layer_names:
            norms = {local: rep[name] for local, name in names if not self.specs[name]}
            split = [{local: placed.split[name][t][g] for local, name in names if self.specs[name]}
                     for t in range(self.tp)]
            attn = row_parallel(split, "attention_partial", hidden, norms["attention.output.bias"], masks)
            hidden = _run(layer, norms, "attention_ln", hidden + attn)
            mlp = row_parallel(split, "mlp_partial", hidden, norms["mlp_output.bias"])
            hidden = _run(layer, norms, "output_ln", hidden + mlp)
        if not pool:
            return hidden.float()
        return l2_normalize(hidden[:, 0, :].float())


def shard_params(model: TextEncoder, mesh: Mesh | None = None) -> ShardedEncoder:
    """``model`` split Megatron-style over ``mesh`` (default:
    :func:`train_mesh` over every local CUDA device), with f32 master
    weights (:class:`ShardedEncoder`)."""
    return ShardedEncoder(model.config, mesh if mesh is not None else train_mesh(), model.state_dict())


# ---------------- optimizer / schedule ----------------


def warmup_cosine_factor(steps: int, warmup: int | None = None, alpha: float = 0.05) -> Callable[[int], float]:
    """``count -> lr(count) / lr`` of
    ``optax.warmup_cosine_decay_schedule(0, lr, warmup_steps=warmup,
    decay_steps=steps, end_value=alpha * lr)``: linear from 0 over the
    warm-up (default ``max(20, steps // 20)``), then a cosine down to
    ``alpha`` at ``steps`` and flat after. The first update (count 0) has
    rate 0, as in optax."""
    warmup = max(20, steps // 20) if warmup is None else warmup
    decay = steps - warmup
    if decay <= 0:
        raise ValueError(f"the schedule needs more than {warmup} steps (its warm-up), got {steps}")

    def factor(count: int) -> float:
        if count < warmup:
            return count / warmup
        cosine = 0.5 * (1.0 + math.cos(math.pi * min(count - warmup, decay) / decay))
        return (1.0 - alpha) * cosine + alpha

    return factor


def make_optimizer(model: torch.nn.Module, lr: float, steps: int | None = None):
    """``(optimizer, scheduler)``: AdamW over every parameter in one group;
    with ``steps`` the warm-up + cosine schedule, else a constant rate and
    no scheduler."""
    params = list(model.parameters())
    fused = all(p.is_cuda for p in params)  # one launch per step on the card
    optimizer = torch.optim.AdamW(params, lr=lr, fused=fused, **ADAMW)
    if steps is None:
        return optimizer, None
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, warmup_cosine_factor(steps))


def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm(max_norm)`` on the gradients, in place:
    ``g / ‖g‖ · max_norm`` when the global norm ``‖g‖`` reaches
    ``max_norm``, else ``g`` unchanged (``clip_grad_norm_`` scales by
    ``max_norm / (‖g‖ + 1e-6)`` instead). Decided on the device, no host
    synchronisation. Returns the global norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def apply_update(state: TrainState, loss: torch.Tensor, clip: float | None = None) -> None:
    """Backward, the optional global-norm clip, one optimizer step, one
    scheduler step; gradients freed."""
    loss.backward()
    if clip:
        clip_by_global_norm_(state.model.parameters(), clip)
    state.optimizer.step()
    if state.scheduler is not None:
        state.scheduler.step()
    state.optimizer.zero_grad(set_to_none=True)
    state.step += 1


# ---------------- loss / step ----------------


def info_nce_loss(q_emb: torch.Tensor, p_emb: torch.Tensor, temperature: float) -> torch.Tensor:
    """In-batch-negative InfoNCE; both inputs [B, H] unit-norm."""
    logits = q_emb @ p_emb.T / temperature  # [B, B]
    labels = torch.arange(q_emb.shape[0], device=q_emb.device)
    return torch.nn.functional.cross_entropy(logits, labels)


def make_train_step(config: EncoderConfig, temperature: float = 0.05) -> Callable:
    """Returns ``train_step(state, batch) -> (state, loss)`` where batch =
    dict(q_ids, q_mask, p_ids, p_mask) of integer tensors on the model's
    device. ``state`` is updated in place and returned; ``loss`` stays on
    the device (no host synchronisation inside a step)."""

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, torch.Tensor]:
        model = state.model
        if model.config != config:
            raise ValueError("the state's model was built from another config than this step")
        q = model(batch["q_ids"], batch["q_mask"])
        p = model(batch["p_ids"], batch["p_mask"])
        loss = info_nce_loss(q, p, temperature)
        apply_update(state, loss)
        return state, loss.detach()

    return train_step


def make_sharded_train_step(config: EncoderConfig, mesh: Mesh | None = None, temperature: float = 0.05):
    """``(train_step, place_batch)`` for a :class:`ShardedEncoder` over
    ``mesh`` (default: :func:`train_mesh`): ``train_step(state, batch) ->
    (state, loss)`` as :func:`make_train_step`'s, with ``state.model`` a
    :class:`ShardedEncoder`; ``place_batch(batch)`` splits each entry's rows
    over the DP groups (the step places a whole batch itself)."""
    mesh = mesh if mesh is not None else train_mesh()
    _validate(config, mesh)
    grid = [[torch.device(d) for d in row] for row in mesh.devices]

    def place_batch(batch: dict) -> dict:
        return {name: _place_rows(x, [row[0] for row in grid]) for name, x in batch.items()}

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, torch.Tensor]:
        model = state.model
        if model.config != config or model.grid != grid:
            raise ValueError("the state's model was built for another config or mesh than this step")
        placed = model.place_params()  # once a step: both encodes share the copies
        q = model.encode(placed, batch["q_ids"], batch["q_mask"])
        p = model.encode(placed, batch["p_ids"], batch["p_mask"])
        loss = info_nce_loss(all_gather(q, model.out_device, dim=0), all_gather(p, model.out_device, dim=0),
                             temperature)
        apply_update(state, loss)
        return state, loss.detach()

    return train_step, place_batch


# ---------------- cached-pool trainer (single device) ----------------


def tokenize_pairs(tokenizer, queries, passages, *, max_len: int = 32):
    """Tokenize aligned (query, positive-passage) pairs to fixed width."""

    def enc(texts):
        ids, mask = tokenizer.encode_batch(texts)
        n, s = ids.shape
        if s >= max_len:
            return ids[:, :max_len], mask[:, :max_len]
        pid = tokenizer.pad_id
        out_i = np.full((n, max_len), pid, np.int32)
        out_m = np.zeros((n, max_len), np.int32)
        out_i[:, :s] = ids
        out_m[:, :s] = mask
        return out_i, out_m

    q_ids, q_mask = enc(queries)
    p_ids, p_mask = enc(passages)
    return {"q_ids": q_ids, "q_mask": q_mask, "p_ids": p_ids, "p_mask": p_mask}


def seeded_generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def run_launches(state: TrainState, one_step: Callable[[], torch.Tensor], steps: int,
                 steps_per_launch: int) -> np.ndarray:
    """``ceil(steps / steps_per_launch)`` groups of ``steps_per_launch``
    steps of ``one_step() -> loss``; returns each group's mean loss. The
    losses are stacked on the device and read once, after the last step."""
    means = []
    for _ in range(-(-steps // steps_per_launch)):
        means.append(torch.stack([one_step() for _ in range(steps_per_launch)]).mean())
    return torch.stack(means).float().cpu().numpy()


def train_encoder_cached(
    config: EncoderConfig,
    pool: dict,
    *,
    steps: int = 800,
    batch: int = 64,
    lr: float = 1e-3,
    temperature: float = 0.05,
    seed: int = 0,
    steps_per_launch: int = 50,
    init: dict | None = None,
    device: str | torch.device | None = None,
    generator: torch.Generator | None = None,
):
    """InfoNCE fine-tune over a device-resident (query, positive) pool.
    In-batch negatives come from the sampled batch; batch indices come from
    ``generator`` (default: one seeded with ``seed + 1`` on the device).
    ``init`` is a :class:`TextEncoder` state dict to start from (default:
    :meth:`TextEncoder.init_flax` seeded with ``seed``). Returns ``(model,
    mean_losses)``: the trained encoder with f32 master weights and one mean
    loss per ``steps_per_launch`` steps."""
    dev = resolve_device(device)
    model = TextEncoder(config, device=dev, param_dtype=torch.float32)
    if init is not None:
        model.load_state_dict(init)
    else:
        model.init_flax(seeded_generator(seed, dev))
    model.train()
    gen = generator if generator is not None else seeded_generator(seed + 1, dev)
    state = TrainState(model, *make_optimizer(model, lr, steps))
    step_fn = make_train_step(config, temperature)
    on_dev = {k: torch.as_tensor(v, device=dev) for k, v in pool.items()}
    n = on_dev["q_ids"].shape[0]

    def one_step() -> torch.Tensor:
        idx = torch.randint(0, n, (batch,), generator=gen, device=dev)
        return step_fn(state, {k: v[idx] for k, v in on_dev.items()})[1]

    means = run_launches(state, one_step, steps, steps_per_launch)
    return model.eval(), means

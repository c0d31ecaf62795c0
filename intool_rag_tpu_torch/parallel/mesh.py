"""Device meshes and row-sharded tensors (port of
``intool_rag_tpu/parallel/mesh.py``).

One process drives every shard: a :class:`Mesh` is a grid of
``torch.device`` entries with named axes, and a :class:`ShardedTensor`
holds one row block per mesh entry, the counterpart of a ``jax.Array``
placed with ``NamedSharding(mesh, P("data", ...))``. A device may appear
more than once, so several shards can share one card (or the CPU): the
results are the same as on as many cards, only the shards run one after
another.

Axes:
- ``data``  — corpus rows (and the batch, for training).
- ``model`` — tensor parallelism (``tp_decoder``, the sharded train step);
  :func:`train_mesh` builds the (data, model) grid.
- ``seq`` — the sequence of a long input (:mod:`.sequence`).
- ``dcn`` × ``ici`` — the two-level mesh of :mod:`.dcn`.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch


def local_devices(device_type: str = "cuda") -> list[torch.device]:
    """Every visible device of ``device_type``: the CUDA devices, or the one
    CPU. Raises when no CUDA device is visible."""
    if device_type != "cuda":
        return [torch.device(device_type)]
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device is visible; pass the mesh's devices explicitly")
    return [torch.device("cuda", i) for i in range(n)]


def on_device(device: torch.device):
    """The context of a shard's work: its card as the current CUDA device (the
    kernels launch on the current device's streams), nothing for the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class Mesh:
    """A grid of devices with one name per axis, in row-major shard order."""

    def __init__(self, devices, axis_names: tuple[str, ...]) -> None:
        flat = [torch.device(d) for d in np.asarray(devices, dtype=object).reshape(-1)]
        grid = np.empty(len(flat), dtype=object)
        grid[:] = flat
        shape = np.shape(np.asarray(devices, dtype=object))
        if len(shape) != len(axis_names):
            raise ValueError(f"device grid of shape {shape} for axes {axis_names}")
        self.devices = grid.reshape(shape)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def flat_devices(self) -> list[torch.device]:
        """The devices in shard order (row-major over the axes)."""
        return list(self.devices.reshape(-1))

    @property
    def out_device(self) -> torch.device:
        """Where merged (replicated) results land: the first shard's device."""
        return self.devices.reshape(-1)[0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.flat_devices]})"


def corpus_mesh(devices=None) -> Mesh:
    """1-D mesh over ``devices`` (default: every local CUDA device): corpus
    rows sharded on ``data``."""
    devices = list(devices) if devices is not None else local_devices()
    return Mesh(_as_grid(devices, (len(devices),)), ("data",))


def train_mesh(devices=None, model_parallel: int | None = None) -> Mesh:
    """2-D (data, model) mesh. ``model_parallel`` defaults to 2 when the
    device count allows, else 1."""
    devices = list(devices) if devices is not None else local_devices()
    n = len(devices)
    if model_parallel is None:
        model_parallel = 2 if n % 2 == 0 and n > 1 else 1
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    return Mesh(_as_grid(devices, (n // model_parallel, model_parallel)), ("data", "model"))


def axis_devices(mesh: Mesh, axis: str) -> list[torch.device]:
    """The devices along ``axis``, at index 0 of every other axis."""
    grid = np.moveaxis(mesh.devices, mesh.axis_names.index(axis), 0)
    return list(grid.reshape(mesh.shape[axis], -1)[:, 0])


def _as_grid(devices: list, shape: tuple[int, ...]) -> np.ndarray:
    grid = np.empty(len(devices), dtype=object)
    grid[:] = [torch.device(d) for d in devices]
    return grid.reshape(shape)


@dataclasses.dataclass
class ShardedTensor:
    """A ``[N, ...]`` tensor split into equal row blocks, block ``s`` on the
    mesh's ``s``-th device (shard order)."""

    shards: list[torch.Tensor]
    mesh: Mesh

    @property
    def shard_rows(self) -> int:
        return self.shards[0].shape[0]

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.shard_rows * len(self.shards), *self.shards[0].shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on one device (the mesh's first by default)."""
        from .collectives import all_gather

        return all_gather(self.shards, self.mesh.out_device if device is None else device, dim=0)

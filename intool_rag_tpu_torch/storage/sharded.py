"""Sharded array checkpoint / restore (port of
``intool_rag_tpu/storage/sharded.py``), in the JAX package's files.

A row-sharded tensor saves as one ``<path>.shard{i}.npz`` (key ``data``)
per shard plus ``<path>.manifest.json`` (shape, dtype, shard count, the
caller's ``meta``, each shard's row range). Floats go through f32 (npz
holds no bf16). A restore may use a mesh of another size: the rows are
re-partitioned evenly, streamed shard file by shard file, so no host
buffer is larger than a shard.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..parallel.mesh import Mesh, ShardedTensor

_DTYPES = {
    "float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16,
    "float64": torch.float64, "int8": torch.int8, "uint8": torch.uint8, "int32": torch.int32,
    "int64": torch.int64, "bool": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def save_sharded(array: ShardedTensor, path: Path | str, *, meta: dict | None = None) -> None:
    """One npz per shard + the manifest."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    manifest = {
        "shape": list(array.shape),
        "dtype": _NAMES[array.dtype],
        "num_shards": len(array.shards),
        "meta": meta or {},
        "shard_rows": [],
    }
    start = 0
    for i, shard in enumerate(array.shards):
        data = shard.cpu()
        if data.is_floating_point():
            data = data.float()
        data = data.numpy()
        np.savez_compressed(path.with_suffix(f".shard{i}"), data=data)
        manifest["shard_rows"].append([start, start + data.shape[0]])
        start += data.shape[0]
    Path(str(path) + ".manifest.json").write_text(json.dumps(manifest))


def load_sharded(path: Path | str, mesh: Mesh, *, dtype=None) -> tuple[ShardedTensor, dict]:
    """Restore onto ``mesh`` (one shard a mesh entry). Returns
    ``(array, meta)``; ``dtype`` (a torch dtype) overrides the saved one."""
    path = Path(path)
    manifest = json.loads(Path(str(path) + ".manifest.json").read_text())
    n = manifest["shape"][0]
    n_dev = mesh.size
    if n % n_dev != 0:
        raise ValueError(f"rows {n} not divisible by mesh size {n_dev}")
    per_dev = n // n_dev
    out_dtype = dtype or _DTYPES[manifest["dtype"]]
    files = iter(range(manifest["num_shards"]))
    current, offset = None, 0
    shards = []
    for dev in mesh.flat_devices:
        need, parts = per_dev, []
        while need > 0:
            if current is None or offset >= current.shape[0]:
                with np.load(f"{path}.shard{next(files)}.npz") as f:
                    current = f["data"]
                offset = 0
            take = min(need, current.shape[0] - offset)
            parts.append(current[offset : offset + take])
            offset += take
            need -= take
        block = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
        shards.append(torch.from_numpy(np.ascontiguousarray(block)).to(dev).to(out_dtype))
    return ShardedTensor(shards, mesh), manifest["meta"]

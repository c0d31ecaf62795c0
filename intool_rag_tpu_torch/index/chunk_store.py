"""Device-resident chunk corpus: embedding matrix + id tables (port of
``intool_rag_tpu/index/chunk_store.py``).

Embeddings are one padded ``[N_pad, D_pad]`` tensor on the store's device
(bf16 by default); row identity (doc, chunk, page) is positional. Rows pad
to a multiple of ``_ROW_BLOCK`` so the fused kernel's ``128·group_l``
blocks divide N; ``valid_n`` masks the tail. D pads to 128.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from ..logging import get_logger
from ..device import resolve_device

_ROW_BLOCK = 4096
_DIM_BLOCK = 128

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}

logger = get_logger(__name__)


def _round_up(x: int, m: int) -> int:
    return max(m, -(-x // m) * m)


@dataclasses.dataclass
class ChunkRef:
    """Identity of one corpus row."""

    doc_id: str
    chunk_id: str
    page: int


class ChunkStore:
    """Append-able embedding corpus with positional identity tables."""

    def __init__(self, dim: int, dtype: str = "bfloat16", device: str | torch.device | None = None) -> None:
        if dtype not in _DTYPES:
            raise ValueError(
                f"ChunkStore dtype must be one of {sorted(_DTYPES)}, got {dtype}; "
                "for int8 scoring set DENSE_INT8=1"
            )
        self.dim = dim
        self.dim_pad = _round_up(dim, _DIM_BLOCK)
        self._dtype_name = dtype
        self.dtype = _DTYPES[dtype]
        self.device = resolve_device(device)
        self.valid_n = 0
        self.mutation_count = 0
        self._embeddings = torch.zeros((_ROW_BLOCK, self.dim_pad), dtype=self.dtype, device=self.device)
        self.doc_ids: list[str] = []
        self.chunk_ids: list[str] = []
        self.pages: np.ndarray = np.zeros(0, np.int32)
        self.texts: list[str] = []

    @property
    def embeddings(self) -> torch.Tensor:
        """Padded [N_pad, D_pad] device tensor."""
        return self._embeddings

    @property
    def n_pad(self) -> int:
        return self._embeddings.shape[0]

    def __len__(self) -> int:
        return self.valid_n

    def ref(self, row: int) -> ChunkRef:
        return ChunkRef(self.doc_ids[row], self.chunk_ids[row], int(self.pages[row]))

    def rows_for_doc(self, doc_id: str) -> list[int]:
        return [i for i, d in enumerate(self.doc_ids) if d == doc_id]

    def append(
        self,
        embeddings: np.ndarray,
        doc_id: str,
        chunk_ids: list[str],
        pages: list[int],
        texts: list[str],
    ) -> None:
        m, d = embeddings.shape
        if d != self.dim:
            raise ValueError(f"embedding dim {d} != store dim {self.dim}")
        if not (m == len(chunk_ids) == len(pages) == len(texts)):
            raise ValueError("length mismatch between embeddings and identities")
        norms = np.linalg.norm(np.asarray(embeddings, np.float32), axis=1)
        if norms.size and (norms.max() > 1.25 or norms.min() < 0.8):
            logger.warning(
                "appending non-normalized embeddings (|e| in [%.2f, %.2f]); cosine "
                "score clamping assumes unit norms",
                float(norms.min()), float(norms.max()),
            )
        new_n = self.valid_n + m
        if new_n > self.n_pad:
            grown = torch.zeros(
                (_round_up(new_n, _ROW_BLOCK), self.dim_pad), dtype=self.dtype, device=self.device
            )
            grown[: self.valid_n] = self._embeddings[: self.valid_n]
            self._embeddings = grown
        add = torch.as_tensor(np.asarray(embeddings, np.float32)).to(self.device, self.dtype)
        self._embeddings[self.valid_n : new_n, : self.dim] = add
        self.valid_n = new_n
        self.doc_ids.extend([doc_id] * m)
        self.chunk_ids.extend(chunk_ids)
        self.pages = np.concatenate([self.pages, np.asarray(pages, np.int32)])
        self.texts.extend(texts)
        self.mutation_count += 1

    def without_doc(self, doc_id: str) -> tuple["ChunkStore", int]:
        """Copy-on-write removal: ``(new store without the doc's rows, rows
        removed)``. This store is untouched, so a search that holds it keeps
        a consistent row ↔ identity mapping. The kept rows are gathered on
        the device."""
        keep = [i for i, d in enumerate(self.doc_ids) if d != doc_id]
        removed = self.valid_n - len(keep)
        if removed == 0:
            return self, 0
        new = ChunkStore(self.dim, self._dtype_name, device=self.device)
        new._embeddings = torch.zeros(
            (_round_up(max(len(keep), 1), _ROW_BLOCK), self.dim_pad), dtype=self.dtype, device=self.device
        )
        new._embeddings[: len(keep)] = self._embeddings[torch.as_tensor(keep, dtype=torch.long, device=self.device)]
        new.doc_ids = [self.doc_ids[i] for i in keep]
        new.chunk_ids = [self.chunk_ids[i] for i in keep]
        new.pages = self.pages[keep]
        new.texts = [self.texts[i] for i in keep]
        new.valid_n = len(keep)
        new.mutation_count = self.mutation_count + 1
        return new, removed

    # ---------------- persistence (the JAX package's files) ----------------

    def save(self, path: Path | str) -> None:
        """``<path>.npz`` (f32 embeddings, pages) + ``<path>.meta.json``, as
        the JAX package's ``ChunkStore.save`` writes them."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            path,
            embeddings=self._embeddings[: self.valid_n, : self.dim].float().cpu().numpy(),
            pages=self.pages,
        )
        meta = {
            "dim": self.dim, "dtype": self._dtype_name, "valid_n": self.valid_n,
            "doc_ids": self.doc_ids, "chunk_ids": self.chunk_ids, "texts": self.texts,
        }
        Path(str(path) + ".meta.json").write_text(json.dumps(meta, ensure_ascii=False), encoding="utf-8")

    @classmethod
    def load(cls, path: Path | str, device: str | torch.device | None = None) -> "ChunkStore":
        """A store either package saved, on ``device``."""
        path = Path(path)
        meta = json.loads(Path(str(path) + ".meta.json").read_text(encoding="utf-8"))
        store = cls(dim=meta["dim"], dtype=meta["dtype"], device=device)
        with np.load(f"{path}.npz") as arrays:
            emb, pages = arrays["embeddings"], arrays["pages"]
        n = emb.shape[0]
        if n:
            store._embeddings = torch.zeros(
                (_round_up(n, _ROW_BLOCK), store.dim_pad), dtype=store.dtype, device=store.device
            )
            store._embeddings[:n, : store.dim] = torch.as_tensor(emb).to(store.device, store.dtype)
            store.valid_n = n
            store.doc_ids = list(meta["doc_ids"])
            store.chunk_ids = list(meta["chunk_ids"])
            store.texts = list(meta["texts"])
            store.pages = np.asarray(pages, np.int32)
        return store
